"""Evaluation wall-clock rehearsal (port of scripts/eval_rehearsal.py): a
synthetic split of production-size meshes (image_to_mesh at 257^3 bf16 on
the analytic octahedron head, r from 0.45 to 0.95, two categories; each
object's views are copies of its view 00, since the metrics' cost depends
on a mesh's size, not its content), then evaluate_tree per metric (CD +
EMD, F-score, host IoU) and with the whole protocol, reported as
objects/min and extrapolated to the 1,311 objects of the chair test
split; then the cached re-run, and the host half of one object (parse,
sample, voxelize) timed part by part on one thread.

    python -m disn_tpu_torch.tools.eval_rehearsal [n_objs] [view_num]
        [--root DIR] [--device cpu] [--device-iou] [--json OUT]

The tree goes under build/eval_rehearsal/ unless --root is given.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Callable

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "eval_rehearsal")
CATS = ("03001627", "04379243")
SPLIT_OBJS = 1311  # the chair test split
PROTOCOL = ("cd", "emd", "fscore", "iou")


def build_tree(root: str, n_objs: int = 8, view_num: int = 24,
               cfg: Config | None = None,
               device: str | torch.device | None = None,
               log: Callable = print) -> dict:
    """Write {root}/pred/{cat}/{cat}_{obj}_{view:02d}.obj, {root}/gt/{cat}/
    {obj}/isosurf.obj and {root}/lists/{cat}_test.lst for n_objs objects
    over CATS (the script's radii and RandomState(0) images, the demo
    camera; cfg defaults to Config(sdf_res=256, compute_dtype="bfloat16"),
    full width). Returns the three directories, the seconds and each
    object's face count."""
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    dev = device_mod.resolve(device)
    cfg = cfg or Config(sdf_res=256, compute_dtype="bfloat16")
    trans = synthetic.demo_trans_mat()
    rng = np.random.RandomState(0)
    pred_dir, gt_dir, lst_dir = (os.path.join(root, d)
                                 for d in ("pred", "gt", "lists"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(lst_dir)
    nets: dict = {}
    per_cat = -(-n_objs // len(CATS))
    faces, done = [], 0
    t0 = time.perf_counter()
    for ci, cat in enumerate(CATS):
        objs = []
        for oi in range(per_cat):
            if done >= n_objs:
                break
            obj = f"obj{oi:03d}"
            objs.append(obj)
            r = 0.45 + 0.5 * ((ci * per_cat + oi) % 5) / 4.0
            if r not in nets:
                nets[r] = synthetic.analytic_octahedron_params(cfg, r=r,
                                                               device=dev)
            img = rng.rand(1, cfg.img_h, cfg.img_w, 3).astype(np.float32)
            verts, f = pipeline.image_to_mesh(nets[r], img, trans, cfg,
                                              device=dev)
            codecs.write_obj(os.path.join(gt_dir, cat, obj, "isosurf.obj"),
                             verts, f)
            v0 = os.path.join(pred_dir, cat, f"{cat}_{obj}_00.obj")
            codecs.write_obj(v0, verts, f)
            for v in range(1, view_num):
                shutil.copyfile(v0, os.path.join(
                    pred_dir, cat, f"{cat}_{obj}_{v:02d}.obj"))
            faces.append(len(f))
            done += 1
            log(f"built {cat}/{obj} r={r:.2f} ({len(f)} tris)")
        with open(os.path.join(lst_dir, f"{cat}_test.lst"), "w") as fh:
            fh.write("\n".join(objs) + "\n")
    return {"pred_dir": pred_dir, "gt_dir": gt_dir, "lst_dir": lst_dir,
            "seconds": time.perf_counter() - t0, "faces": faces}


def host_split(tree: dict, view_num: int, num_points: int = 2048,
               dim: int = 110) -> dict:
    """The host half of each object (what runner._object_host does on a
    pool thread), one part at a time on this thread: parse its GT and
    view meshes (codecs.read_obj), sample them (the protocol's vertex
    sampling, RandomState(0)) and voxelize them at dim (the C++ SAT).
    Returns each part's seconds summed over the objects, and the count."""
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import listing
    from disn_tpu_torch.eval import runner
    from disn_tpu_torch.ops import voxelize

    out = {"parse_s": 0.0, "sample_s": 0.0, "voxelize_s": 0.0, "objects": 0}
    for cat in CATS:
        lst = os.path.join(tree["lst_dir"], f"{cat}_test.lst")
        if not os.path.exists(lst):
            continue
        for obj in listing.read_lst(lst):
            paths = [os.path.join(tree["gt_dir"], cat, obj, "isosurf.obj")]
            paths += [os.path.join(tree["pred_dir"], cat,
                                   f"{cat}_{obj}_{v:02d}.obj")
                      for v in range(view_num)]
            t0 = time.perf_counter()
            meshes = [codecs.read_obj(p) for p in paths]
            t1 = time.perf_counter()
            rng = np.random.RandomState(0)
            for m in meshes:
                runner._mesh_points(m, num_points, rng)
            t2 = time.perf_counter()
            for m in meshes:
                voxelize.voxelize_surface(*m, dim=dim)
            t3 = time.perf_counter()
            out["parse_s"] += t1 - t0
            out["sample_s"] += t2 - t1
            out["voxelize_s"] += t3 - t2
            out["objects"] += 1
    return out


def run(n_objs: int = 8, view_num: int = 24, root: str | None = None,
        device: str | torch.device | None = None, cfg: Config | None = None,
        num_points: int = 2048, dim: int = 110, device_iou: bool = False,
        log: Callable = print) -> dict:
    """build_tree, then evaluate_tree timed per metric and with the whole
    protocol (on `device`), the cached re-run (a cache filled by one run,
    then read by a second), and host_split."""
    from disn_tpu_torch.eval import runner

    dev = device_mod.resolve(device)
    root = root or ROOT
    tree = build_tree(root, n_objs, view_num, cfg=cfg, device=dev, log=log)
    log(f"tree build: {tree['seconds']:.1f} s ({n_objs} objs x {view_num} "
        f"views)")
    kw = dict(view_num=view_num, num_points=num_points, dim=dim, device=dev)

    def evaluate(which, **more):
        t0 = time.perf_counter()
        res = runner.evaluate_tree(tree["pred_dir"], tree["gt_dir"],
                                   tree["lst_dir"], metrics=list(which),
                                   **kw, **more)
        return res, time.perf_counter() - t0

    out: dict = {"objects": n_objs, "views": view_num,
                 "build_s": tree["seconds"], "faces": tree["faces"],
                 "timed": {}}
    arms = [("cd+emd", ("cd", "emd"), {}), ("fscore", ("fscore",), {}),
            ("iou (host voxel)", ("iou",), {})]
    if device_iou:
        arms.append(("iou (device voxel)", ("iou",), {"device_iou": True}))
    arms.append(("full protocol", PROTOCOL, {}))
    for name, which, more in arms:
        res, dt = evaluate(which, **more)
        n = res["total_objects"]
        rate = n / dt * 60
        out["timed"][name] = {"seconds": dt, "objects": n,
                              "objs_per_min": rate,
                              "split_minutes": SPLIT_OBJS / rate}
        log(f"{name}: {dt:.2f} s for {n} objs = {rate:.1f} objs/min "
            f"({SPLIT_OBJS}-obj split ~ {SPLIT_OBJS / rate:.1f} min)")
    out["overall"] = res["overall"]
    out["total_objects"] = res["total_objects"]
    cache = os.path.join(root, "cache")
    shutil.rmtree(cache, ignore_errors=True)
    fill, fill_s = evaluate(PROTOCOL, cache_dir=cache)
    warm, warm_s = evaluate(PROTOCOL, cache_dir=cache)
    out.update(cache_fill_s=fill_s, cached_s=warm_s,
               cache_fill_overall=fill["overall"],
               cached_overall=warm["overall"],
               cached_objects=warm["total_objects"])
    log(f"cached re-run of the full protocol: {warm_s:.3f} s (filling the "
        f"cache {fill_s:.2f} s; {warm['total_objects']} objs)")
    split = host_split(tree, view_num, num_points, dim)
    out["host_split"] = split
    per = max(split["objects"], 1)
    log(f"host half, one thread, per object ({view_num + 1} meshes): parse "
        f"{split['parse_s'] / per * 1e3:.1f} ms, sample "
        f"{split['sample_s'] / per * 1e3:.1f} ms, voxelize at {dim}^3 "
        f"{split['voxelize_s'] / per * 1e3:.1f} ms")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_objs", nargs="?", type=int, default=8)
    ap.add_argument("view_num", nargs="?", type=int, default=24)
    ap.add_argument("--root", default=None,
                    help=f"where the tree goes (default {ROOT})")
    ap.add_argument("--device", default=None,
                    help="torch device (the GPU by default)")
    ap.add_argument("--device-iou", action="store_true",
                    help="also time the IoU voxelized on the device")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(args.n_objs, args.view_num, root=args.root, device=args.device,
              device_iou=args.device_iou, log=lambda m: print(m, flush=True))
    print(f"overall: {json.dumps(out['overall'])}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
