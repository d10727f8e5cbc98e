"""Evaluation harness: walk a prediction tree against ground-truth meshes and
aggregate per-category metrics (port of disn_tpu/eval/runner.py).

The reference protocol (test/test_cd_emd.py:220-347, test_f_score.py:159-243,
test_iou.py:165-233): per object, sample `num_points` points from the GT
``isosurf.obj`` and from each of up to `view_num` predicted view meshes;
Chamfer distance and EMD (mean and best view), F-score at
{0.5, 1, 2, 5, 10, 20}% x 2.5 and voxel IoU at dim 110; per-category means
and the category-weighted overall means, with the overall F-score the
harmonic mean of the weighted precision and recall.

Host work (parse, sample, voxelize) runs on pool threads; the metrics run
on the device from the caller's thread only (``_object_device``), so one
thread owns the card. Random draws come from ``RandomState(0)`` per
object, as in the JAX package, so both sample the same points.
"""
from __future__ import annotations

import functools
import glob
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import listing
from disn_tpu_torch.eval import metrics
from disn_tpu_torch.ops import voxelize

F_THRESHOLDS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0)  # percent (test_f_score:291)
SIDE_LEN = 2.5                                    # truethreshold (:41)


def _load_mesh(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    if not os.path.exists(path):
        return None
    verts, faces = codecs.read_obj(path)
    if len(verts) == 0:
        return None
    return verts, faces


def _mesh_points(mesh: tuple[np.ndarray, np.ndarray], n: int,
                 rng: np.random.RandomState,
                 protocol: str = "vertices") -> np.ndarray:
    verts, faces = mesh
    if protocol == "surface" and len(faces):
        return metrics.sample_mesh_surface(verts, faces, n, rng)
    return metrics.sample_mesh_vertices(verts, n, rng)


def _object_host(gt_mesh: str, pred_meshes: list[str], num_points: int,
                 which: set[str], dim: int, protocol: str = "vertices",
                 device_iou: bool = False) -> tuple | None:
    """The host half of one object (pool threads): parse each mesh once,
    sample the clouds, and, unless the IoU is voxelized on the device,
    voxelize the GT once and each view against it. Returns (pred points
    [V,n,3], GT points [n,3], the views' paths, the partial result) or
    None when the GT or every view is missing or empty."""
    rng = np.random.RandomState(0)
    gt = _load_mesh(gt_mesh)
    if gt is None:
        return None
    gt_pts = _mesh_points(gt, num_points, rng, protocol)
    preds, pred_paths, pred_meshes_np = [], [], []
    for p in pred_meshes:
        mesh = _load_mesh(p)
        if mesh is not None:
            preds.append(_mesh_points(mesh, num_points, rng, protocol))
            pred_paths.append(p)
            pred_meshes_np.append(mesh if "iou" in which else None)
    if not preds:
        return None
    out: dict = {"views": len(preds)}
    if "iou" in which:
        if device_iou:  # voxelized by _object_device, on the caller's thread
            out["_iou_meshes"] = (gt, pred_meshes_np)
        else:
            _host_iou(gt, pred_meshes_np, dim, voxelize.voxelize_surface,
                      out)
    return np.stack(preds), gt_pts, pred_paths, out


def _host_iou(gt, pred_meshes_np, dim: int, occ_fn, out: dict) -> None:
    o_gt = occ_fn(*gt, dim=dim)
    ious = [voxelize.occupancy_iou(o_gt, occ_fn(*mesh, dim=dim))
            for mesh in pred_meshes_np]
    out["iou_avg"] = float(np.mean(ious))
    out["iou_best"] = float(np.max(ious))


def _object_device(host: tuple, which: set[str], dim: int = 110,
                   device: str | torch.device | None = None) -> dict:
    """The device half: Chamfer, EMD and F-score on the stacked views, and
    the device voxelization when _object_host deferred it here."""
    dev = device_mod.resolve(device)
    preds_np, gt_pts, pred_paths, out = host
    iou_meshes = out.pop("_iou_meshes", None)
    if iou_meshes is not None:
        _host_iou(iou_meshes[0], iou_meshes[1], dim,
                  functools.partial(voxelize.occupancy_device, device=dev),
                  out)
    pred = torch.from_numpy(np.ascontiguousarray(preds_np, np.float32)
                            ).to(dev)
    gt = torch.from_numpy(np.ascontiguousarray(gt_pts, np.float32)).to(dev)
    gt = gt.expand(pred.shape[0], -1, -1).contiguous()
    with torch.no_grad():
        if "cd" in which or "emd" in which:
            ce = metrics.chamfer_emd(pred, gt)
            cd, emd = ce["cd"].cpu().numpy(), ce["emd"].cpu().numpy()
            out.update(cd_avg=float(cd.mean()), cd_min=float(cd.min()),
                       cd_best_view=pred_paths[int(cd.argmin())],
                       emd_avg=float(emd.mean()), emd_min=float(emd.min()))
        if "fscore" in which:
            th = np.asarray(F_THRESHOLDS, np.float32) * 0.01 * SIDE_LEN
            fs = {k: v.cpu().numpy()
                  for k, v in metrics.f_score(pred, gt, th).items()}
            out["f1"] = fs["f1"].mean(axis=1).tolist()   # per threshold
            # per-object mean precision and recall feed the overall
            # aggregate (weighted means first, the harmonic mean last)
            out["f_precision"] = fs["precision"].mean(axis=1).tolist()
            out["f_recall"] = fs["recall"].mean(axis=1).tolist()
    return out


def evaluate_object(gt_mesh: str, pred_meshes: list[str], num_points: int,
                    which: set[str], dim: int, protocol: str = "vertices",
                    device_iou: bool = False,
                    device: str | torch.device | None = None) -> dict | None:
    """One object's metric dict (host half, then device half)."""
    host = _object_host(gt_mesh, pred_meshes, num_points, which, dim,
                        protocol=protocol, device_iou=device_iou)
    if host is None:
        return None
    return _object_device(host, which, dim=dim, device=device)


def _cache_key(num_points: int, which: set[str], dim: int, protocol: str,
               n_preds: int) -> dict:
    return {"num_points": num_points, "which": sorted(which), "dim": dim,
            "protocol": protocol, "n_preds": n_preds}


def _cache_load(path: str, key: dict) -> dict | None:
    """The per-object result cache (the reference's resume mechanism,
    test_f_score.py:203-231): a hit needs the whole protocol key to match;
    an unreadable file is a miss."""
    try:
        with open(path) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return None
    return blob.get("result") if blob.get("key") == key else None


def _cache_store(path: str, key: dict, result: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"key": key, "result": result}, f)
    os.replace(tmp, path)  # atomic: a killed run leaves no torn file


def evaluate_tree(pred_dir: str, gt_dir: str, lst_dir: str,
                  split: str = "test", metrics: list[str] | None = None,
                  num_points: int = 2048,
                  view_num: int = 24, dim: int = 110, workers: int = 8,
                  protocol: str = "vertices", device_iou: bool = False,
                  cache_dir: str | None = None,
                  device: str | torch.device | None = None) -> dict:
    """pred tree {pred_dir}/{cat}/{cat}_{obj}_{view:02d}.obj against
    {gt_dir}/{cat}/{obj}/isosurf.obj for the objects of
    {lst_dir}/*_{split}.lst. The metrics run on `device` (the GPU by
    default; it raises without one)."""
    dev = device_mod.resolve(device)
    which = set(metrics or ["cd", "emd", "fscore", "iou"])
    cats = {}
    for f in glob.glob(os.path.join(lst_dir, f"*_{split}.lst")):
        cat = os.path.basename(f).rsplit("_", 1)[0]
        cats[cat] = listing.read_lst(f)

    results: dict = {"categories": {}, "num_points": num_points}
    weighted: dict[str, float] = {}
    total_objs = 0
    for cat, objs in sorted(cats.items()):
        per_obj = []
        jobs = []
        for obj in objs:
            gt_mesh = os.path.join(gt_dir, cat, obj, "isosurf.obj")
            preds = [os.path.join(pred_dir, cat, f"{cat}_{obj}_{v:02d}.obj")
                     for v in range(view_num)]
            jobs.append((obj, gt_mesh, preds))

        def host_one(j: tuple):
            """Pool thread: the cache look-up and the host half."""
            obj, gt_mesh, preds = j
            key = _cache_key(num_points, which, dim, protocol, len(preds))
            cpath = (os.path.join(cache_dir, cat, obj + ".json")
                     if cache_dir else None)
            if cpath is not None:
                hit = _cache_load(cpath, key)
                if hit is not None:
                    return ("hit", hit, cpath, key)
            host = _object_host(gt_mesh, preds, num_points, which, dim,
                                protocol=protocol, device_iou=device_iou)
            return ("miss", host, cpath, key)

        with ThreadPoolExecutor(workers) as pool:
            # at most 2 x workers host halves ahead of the device half, so
            # finished point clouds never pile up when the device lags
            job_iter = iter(jobs)
            inflight: deque = deque()

            def fill():
                while len(inflight) < 2 * workers:
                    j = next(job_iter, None)
                    if j is None:
                        return
                    inflight.append(pool.submit(host_one, j))

            fill()
            while inflight:
                tag, payload, cpath, key = inflight.popleft().result()
                fill()
                if tag == "hit":
                    per_obj.append(payload)
                    continue
                if payload is None:
                    continue
                r = _object_device(payload, which, dim=dim, device=dev)
                if cpath is not None:
                    _cache_store(cpath, key, r)
                per_obj.append(r)
        if not per_obj:
            continue
        summary = {"objects": len(per_obj)}
        for key in ("cd_avg", "cd_min", "emd_avg", "emd_min", "iou_avg",
                    "iou_best"):
            vals = [o[key] for o in per_obj if key in o]
            if vals:
                summary[key] = float(np.mean(vals))
        f1s = [o["f1"] for o in per_obj if "f1" in o]
        if f1s:
            summary["f1"] = np.mean(np.asarray(f1s), axis=0).tolist()
            summary["f1_thresholds_pct"] = list(F_THRESHOLDS)
            for k in ("f_precision", "f_recall"):
                vals = [o[k] for o in per_obj if k in o]
                if vals:
                    summary[k] = np.mean(np.asarray(vals), axis=0).tolist()
        results["categories"][cat] = summary
        total_objs += len(per_obj)
        for k, v in summary.items():
            if isinstance(v, float):
                weighted[k] = weighted.get(k, 0.0) + v * len(per_obj)
    results["overall"] = {k: v / max(total_objs, 1)
                          for k, v in weighted.items() if k != "objects"}
    # overall F-score: the object-count-weighted average of the categories'
    # precision and recall vectors, then the harmonic mean
    # (test_f_score.py:176-181)
    pcats = [(c, s) for c, s in results["categories"].items()
             if "f_precision" in s]
    if pcats:
        cnts = np.asarray([s["objects"] for _, s in pcats], np.float64)
        pre = np.average(np.asarray([s["f_precision"] for _, s in pcats]),
                         axis=0, weights=cnts)
        rec = np.average(np.asarray([s["f_recall"] for _, s in pcats]),
                         axis=0, weights=cnts)
        f1 = 2 * pre * rec / np.maximum(pre + rec, 1e-9)
        results["overall"]["f_precision"] = pre.tolist()
        results["overall"]["f_recall"] = rec.tolist()
        results["overall"]["f1"] = f1.tolist()
        results["overall"]["f1_thresholds_pct"] = list(F_THRESHOLDS)
    results["total_objects"] = total_objs
    return results
