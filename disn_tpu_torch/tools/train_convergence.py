"""Full-width training convergence (port of
scripts/train_convergence_full.py): train the production configuration
(the full-width two-stream VGG-16 net, bf16 compute, fold-137 sampling,
B = 20) from a seed on the synthetic records through the port's
PrefetchLoader, then reconstruct one training view with image_to_mesh and
score its Chamfer distance against the analytic ground-truth mesh.

The synthetic renders encode the shape (each analytic SDF has its own
silhouette), so the net must learn image -> field. The records are
data/synthetic.memory_records' (what build_dataset writes, served from
memory: no h5 files are needed).

    python -m disn_tpu_torch.tools.train_convergence [--steps 1500]
        [--sdf-res 256] [--device cpu] [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config

LOG_EVERY = 200
N_SURFACE = 30000


def surface_samples(verts: np.ndarray, faces: np.ndarray, n: int,
                    rng: np.random.RandomState) -> np.ndarray:
    """n area-weighted uniform samples of a mesh's surface, [n,3] f32 (the
    script's own sampler: triangle by area, then a folded barycentric
    pair)."""
    tri = verts[faces]
    areas = np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    idx = rng.choice(len(faces), n, p=areas / areas.sum())
    a, b = rng.rand(n, 1), rng.rand(n, 1)
    flip = (a + b) > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    t = tri[idx]
    return (t[:, 0] + a * (t[:, 1] - t[:, 0])
            + b * (t[:, 2] - t[:, 0])).astype(np.float32)


def chamfer_x1000(pa: np.ndarray, pb: np.ndarray,
                  device: str | torch.device | None = None) -> float:
    """(mean d_ab + mean d_ba) x 1000 on squared distances, by
    eval/metrics.nn_distance (K6a on a card)."""
    from disn_tpu_torch.eval import metrics

    dev = device_mod.resolve(device)
    a, b = (torch.from_numpy(np.ascontiguousarray(x))[None].to(dev)
            for x in (pa, pb))
    with torch.no_grad():
        d1, _, d2, _ = metrics.nn_distance(a, b)
    return float((d1.mean() + d2.mean()) * 1000.0)


def analytic_mesh(fn, R: int, sdf_params, iso: float,
                  device: str | torch.device | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The owned extractor's mesh of the analytic field `fn` on the box's
    grid of R points a side."""
    from disn_tpu_torch.ops import marching

    lo, hi = np.asarray(sdf_params[:3]), np.asarray(sdf_params[3:6])
    axes = [np.linspace(lo[i], hi[i], R, dtype=np.float32) for i in range(3)]
    zz, yy, xx = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    vol = fn(np.stack([xx, yy, zz], axis=-1)).astype(np.float32)
    return marching.extract_mesh_owned(vol, sdf_params, iso=iso,
                                       device=device)


def train(cfg: Config, steps: int, records, device: torch.device,
          workers: int = 3, log: Callable = print):
    """`steps` train steps from a seed-0 state on batches of `records`
    (the 12 (object, view) pairs repeated to cover the run, one epoch)
    through PrefetchLoader -> (state, {"losses", "accuracy", "seconds",
    "loader_wait_s"}): every step's overall_loss and sign accuracy."""
    from disn_tpu_torch.data import pipeline, synthetic
    from disn_tpu_torch.train import trainer

    pairs = [(synthetic.SYNTH_CAT, obj, v) for obj, v in records[1]]
    reps = -(-(steps + 4) * cfg.batch_size // len(pairs))
    listinfo = pairs * reps
    ds = synthetic.memory_dataset(cfg, records, seed=0, listinfo=listinfo)
    sampler = pipeline.EpochSampler(
        listinfo, {synthetic.SYNTH_CAT: len(listinfo)}, cfg.cat_limit,
        shuffle=cfg.shuffle, seed=0)
    loader = pipeline.PrefetchLoader(ds, sampler, cfg.batch_size, epochs=1,
                                     workers=workers, seed=0, device=device)
    if loader.total_batches < steps:
        raise ValueError(f"{loader.total_batches} batches for {steps} steps "
                         f"(cfg.cat_limit {cfg.cat_limit})")
    state = trainer.create_state(cfg, seed=0, device=device)
    step = trainer.make_train_step(cfg, device=device)
    losses, accs = [], []
    loader.start()
    try:
        it = iter(loader)
        t0 = time.perf_counter()
        for i in range(steps):
            _, out = step(state, next(it))
            losses.append(out["overall_loss"].detach())
            accs.append(out["accuracy"].detach())
            if i % LOG_EVERY == 0:
                log(f"step {i}: loss={float(losses[-1]):.1f} "
                    f"acc={float(accs[-1]):.3f}")
        losses = [float(x) for x in losses]  # waits for the last step
        seconds = time.perf_counter() - t0
    finally:
        loader.shutdown()
    return state, {"losses": losses, "accuracy": [float(x) for x in accs],
                   "seconds": seconds, "loader_wait_s": loader.wait_s}


def run(steps: int = 1500, sdf_res: int = 256, cfg: Config | None = None,
        device: str | torch.device | None = None,
        num_samples: int = 16384, n_surface: int = N_SURFACE,
        workers: int = 3, log: Callable = print) -> dict:
    """Train (``train``), reconstruct the first training view (sphere0,
    view 0) with image_to_mesh and score CD x 1000 against the analytic
    mesh at the same grid (n_surface samples of each, one RandomState(0)).
    cfg defaults to Config(compute_dtype="bfloat16", sdf_res=sdf_res,
    view_num=4): full width, B = 20. Returns the script's keys (steps,
    sign_acc, cd_x1000, tris, steps_per_s, sdf_res) and the run's
    details."""
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    dev = device_mod.resolve(device)
    cfg = cfg or Config(compute_dtype="bfloat16", sdf_res=sdf_res,
                        view_num=4)
    records = synthetic.memory_records(views=4, num_samples=num_samples)
    state, hist = train(cfg, steps, records, dev, workers=workers, log=log)
    acc = hist["accuracy"][-1]
    log(f"trained {steps} steps in {hist['seconds']:.1f} s "
        f"({steps / hist['seconds']:.2f} steps/s); final sign acc {acc:.3f}")
    obj = "sphere0"
    rec = records[1][(obj, 0)]
    sdfp = records[0][obj].sdf_params
    stats: dict = {}
    with torch.no_grad():
        verts, faces = pipeline.image_to_mesh(
            state.params, rec.img_arr[:, :, :cfg.img_channels],
            rec.trans_mat, cfg, sdf_params=sdfp, device=dev, stats=stats)
    log(f"reconstructed {synthetic.SYNTH_CAT}/{obj}: {len(verts)} verts "
        f"{len(faces)} tris (route {stats['route']})")
    out = {"steps": steps, "sign_acc": acc, "cd_x1000": float("nan"),
           "tris": int(len(faces)), "steps_per_s": steps / hist["seconds"],
           "sdf_res": cfg.sdf_res, "route": stats["route"],
           "loss_first": hist["losses"][0], "loss_last": hist["losses"][-1],
           "losses": hist["losses"], "seconds": hist["seconds"],
           "loader_wait_s": hist["loader_wait_s"]}
    if len(faces):
        gv, gf = analytic_mesh(synthetic.SHAPES[obj], cfg.grid_resolution,
                               sdfp, cfg.iso, device=dev)
        rng = np.random.RandomState(0)
        pa = surface_samples(verts, faces, n_surface, rng)
        pb = surface_samples(gv, gf, n_surface, rng)
        out.update(cd_x1000=chamfer_x1000(pa, pb, dev), gt_tris=len(gf))
    log(f"CD*1000 vs analytic GT: {out['cd_x1000']:.3f} (sign acc "
        f"{acc:.3f})")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--sdf-res", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (the GPU by default)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(args.steps, args.sdf_res, device=args.device,
              log=lambda m: print(m, flush=True))
    if args.json:
        keys = ("steps", "sign_acc", "cd_x1000", "tris", "steps_per_s",
                "sdf_res")
        with open(args.json, "w") as f:
            json.dump({k: out[k] for k in keys}, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
