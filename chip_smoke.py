"""Smoke run of disn_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and nvcc. It
imports nothing of JAX or disn_tpu. Phases, each fatal on failure:

1. build every kernel of the port from csrc/ (nvcc, sm_90a) and report the
   build seconds and the compiler's register/shared-memory/wgmma report;
   a wgmma the compiler serialised fails the run;
2. drive the main path, pipeline.image_to_mesh at sdf_res=256 on the
   full-width VGG-16 two-stream net (analytic octahedron head, r=0.6, the
   demo camera): a warm-up image and 3 fresh seeded u8 images in bf16, then
   one image in f32 with TF32 off. Checks: > 1000 faces, every vertex on
   |x|+|y|+|z| = 0.6, and K1 launched in both the coarse and the fine pass.
   The inputs of K1's two launches for one bf16 image and the f32 image are
   kept;
3. hold K1 against its plain PyTorch version on the card, timing both with
   CUDA events: (a) on those kept main-path inputs; (b) at the same two
   shapes (the coarse pass: all 4,096 cells of the 65^3 grid; the fine
   pass: the main path's active cells of the 257^3 grid) with seeded random
   full-width head weights and a random map, which exercise the feature
   sampling and the local stream that the analytic head zeroes, in float32
   and bfloat16, with the demo camera and one whose w=0 plane cuts the box;
   (c) at ragged cell counts (1, 3, 5 and the fine pass's count minus one,
   which the bf16 wrapper pads to whole clusters), the same way; (d) on 200
   random cells of a 49^3 grid, whose spacing 2/48 is inexact in f32 (the
   main path's 2/64 and 2/256 are exact), the same way;
4. print per-stage times, each bf16 main-path launch's share of its bound
   and the weight bytes it moves from L2, the card, and the kernel table as
   JSON.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before printing it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12     # FMA units, no tensor cores
H100_BYTES_PER_S = 3.35e12
# K1 against its plain version: f32 differs only in summation order; bf16
# bounds are tests/test_fused.py's (both sides round to bf16 per layer,
# and f32 accumulation order decides ties)
F32_REL_TOL = 1e-4
BF16_MAX_REL, BF16_MEAN_REL = 0.02, 0.003
# the bf16 kernel's weight stream per fetch: w2, w3, wp, w4 of both streams
# in bf16 plus small_params' f32 biases, w1 and w5
K1_WEIGHT_BYTES = 2 * 2 * (64 * 256 + 256 * 512 + 512 * 512 + 512 * 256) \
    + 2 * 2308 * 4
RAGGED_CELLS = (1, 3, 5)
# vertex distance from the octahedron surface |x|+|y|+|z| = 0.6. Grid
# coordinates k/128 - 1 are exact in bf16, and near the surface their sum
# (in [0.5, 1), a multiple of 1/128) is too, so the analytic head's field
# is exact at grid points up to f32 rounding in both types, and a vertex
# (interpolated in f32 along a tet edge on which the field is linear) is
# off the surface by f32 rounding alone: a few ulp(0.6) = 6e-8. 1e-5 is
# ~100x that and still catches a 0.1% error in the head's output.
SURFACE_TOL = 1e-5
TRANS_W0_IN_BOX = np.vstack([np.eye(3) * 60, [68.0, 68.0, 2.0]]
                            ).astype(np.float32)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def k1_macs(out_dim: int) -> int:
    """Multiply-adds per point, both streams."""
    return 2 * (3 * 64 + 64 * 256 + 256 * 512 + 512 * 512 + 512 * 256
                + 256 * out_dim)


def k1_bound(args, kw) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes") for one K1
    call: each input read once, the output written once, the MACs at the
    tensor-core (bf16) or FMA (f32) peak."""
    import torch
    fmap, weights, trans, geom, cells = args
    out_dim = weights[10].shape[1]
    n_pts = cells.numel() * 64
    flops = 2.0 * n_pts * k1_macs(out_dim)
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (fmap, *weights, trans, geom, cells))
              + n_pts * out_dim * 4)
    peak = H100_BF16_FLOPS if fmap.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    from disn_tpu_torch.ops import fused_decode
    secs = fused_decode.build_seconds()
    print(f"[build] fused_decode.cu built and loaded in {secs:.2f} s")
    log = fused_decode.build().with_suffix(".log").read_text()
    keys = ("registers", "spill", "smem", "wgmma", "Performance",
            "setmaxnreg")
    for line in log.splitlines():
        if any(k in line for k in keys):
            print(f"[build] {line.strip()}")
    check("serialized" not in log,
          "the compiler serialised wgmma instructions (see the build log)")


def hold_k1(label: str, args, kw, timed: bool = True) -> dict:
    """One K1 call against fused_decode_plain on the same inputs: check the
    tolerance, and time both unless `timed` is false. These launches are
    made after the main path's counts were read."""
    import torch
    from disn_tpu_torch.ops import fused_decode

    k1, plain = fused_decode.fused_cell_decode, fused_decode.fused_decode_plain
    got = k1(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
    err = (got - want).abs()
    scale = max(want.abs().max().item(), 1e-3)
    max_err, mean_err = err.max().item(), err.mean().item()
    if args[0].dtype == torch.float32:
        ok = max_err <= F32_REL_TOL * scale
    else:
        ok = (max_err <= BF16_MAX_REL * scale
              and mean_err <= BF16_MEAN_REL * scale)
    ms = cuda_ms(lambda: k1(*args, **kw), 5) if timed else float("nan")
    plain_ms = (cuda_ms(lambda: plain(*args, **kw), 2) if timed
                else float("nan"))
    bound_ms, bound_by = k1_bound(args, kw)
    print(f"[k1] {label} cells={args[4].numel()} fine_r={kw['fine_r']} "
          f"max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
          f"max|want|={scale:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) ok={ok}")
    check(ok, f"K1 {label} disagrees with its plain version: max "
              f"{max_err:.3e} mean {mean_err:.3e} scale {scale:.3e}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def random_k1_args(dtype, cam, main_args, seed: int = 0):
    """Seeded random full-width head weights (non-zero biases) and folded
    map in `dtype`, with the cell ids and geometry of a main-path launch."""
    import torch
    from disn_tpu_torch.models import sdfnet
    from disn_tpu_torch.ops import fused_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {"sdfprediction": sdfnet.init_global_head(gen, dev, 1024),
              "sdfprediction_imgfeat": sdfnet.init_local_head(gen, dev,
                                                              1472)}
    for scope in params.values():
        for layer in scope.values():
            for p in layer.values():
                p["biases"] = 0.1 * torch.randn(
                    p["biases"].shape, generator=gen, device=dev)
    g_contrib = torch.randn(1, 512, generator=gen, device=dev).to(dtype)
    fmap = (0.5 * torch.randn(137, 137, 512, generator=gen, device=dev)
            ).to(dtype)
    weights = fused_decode.pack_weights(params, g_contrib, dtype)
    trans = torch.from_numpy(np.ascontiguousarray(cam)).to(dev)
    _, _, _, geom, cells = main_args
    return fmap, weights, trans, geom, cells


def phase_k1_check(kept: dict) -> dict:
    """Hold K1 against its plain version on the main path's own inputs, and
    with random weights at its shapes, at ragged counts and on a 49^3 grid.
    Returns the timed results by label."""
    import torch
    from disn_tpu_torch.data import synthetic

    res = {}
    for dt, calls in kept.items():
        for (args, kw), pass_ in zip(calls, ("coarse", "fine")):
            res[(dt, "main", pass_)] = hold_k1(f"{dt} main-path {pass_}",
                                               args, kw)
    args_by_pass = dict(zip(("coarse", "fine"), kept["bf16"]))
    fine_args, fine_kw = args_by_pass["fine"]
    n_fine = fine_args[4].numel()
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for cam_name, cam in (("demo", synthetic.demo_trans_mat()),
                              ("w0_plane_in_box", TRANS_W0_IN_BOX)):
            for pass_, (margs, kw) in args_by_pass.items():
                args = random_k1_args(dtype, cam, margs)
                res[(dt, cam_name, pass_)] = hold_k1(
                    f"{dt} random camera={cam_name} {pass_}", args, kw)
                if pass_ != "fine":
                    continue
                for n in (*RAGGED_CELLS, n_fine - 1):
                    ragged = (*args[:4], args[4][:n].contiguous())
                    hold_k1(f"{dt} random camera={cam_name} ragged n={n}",
                            ragged, kw, timed=False)
            args = random_k1_args(dtype, cam, (*fine_args[:3], *grid49()))
            hold_k1(f"{dt} random camera={cam_name} grid 49^3", args,
                    dict(fine_r=49, coarse_c=12, img_w=137, img_h=137),
                    timed=False)
    return res


def grid49() -> tuple:
    """(geom, cell ids): the box [-1, 1]^3 and 200 seeded random cells of
    the 12^3 coarse grid of a 49^3 fine grid."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cells = torch.randperm(12 ** 3, generator=gen, device=dev)[:200]
    return (torch.tensor([-1, -1, -1, 1, 1, 1.0], device=dev),
            cells.sort().values.int())


def print_k1_shares(kept: dict, ref: list) -> None:
    """Each bf16 main-path launch's share of its bound and the weight bytes
    the design moves from L2 for it: one fetch per cluster of cells."""
    from disn_tpu_torch.ops import fused_decode

    cluster = fused_decode._lib().fused_decode_cluster()
    l2_total = 0
    for (args, kw), r, pass_ in zip(kept["bf16"], ref, ("coarse", "fine")):
        l2 = -(-args[4].numel() // cluster) * K1_WEIGHT_BYTES
        l2_total += l2
        print(f"[k1] bf16 main-path {pass_}: share of bound "
              f"{r['bound_ms'] / r['ms']:.4f}, l2_weight_bytes={l2} "
              f"(cluster of {cluster})")
    print(f"[k1] bf16 main-path per image: share of bound "
          f"{sum(r['bound_ms'] for r in ref) / sum(r['ms'] for r in ref):.4f}"
          f", l2_weight_bytes={l2_total}")


def run_main_path(cfg, params, imgs, trans, label: str, keep: int,
                  kept: dict) -> list[dict]:
    """image_to_mesh on each image; returns per-image stats. The inputs of
    image `keep`'s K1 launches go into kept[label]."""
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import fused_decode

    k1 = fused_decode.fused_cell_decode
    out = []
    for i, img in enumerate(imgs):
        stats: dict = {}
        before = k1.launches
        k1.events = []
        k1.inputs = [] if i == keep else None
        t0 = time.perf_counter()
        verts, faces = pipeline.image_to_mesh(params, img, trans, cfg,
                                              stats=stats)
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        k1_ms = sum(s.elapsed_time(e) for s, e in k1.events)
        if i == keep:
            kept[label] = k1.inputs
        k1.events = k1.inputs = None
        launches = k1.launches - before
        dist = np.abs(np.abs(verts).sum(1) - 0.6)
        stats.update(image=i, wall_ms=wall_ms, k1_ms=k1_ms,
                     k1_launches=launches, faces=len(faces),
                     verts=len(verts),
                     max_surface_dist=float(dist.max()) if len(verts)
                     else float("nan"))
        print(f"[main {label}] " + json.dumps(stats))
        check(len(faces) > 1000, f"{label} image {i}: {len(faces)} faces")
        check(np.isfinite(verts).all(), f"{label} image {i}: bad vertices")
        check(float(dist.max()) <= SURFACE_TOL,
              f"{label} image {i}: a vertex is {dist.max():.3e} off the "
              f"surface (tolerance {SURFACE_TOL})")
        check(not stats["dense_fallback"] and launches == 2,
              f"{label} image {i}: expected K1 in the coarse and the fine "
              f"pass (2 launches, no dense fallback), got {launches} "
              f"launches, fallback={stats['dense_fallback']}")
        out.append(stats)
    return out


def phase_main_path() -> tuple[int, list[dict], dict]:
    """The main path with K1's launch count set to 0 just before it and
    read just after. Returns (launches, per-image stats, kept inputs)."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.ops import fused_decode

    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
            for _ in range(5)]
    trans = synthetic.demo_trans_mat()
    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    kept: dict = {}
    torch.cuda.synchronize()
    fused_decode.fused_cell_decode.launches = 0
    runs = run_main_path(cfg, params, imgs[:4], trans, "bf16", 1, kept)
    cfg32 = cfg.replace(compute_dtype="float32")
    runs += run_main_path(cfg32, params, imgs[4:], trans, "f32", 0, kept)
    launches = fused_decode.fused_cell_decode.launches
    return launches, runs, kept


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import disn_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (disn_tpu_torch "
              "not found)", file=sys.stderr)
        return 2
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        phase_build()
        launches, runs, kept = phase_main_path()
        k1 = phase_k1_check(kept)
        timed = runs[1:4]
        for key in ("encode_ms", "prep_ms", "phase_a_ms", "phase_b_ms",
                    "extraction_ms", "wall_ms", "k1_ms"):
            vals = [r[key] for r in timed]
            print(f"[stages bf16 257^3] {key} median={np.median(vals):.3f} "
                  f"all={[round(v, 3) for v in vals]}")
        print(f"[stages bf16 257^3] active_cells="
              f"{[r['active_cells'] for r in timed]} faces="
              f"{[r['faces'] for r in timed]}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"[card] {smi}")
        print(f"[total] {time.perf_counter() - t0:.1f} s")
        # K1 per bf16 image: its coarse + fine launch on the main path's
        # own inputs (image 1); no single PyTorch call computes K1
        ref = [k1[("bf16", "main", p)] for p in ("coarse", "fine")]
        print_k1_shares(kept, ref)
        print(json.dumps({"kernels": [{
            "name": "fused_cell_decode", "route": "cuda",
            "source": "disn_tpu_torch/csrc/fused_decode.cu",
            "replaces": "disn_tpu/ops/pallas_fused.py:46",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in ref),
            "ms": sum(r["ms"] for r in ref),
            "plain_ms": sum(r["plain_ms"] for r in ref),
            "bound_ms": sum(r["bound_ms"] for r in ref),
            "bound_by": ref[1]["bound_by"], "library_ms": None}]}))
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
