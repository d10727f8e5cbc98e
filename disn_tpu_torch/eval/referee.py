"""The float64 referees of K6b (approx_match) and K6d (match_cost_grad),
and a comparison on the card of this checkout's K6b with another
checkout's.

The auction amplifies rounding: at level -16384 a change delta in a squared
distance moves exp(level * d) by a factor of about 16384 * delta. Two
float32 runs that round d in different orders (the kernel and its plain
version) can then differ by ~1e-3 in a marginal, and comparing one with
the other cannot say which is wrong. The referee is the plain version run
in float64 (every intermediate float64); a float32 match is measured by its
distance from it, beside the distance of the float32 plain version on the
same clouds:

* ``n``: the largest difference of the marginal per xyz1 point (match
  summed over M), [B, N];
* ``m``: the same of the marginal per xyz2 point (summed over N), [B, M];
* ``emd``: the largest relative difference of the cost (match_cost_plain
  in float64 of each match), [B].

``within`` holds a kernel to at most ``RATIO`` times the plain version's
distance plus ``ABS`` on each of the three.

K6d (match_cost_grad) has a referee of its own: ``grad_referee`` runs
match_cost_grad_plain with every intermediate float64 on the same match
and g, and ``grad_distance`` gives a float32 gradient's largest absolute
difference from it, of g1 and of g2, per batch entry. ``grad_within``
holds a kernel to ``RATIO`` times the plain version's distance plus
``GRAD_ULPS`` float32 ulps of the gradient's scale, |g[b]| times the
larger of match's two largest marginals.

    python -m disn_tpu_torch.eval.referee [--parent DIR] [--out FILE]

runs the inputs of ``referee_inputs`` on the card: the distances of this
checkout's K6b and of the float32 plain version, those of its K6d and of
match_cost_grad_plain on that K6b's match, and, given the root of
another checkout (for example the parent commit, unpacked with ``git
archive``), that checkout's csrc/metrics.cu built beside this one and run
on the same clouds. It prints one JSON line an input, whether the two
kernels gave the same bits, and at the protocol's shape both kernels' times
in turns (parent, change, change, parent; CUDA events, median of `--reps`
after a warm-up). It needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from disn_tpu_torch import kernels
from disn_tpu_torch.eval import metrics

RATIO = 2.0
ABS = 1e-7
KEYS = ("n", "m", "emd")
# K6d's absolute term: one float32 ulp (2^-23) of the gradient's scale, what
# the last rounding (the product by g[b]) alone can cost; it matters only
# where the plain version lands on the referee exactly, as it can when a
# gradient entry has a single term (N or M = 1)
GRAD_ULPS = 1.0
GRAD_KEYS = ("g1", "g2")
# the GPU tests' shapes (tests/test_torch_eval_cuda.py SHAPES, seed 1),
# then ragged shapes at many seeds, then the protocol's size
SHAPES = ((1, 1, 1), (2, 5, 3), (3, 256, 100), (3, 100, 256),
          (2, 257, 191), (4, 512, 512), (1, 1000, 2047))
SEEDED = ((1, 1500, 777), (1, 777, 1500), (3, 2047, 1537))
PROTOCOL = (24, 2048, 2048)


def clouds(b: int, n: int, m: int, seed: int, device="cuda"
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 [b,n,3], xyz2 [b,m,3]: 0.5 * randn, as the GPU tests draw
    them (RandomState(seed + 7n + m))."""
    rng = np.random.RandomState(seed + 7 * n + m)
    return (torch.from_numpy((0.5 * rng.randn(b, n, 3)).astype(np.float32)
                             ).to(device),
            torch.from_numpy((0.5 * rng.randn(b, m, 3)).astype(np.float32)
                             ).to(device))


def referee_inputs(seeds: int = 16) -> list[tuple[str, int, int, int, int]]:
    """(label, b, n, m, seed) of the standing referee inputs."""
    out = [("shapes", b, n, m, 1) for b, n, m in SHAPES]
    out += [("seeded", b, n, m, s) for b, n, m in SEEDED
            for s in range(seeds)]
    out.append(("protocol", *PROTOCOL, 0))
    return out


def referee(xyz1: torch.Tensor, xyz2: torch.Tensor) -> dict:
    """The float64 plain version's marginals and cost on these clouds."""
    x, y = xyz1.double(), xyz2.double()
    match = metrics.approx_match_plain(x, y)
    return {"xyz": (x, y), "n": match.sum(1), "m": match.sum(2),
            "emd": metrics.match_cost_plain(x, y, match)}


def distance(match: torch.Tensor, ref: dict) -> dict:
    """Largest |difference| from the referee of each of `match`'s
    marginals, and relative of its cost, all taken in float64."""
    m64 = match.double()
    cost = metrics.match_cost_plain(*ref["xyz"], m64)
    return {"n": float((m64.sum(1) - ref["n"]).abs().max()),
            "m": float((m64.sum(2) - ref["m"]).abs().max()),
            "emd": float(((cost - ref["emd"]).abs()
                          / ref["emd"].abs().clamp_min(1e-300)).max())}


def within(kernel: dict, plain: dict) -> bool:
    """Each distance of `kernel` at most RATIO x the plain version's + ABS."""
    return all(kernel[k] <= RATIO * plain[k] + ABS for k in KEYS)


def grad_referee(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor,
                 g: torch.Tensor) -> dict:
    """match_cost_grad_plain run in float64 on these inputs (float64 in
    every intermediate), and the gradient's scale per batch entry: |g[b]|
    times the larger of match's largest marginal per xyz1 and per xyz2
    point."""
    x, y, mm, gg = xyz1.double(), xyz2.double(), match.double(), g.double()
    g1, g2 = metrics.match_cost_grad_plain(x, y, mm, gg)
    marginal = torch.maximum(mm.sum(1).amax(-1), mm.sum(2).amax(-1))
    return {"g1": g1, "g2": g2, "scale": gg.abs() * marginal}


def grad_distance(grads, ref: dict) -> dict:
    """Largest |difference| from the referee of g1 and of g2 of a gradient
    pair (g1 [B,N,3], g2 [B,M,3]), per batch entry [B], in float64."""
    return {k: (t.double() - ref[k]).abs().flatten(1).amax(1)
            for k, t in zip(GRAD_KEYS, grads)}


def grad_within(kernel: dict, plain: dict, ref: dict) -> bool:
    """Each batch entry's distance of `kernel` at most RATIO x the plain
    version's + GRAD_ULPS float32 ulps of the entry's scale."""
    tol = GRAD_ULPS * 2.0 ** -23 * ref["scale"]
    return all(bool((kernel[k] <= RATIO * plain[k] + tol).all())
               for k in GRAD_KEYS)


def load(path: Path):
    """(library, run) of a build of some checkout's csrc/metrics.cu: run(x,
    y) is one auction on the card. A build from before the float64
    bookkeeping (it has no approx_match_d_tile) takes f32 scratch that
    holds the starting masses on entry. Only approx_match_launch is
    declared: the other entry points differ between builds."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if hasattr(lib, "approx_match_d_tile"):
        lib.approx_match_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci, cd,
                                            cd] + [vp] * 6
        lib.approx_match_launch.restype = ci
        return lib, lambda x, y: metrics._approx_match_run(lib, x, y)
    lib.approx_match_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci] + [vp] * 6
    lib.approx_match_launch.restype = ci

    def run(x, y):
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        multi_l, multi_r = metrics._masses(n, m)
        remain_l = torch.full((b, n), multi_l, device=x.device)
        remain_r = torch.full((b, m), multi_r, device=x.device)
        ratio_l = torch.empty((len(metrics.LEVELS), b, n), device=x.device)
        ratio_r = torch.empty((len(metrics.LEVELS), b, m), device=x.device)
        match = torch.empty((b, m, n), device=x.device)
        sq1, sq2 = metrics._sq(x), metrics._sq(y)
        metrics._raise_on(lib.approx_match_launch(
            x.data_ptr(), sq1.data_ptr(), n, y.data_ptr(), sq2.data_ptr(), m,
            b, remain_l.data_ptr(), remain_r.data_ptr(), ratio_l.data_ptr(),
            ratio_r.data_ptr(), match.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "approx_match")
        return match
    return lib, run


def _median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose "
                         "disn_tpu_torch/csrc/metrics.cu runs beside this one")
    ap.add_argument("--out", type=Path, default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("referee: needs a CUDA card", file=sys.stderr)
        return 2
    libs = {"change": load(metrics.build())[1]}
    if args.parent is not None:
        src = args.parent / "disn_tpu_torch" / "csrc" / "metrics.cu"
        libs["parent"] = load(kernels.nvcc_build("metrics", src=src))[1]
    out = open(args.out, "a") if args.out else None
    ok = True
    for label, b, n, m, seed in referee_inputs(args.seeds):
        x, y = clouds(b, n, m, seed)
        ref = referee(x, y)
        rec = {"label": label, "shape": [b, n, m], "seed": seed,
               "plain": distance(metrics.approx_match_plain(x, y), ref)}
        matches = {k: run(x, y) for k, run in libs.items()}
        for k, mk in matches.items():
            rec[k] = distance(mk, ref)
            rec[f"{k}_within"] = within(rec[k], rec["plain"])
        ok &= rec["change_within"]
        # K6d on the kernel's match, g = 0.5 + rand
        g = torch.from_numpy((0.5 + np.random.RandomState(seed + 5).rand(b))
                             .astype(np.float32)).cuda()
        gref = grad_referee(x, y, matches["change"], g)
        gd = {"plain": grad_distance(metrics.match_cost_grad_plain(
                  x, y, matches["change"], g), gref),
              "change": grad_distance(metrics.match_cost_grad(
                  x, y, matches["change"], g), gref)}
        rec["grad_within"] = grad_within(gd["change"], gd["plain"], gref)
        for k, d in gd.items():
            rec[f"grad_{k}"] = {key: float(v.max()) for key, v in d.items()}
        rec["grad_ratio"] = max(float((gd["change"][k] / gd["plain"][k]
                                       .clamp_min(1e-300)).max())
                                for k in GRAD_KEYS)
        ok &= rec["grad_within"]
        if "parent" in matches:
            rec["same_bits"] = torch.equal(matches["change"],
                                           matches["parent"])
        if label == "protocol":
            order = ["parent", "change", "change", "parent"] \
                if "parent" in libs else ["change", "change"]
            rec["ms"] = [[k, _median_ms(lambda run=libs[k]: run(x, y),
                                        args.reps)] for k in order]
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
        del ref, matches, gref
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}; this checkout's K6b within {RATIO} x the "
          f"plain version's distance + {ABS}, and its K6d within {RATIO} x "
          f"+ {GRAD_ULPS} ulp of the scale, on every input: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
