"""Where K4 and the block compaction spend their time, phase by phase.

    python -m disn_tpu_torch.ops.cull_trace [--ctas 16] [--reps 3] [--scale]

Builds csrc/band_cull.cu and csrc/block_compact.cu a second time with
-DCULL_TRACE (the default builds have no stamps), runs K4's fused call on
the main path's coarse grid (the analytic octahedron's field |x|+|y|+|z| -
0.6 on 65^3, both modes, the fixed form at 65,536 cells) and the capped
compaction on seeded block bits of the 257^3 grid (a block holds change
bits with probability 0.017, as the main path's 4,568 of 274,625 do),
and prints the stamps of CTA 0's thread 0: %globaltimer microseconds and
SM clocks from the kernel's start to each phase's end (K4: A's barrier,
tau, D's count, its barrier, E's ids, the end; the compaction: phase 1,
the barrier and offsets, phase 2, the end). A stamp after a barrier waits
for the slowest CTA. With --scale it prints instead each kernel's device
time (torch.profiler, mean of 10 launches; the default builds) with
clusters of 1, 2, 4, 8 and 16 CTAs: how the time follows the SMs a
cluster has. It needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from disn_tpu_torch import kernels
from disn_tpu_torch.ops import band_cull, block_compact

K4_STAMPS = ("A", "tau", "D", "barrier", "E", "end")
KC_STAMPS = ("phase 1", "offsets", "phase 2", "end")


def octahedron(rc: int, dev) -> torch.Tensor:
    lin = torch.linspace(-1.0, 1.0, rc, device=dev)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    return (x.abs() + y.abs() + z.abs() - 0.6).contiguous()


def block_bits(E: int, density: float, seed: int, dev):
    """bits [B3^3, 2] int32, cand [B3^3] bool and an own-slot table."""
    rng = np.random.RandomState(seed)
    b3 = -(-E // 4)
    nb = b3 ** 3
    words = np.where(rng.rand(nb, 64) < 1 / 3, 1, 0).astype(np.uint64)
    words *= (rng.rand(nb) < density)[:, None].astype(np.uint64)
    packed = (words << np.arange(64, dtype=np.uint64)).sum(1,
                                                           dtype=np.uint64)
    bits = torch.from_numpy(packed.view(np.int32).reshape(nb, 2).copy())
    cand = torch.from_numpy(rng.rand(nb) < 0.8)
    own = torch.arange((b3 - 1) ** 3, dtype=torch.int32)
    return bits.to(dev), cand.to(dev), own.to(dev)


def stamps(lib, fn_name: str, n: int) -> tuple[list, list]:
    """(us, clocks) of stamps 1..n after stamp 0."""
    buf = (ctypes.c_longlong * 16)()
    getattr(lib, fn_name)(buf)
    t = list(buf)
    return ([round((t[i] - t[0]) / 1e3, 2) for i in range(1, n + 1)],
            [t[8 + i] - t[8] for i in range(1, n + 1)])


def device_us(fn, calls: int = 10) -> float:
    """The device time a call of fn, us: torch.profiler over `calls`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / calls


def scale(dev) -> None:
    """Each kernel's device time with clusters of 1 to 16 CTAs."""
    vol = octahedron(65, dev)
    box = torch.tensor([-1, -1, -1, 1, 1, 1], dtype=torch.float32,
                       device=dev)
    bits, cand, own = block_bits(257, 0.017, 1, dev)
    runs = {"K4 (tau and the cull)": lambda: band_cull.band_cull(
                vol, box, 65, 1.5, True, "band", 65536),
            "K4 (the cull alone)": lambda: band_cull.band_cull(
                vol, box, 65, 1.5, False, "band", 65536),
            "K2c (capped)": lambda: block_compact.compact_block_bits(
                bits, cand, 257, own, 16384)}
    for name, fn in runs.items():
        times = []
        for ctas in (1, 2, 4, 8, 16):
            band_cull.CTAS = block_compact.CTAS = ctas
            times.append((ctas, round(device_us(fn), 2)))
        print(f"[cull trace] {name}, device us by CTAs of the cluster: "
              f"{times}; {torch.cuda.get_device_name(0)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ctas", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scale", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cuda")
    if args.scale:
        return scale(dev)
    k4 = band_cull.bind(kernels.nvcc_build("band_cull", ("CULL_TRACE",)))
    kc = block_compact.bind(kernels.nvcc_build("block_compact",
                                               ("CULL_TRACE",)))
    for lib, name in ((k4, "band_cull_trace"), (kc, "compact_trace")):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    band_cull._lib = lambda: k4
    block_compact._lib = lambda: kc
    band_cull.CTAS = block_compact.CTAS = args.ctas
    vol = octahedron(65, dev)
    box = torch.tensor([-1, -1, -1, 1, 1, 1], dtype=torch.float32,
                       device=dev)
    bits, cand, own = block_bits(257, 0.017, 1, dev)
    card = torch.cuda.get_device_name(0)
    for mode in ("band", "sign"):
        for _ in range(args.reps):
            band_cull.band_cull(vol, box, 65, 1.5, True, mode, 65536)
            torch.cuda.synchronize()
            us, clk = stamps(k4, "band_cull_trace", len(K4_STAMPS))
            print(f"[cull trace] K4 {mode}, {args.ctas} CTAs: "
                  + ", ".join(f"{k} {u} us ({c} clocks)"
                              for k, u, c in zip(K4_STAMPS, us, clk))
                  + f"; {card}")
    for _ in range(args.reps):
        block_compact.compact_block_bits(bits, cand, 257, own, 16384)
        torch.cuda.synchronize()
        us, clk = stamps(kc, "compact_trace", len(KC_STAMPS))
        print(f"[cull trace] K2c capped, {args.ctas} CTAs: "
              + ", ".join(f"{k} {u} us ({c} clocks)"
                          for k, u, c in zip(KC_STAMPS, us, clk))
              + f"; {card}")


if __name__ == "__main__":
    main()
