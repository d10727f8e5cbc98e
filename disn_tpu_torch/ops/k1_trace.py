"""Where K1 spends its time, phase by phase, on the card.

    python -m disn_tpu_torch.ops.k1_trace [--dtype bf16|f32] [--cells 17888]
                                          [--reps 3]

Builds csrc/fused_decode.cu a second time with -DK1_TRACE (the default
build has no stamps), runs the bf16 or the f32 kernel on N random cells of
the 257^3 grid with seeded random full-width head weights and map (the
demo camera), and prints for each phase the median over blocks of the SM
clocks that thread 0 (consumer warpgroup 0 in bf16, warp 0 in f32) spent in
it (in each block's last cell: the kernel is persistent), beside the floor
of each layer's product: 64 x K x N MACs at 2,048 dense bf16 MACs per clock
per SM on the tensor cores (989 TFLOP/s over 132 SMs at 1.83 GHz) or 128
f32 FMAs per clock per SM (67 TFLOP/s over 132 SMs at 1.98 GHz). In f32 it
also prints the clocks thread 0 spent in the local stream's feature
gathers, which run inside that stream's wp product loop. It needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from disn_tpu_torch.data import synthetic
from disn_tpu_torch.models import sdfnet
from disn_tpu_torch.ops import fused_decode

MACS_PER_CLOCK = {"bf16": 2048, "f32": 128}
EVENTS = 21  # TRACE_EVENTS in csrc/fused_decode.cu
LAST_STAMP = 19  # the local stream's last layer done
GATHER_EVENT = 20  # f32: the feature gathers' clocks (a duration)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
LAYERS = (("w2", 64, 256), ("w3", 256, 512), ("wp", 512, 512),
          ("w4", 512, 256))


def random_inputs(n_cells: int, dtype: torch.dtype = torch.bfloat16,
                  seed: int = 0):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {"sdfprediction": sdfnet.init_global_head(gen, dev, 1024),
              "sdfprediction_imgfeat": sdfnet.init_local_head(gen, dev, 1472)}
    g_contrib = torch.randn(1, 512, generator=gen, device=dev)
    fmap = (0.5 * torch.randn(137, 137, 512, generator=gen, device=dev)
            ).to(dtype)
    weights = fused_decode.pack_weights(params, g_contrib.to(dtype), dtype)
    cells = torch.randperm(64 ** 3, generator=gen, device=dev
                           )[:n_cells].sort().values.int()
    trans = torch.from_numpy(synthetic.demo_trans_mat()).to(dev)
    geom = torch.tensor([-1, -1, -1, 1, 1, 1.0], device=dev)
    return fmap, weights, trans, geom, cells


def phases(loop: str = "MMA") -> list[tuple[str, int, int, int]]:
    """(name, first event, last event, MACs of the phase's product)."""
    out = [("set-up (taps, barriers)", 0, 1, 0)]
    for s, stream in enumerate(("global", "local")):
        b = 2 + 9 * s
        out.append((f"{stream} fold1/conv1 (FMA units)", b - 1, b, 0))
        for i, (name, k, n) in enumerate(LAYERS):
            out.append((f"{stream} {name} {loop} loop", b + 2 * i,
                        b + 2 * i + 1, 64 * k * n))
            epi = "epilogue + last layer" if name == "w4" else "epilogue"
            out.append((f"{stream} {name} {epi}", b + 2 * i + 1,
                        b + 2 * i + 2, 0))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    ap.add_argument("--cells", type=int, default=17888)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_trace needs a CUDA card")
    lib = fused_decode._lib(("K1_TRACE",))
    lib.fused_decode_set_trace.argtypes = [ctypes.c_void_p]
    cluster = lib.fused_decode_cluster()
    args = random_inputs(a.cells, DTYPES[a.dtype])
    n_blocks = -(-a.cells // cluster) * cluster
    buf = torch.zeros(n_blocks * 2 * EVENTS, dtype=torch.int64, device="cuda")
    if lib.fused_decode_set_trace(buf.data_ptr()) != 0:
        raise RuntimeError("could not set the trace buffer")
    times = []
    for _ in range(a.reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fused_decode._launch(lib, *args, fine_r=257, coarse_c=64, img_w=137,
                             img_h=137)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    stamps = buf.reshape(n_blocks, 2, EVENTS)[:, 0].cpu().numpy()
    stamps = stamps[stamps[:, LAST_STAMP] != 0]  # blocks of the grid
    total = np.median(stamps[:, LAST_STAMP] - stamps[:, 0])
    loop = "MMA" if a.dtype == "bf16" else "FMA"
    rows = []
    for name, e0, e1, macs in phases(loop):
        clk = float(np.median(stamps[:, e1] - stamps[:, e0]))
        floor = macs / MACS_PER_CLOCK[a.dtype]
        rows.append(dict(phase=name, clocks=clk, share=clk / total,
                         floor_clocks=floor))
        print(f"[k1_trace] {name:38s} {clk:9.0f} clk {clk / total:6.1%}"
              + (f"  floor {floor:7.0f} clk" if macs else ""))
    extra = {}
    if a.dtype == "f32":
        gather = float(np.median(stamps[:, GATHER_EVENT]))
        extra["gather_clocks"] = gather
        print(f"[k1_trace] local wp feature gathers (inside its loop) "
              f"{gather:9.0f} clk {gather / total:6.1%}")
    prod = sum(r["clocks"] for r in rows if f"{loop} loop" in r["phase"])
    floor = sum(r["floor_clocks"] for r in rows)
    print(f"[k1_trace] {a.dtype} block total {total:.0f} clk (median), "
          f"{loop} loops {prod:.0f} clk vs floor {floor:.0f}, kernel ms "
          f"{[round(t, 3) for t in times[1:]]}")
    print(json.dumps({"k1_trace": rows, "block_clocks": float(total),
                      "dtype": a.dtype, "cells": a.cells, "cluster": cluster,
                      "kernel_ms": times[1:], **extra}))


if __name__ == "__main__":
    main()
