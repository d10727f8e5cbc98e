"""K2c, the block compaction of both mesh flows' scans: wrapper and build.

Replaces ``disn_tpu/ops/marching.py::_compact_block_bits`` (XLA code the
JAX package wrote for the TPU): the candidate blocks that hold a change
bit, in block order, their (block id, mask lo, mask hi) rows, and their
cells in bit order as flat cell ids or as the words flow's sparse row ids.
The CUDA source is ``csrc/block_compact.cu``; its header note gives what
it computes, its bound (bytes: bits and cand read once, the ids and rows
written once; launch latency in practice) and the design.

``compact_block_bits`` takes CUDA tensors only and launches the kernels on
the current stream; the plain version is
``ops/marching._compact_block_bits_plain``, and
``ops/marching._compact_block_bits`` sends a CPU tensor there and a CUDA
tensor here. There is no fallback from the kernel to the plain version.
``compact_block_bits.launches`` counts its calls into the library (two
kernels in the exact form, three in the capped one); when
``compact_block_bits.inputs`` is a list, each call appends its (args,
kwargs), so that a caller can hold a launch against the plain version.

The kernels are built with nvcc into ``build/kernels/`` under the
repository root at first use (``build()``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from disn_tpu_torch import kernels

BLOCK = 4  # edge of a scan block, in cells (64 change bits)


def b2cap(bcap: int) -> int:
    """Rows of the capped compaction's block buffer for a candidate-block
    cap (the JAX package's rule: half the cap, whole 256s, at least 512)."""
    return max(512, -(-(bcap // 2) // 256) * 256)


def build() -> Path:
    """Compile csrc/block_compact.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("block_compact")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.compact_tiles.argtypes = [ci]
    lib.compact_count.argtypes = [vp, vp, ci, vp, vp]
    lib.compact_write.argtypes = [vp, vp, ci, ci, ci, vp, vp, ci, vp, vp, vp]
    lib.compact_capped.argtypes = [vp, vp, ci, ci, ci, vp, ci, vp, vp, vp,
                                   vp, vp, vp]
    for fn in (lib.compact_tiles, lib.compact_count, lib.compact_write,
               lib.compact_capped):
        fn.restype = ci
    return lib


def _check(bits, cand, E, srow_tbl, bcap, guard) -> None:
    """Raise on what the kernels do not take."""
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"the compaction's kernels take CUDA tensors, got "
                         f"{dev}")
    B3 = -(-E // BLOCK)
    nb = B3 ** 3
    if bits.dtype != torch.int32 or tuple(bits.shape) != (nb, 2):
        raise ValueError(f"bits must be [{nb}, 2] int32 for E = {E}, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if cand.dtype != torch.bool or tuple(cand.shape) != (nb,):
        raise ValueError(f"cand must be [{nb}] bool, got "
                         f"{tuple(cand.shape)} {cand.dtype}")
    if nb * BLOCK ** 3 >= 2 ** 31 or E ** 3 >= 2 ** 31:
        raise ValueError(f"E = {E} is past the int32 range of the ids")
    tensors = [bits, cand]
    if srow_tbl is not None:
        c = B3 - 1
        if (c < 1 or srow_tbl.dtype != torch.int32
                or tuple(srow_tbl.shape) != (c ** 3,)):
            raise ValueError(f"srow_tbl must be [{c}^3] int32 with c >= 1, "
                             f"got {tuple(srow_tbl.shape)} {srow_tbl.dtype}")
        tensors.append(srow_tbl)
    if guard is not None:
        if (not torch.is_tensor(guard) or guard.dim() != 0
                or guard.dtype != torch.int32):
            raise TypeError(f"guard must be a 0-d int32 tensor or None, got "
                            f"{guard!r}")
        tensors.append(guard)
    if bcap is not None and bcap < 0:
        raise ValueError(f"bcap {bcap} < 0")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def compact_block_bits(bits: torch.Tensor, cand: torch.Tensor, E: int,
                       srow_tbl: torch.Tensor | None = None,
                       bcap: int | None = None, guard=None):
    """ops/marching._compact_block_bits on the card, bit for bit its plain
    version: bits [B3^3, 2] int32 (each block's 64 change bits as (lo,
    hi)), cand [B3^3] bool, B3 = ceil(E/4); srow_tbl [c^3] int32 (c = B3 -
    1) for sparse row ids. Without `bcap`: (ids [n] int32, n, blk [b, 3]
    int32), one read of the tiles' counts from the card. With bcap, b2 =
    b2cap(bcap) rows: (ids [b2*64] int32 padded with 0, n 0-d int32,
    g_over 0-d int32, blk [b2, 3] with zero rows past the kept blocks),
    nothing read back; `guard` (a 0-d int32 on the card, or None) adds to
    g_over."""
    _check(bits, cand, E, srow_tbl, bcap, guard)
    if compact_block_bits.inputs is not None:
        compact_block_bits.inputs.append(
            ((bits, cand, E), dict(srow_tbl=srow_tbl, bcap=bcap,
                                   guard=guard)))
    lib = _lib()
    dev = bits.device
    nb = bits.shape[0]
    B3 = -(-E // BLOCK)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = lib.compact_tiles(nb)
    scratch = torch.empty(3 * tiles, dtype=torch.int32, device=dev)
    srow = None if srow_tbl is None else srow_tbl.data_ptr()
    if bcap is None:
        _raise_on(lib.compact_count(bits.data_ptr(), cand.data_ptr(), nb,
                                    scratch.data_ptr(), stream),
                  "compact_count")
        counts = scratch[:2 * tiles].cpu().view(2, tiles).sum(1).tolist()
        b, n = (int(x) for x in counts)
        ids = torch.empty(n, dtype=torch.int32, device=dev)
        blk = torch.empty((b, 3), dtype=torch.int32, device=dev)
        _raise_on(lib.compact_write(bits.data_ptr(), cand.data_ptr(), nb, B3,
                                    E, srow, scratch.data_ptr(), b,
                                    ids.data_ptr(), blk.data_ptr(), stream),
                  "compact_write")
        compact_block_bits.launches += 1
        return ids, n, blk
    b2 = b2cap(bcap)
    ids = torch.empty(b2 * BLOCK ** 3, dtype=torch.int32, device=dev)
    blk = torch.empty((b2, 3), dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.int32, device=dev)
    _raise_on(lib.compact_capped(
        bits.data_ptr(), cand.data_ptr(), nb, B3, E, srow, b2,
        None if guard is None else guard.data_ptr(), scratch.data_ptr(),
        ids.data_ptr(), blk.data_ptr(), out.data_ptr(), stream),
        "compact_capped")
    compact_block_bits.launches += 1
    return ids, out[0], out[1], blk


compact_block_bits.launches = 0
compact_block_bits.inputs = None


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
