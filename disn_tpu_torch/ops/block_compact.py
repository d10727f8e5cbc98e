"""K2c, the block compaction of both mesh flows' scans: wrapper and build.

Replaces ``disn_tpu/ops/marching.py::_compact_block_bits`` (XLA code the
JAX package wrote for the TPU): the candidate blocks that hold a change
bit, in block order, their (block id, mask lo, mask hi) rows, and their
cells in bit order as flat cell ids or as the words flow's sparse row ids.
The CUDA source is ``csrc/block_compact.cu``, one kernel launched as one
thread-block cluster; its header note gives what it computes, its bound
(bytes: bits and cand read once, the ids and rows written once; launch
latency in practice) and the design.

``compact_block_bits`` takes CUDA tensors only and launches the kernel on
the current stream: once in the capped form (nothing read back), twice in
the exact form (the count phase, whose (b, n) the host reads once to size
the outputs, then the writes). The plain version is
``ops/marching._compact_block_bits_plain``, and
``ops/marching._compact_block_bits`` sends a CPU tensor there and a CUDA
tensor here. There is no fallback from the kernel to the plain version.
``compact_block_bits.launches`` counts its calls; when
``compact_block_bits.inputs`` is a list, each call appends its (args,
kwargs), so that a caller can hold a launch against the plain version.

The cluster takes ``CTAS`` CTAs of 1,024 threads; the block rows go in
``CHUNK_ROWS``-row chunks, the chunks in units, the units dealt to the
CTAs in turn, and every CTA scans all units in row-major order
(``compact_plan``, ``compact_units``).

The kernel is built with nvcc into ``build/kernels/`` under the repository
root at first use (``build()``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from disn_tpu_torch import kernels

BLOCK = 4  # edge of a scan block, in cells (64 change bits)
CTAS = 16         # CTAs of the cluster
CHUNK_ROWS = 128  # block rows a chunk, one warp's (csrc: CHUNK)
MAX_UNITS = 2048  # units of chunks a CTA counts in shared memory


def b2cap(bcap: int) -> int:
    """Rows of the capped compaction's block buffer for a candidate-block
    cap (the JAX package's rule: half the cap, whole 256s, at least 512)."""
    return max(512, -(-(bcap // 2) // 256) * 256)


def build() -> Path:
    """Compile csrc/block_compact.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("block_compact")


def bind(path) -> ctypes.CDLL:
    """The library at `path` with its entries' argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.compact_count.argtypes = [vp, vp, ci, ci, ci, ci,
                                  ctypes.POINTER(ci), vp]
    lib.compact_write.argtypes = [vp, vp, ci, ci, ci, vp, ci, ci, ci, ci, vp,
                                  vp, vp]
    lib.compact_capped.argtypes = [vp, vp, ci, ci, ci, vp, ci, ci, ci, ci,
                                   vp, vp, vp, vp, vp]
    for fn in (lib.compact_count, lib.compact_write, lib.compact_capped,
               lib.compact_chunk_rows, lib.compact_max_units):
        fn.restype = ci
    lib.compact_chunk_rows.argtypes = lib.compact_max_units.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = bind(build())
    if (lib.compact_chunk_rows(), lib.compact_max_units()) != (CHUNK_ROWS,
                                                               MAX_UNITS):
        raise RuntimeError("block_compact.cu's CHUNK / MAX_UNITS are not "
                           "the wrapper's")
    return lib


@functools.lru_cache(maxsize=None)
def compact_plan(nb: int, ctas: int) -> tuple[int, int]:
    """(chunks of the nb block rows, chunks a unit): a CTA counts its
    units, at most MAX_UNITS of them, in shared memory."""
    chunks = -(-nb // CHUNK_ROWS)
    per_cta = -(-chunks // ctas)
    return chunks, max(1, -(-per_cta // MAX_UNITS))


def compact_units(nb: int, ctas: int) -> list[list[tuple[int, int]]]:
    """Each CTA's units as the kernel deals them, each as its chunks [c0,
    c1): global unit U (chunks [U group, (U + 1) group)) goes to CTA U %
    ctas, so that the selected blocks, which gather where the surface
    is, spread over the CTAs; the ids follow the units' global order."""
    chunks, group = compact_plan(nb, ctas)
    units = -(-chunks // group)
    return [[(u * group, min((u + 1) * group, chunks))
             for u in range(j, units, ctas)] for j in range(ctas)]


def _check(bits, cand, E, srow_tbl, bcap, guard) -> None:
    """Raise on what the kernel does not take."""
    idx = bits.get_device()
    if idx < 0:
        raise ValueError(f"the compaction's kernel takes CUDA tensors, got "
                         f"{bits.device}")
    B3 = -(-E // BLOCK)
    nb = B3 ** 3
    if bits.dtype != torch.int32 or bits.shape != (nb, 2):
        raise ValueError(f"bits must be [{nb}, 2] int32 for E = {E}, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if cand.dtype != torch.bool or cand.shape != (nb,):
        raise ValueError(f"cand must be [{nb}] bool, got "
                         f"{tuple(cand.shape)} {cand.dtype}")
    if nb * BLOCK ** 3 >= 2 ** 31 or E ** 3 >= 2 ** 31:
        raise ValueError(f"E = {E} is past the int32 range of the ids")
    tensors = [bits, cand]
    if srow_tbl is not None:
        c = B3 - 1
        if (c < 1 or srow_tbl.dtype != torch.int32
                or srow_tbl.shape != (c ** 3,)):
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
        if t.get_device() != idx:
            raise ValueError(f"all inputs must be on {bits.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def compact_block_bits(bits: torch.Tensor, cand: torch.Tensor, E: int,
                       srow_tbl: torch.Tensor | None = None,
                       bcap: int | None = None, guard=None):
    """ops/marching._compact_block_bits on the card, bit for bit its plain
    version: bits [B3^3, 2] int32 (each block's 64 change bits as (lo,
    hi)), cand [B3^3] bool, B3 = ceil(E/4); srow_tbl [c^3] int32 (c = B3 -
    1) for sparse row ids. Without `bcap`: (ids [n] int32, n, blk [b, 3]
    int32), one read of (b, n) from the card. With bcap, b2 = b2cap(bcap)
    rows: (ids [b2*64] int32 padded with 0, n 0-d int32, g_over 0-d int32,
    blk [b2, 3] with zero rows past the kept blocks), nothing read back;
    `guard` (a 0-d int32 on the card, or None) adds to g_over. The outputs
    of a call are views of one allocation."""
    _check(bits, cand, E, srow_tbl, bcap, guard)
    if compact_block_bits.inputs is not None:
        compact_block_bits.inputs.append(
            ((bits, cand, E), dict(srow_tbl=srow_tbl, bcap=bcap,
                                   guard=guard)))
    lib = _lib()
    dev = bits.device
    nb = bits.shape[0]
    B3 = -(-E // BLOCK)
    chunks, group = compact_plan(nb, CTAS)
    stream = torch._C._cuda_getCurrentRawStream(bits.get_device())
    srow = None if srow_tbl is None else srow_tbl.data_ptr()
    if bcap is None:
        bn = (ctypes.c_int * 2)()
        _raise_on(lib.compact_count(bits.data_ptr(), cand.data_ptr(), nb,
                                    chunks, group, CTAS, bn, stream),
                  "compact_count")
        b, n = bn[0], bn[1]
        out = torch.empty(n + 3 * b, dtype=torch.int32, device=dev)
        _raise_on(lib.compact_write(bits.data_ptr(), cand.data_ptr(), nb, B3,
                                    E, srow, chunks, group, CTAS, b,
                                    out.data_ptr(), out.data_ptr() + 4 * n,
                                    stream), "compact_write")
        compact_block_bits.launches += 1
        return out[:n], n, out.as_strided((b, 3), (3, 1), n)
    b2 = b2cap(bcap)
    slots = b2 * BLOCK ** 3
    out = torch.empty(slots + 3 * b2 + 2, dtype=torch.int32, device=dev)
    ptr = out.data_ptr()
    _raise_on(lib.compact_capped(
        bits.data_ptr(), cand.data_ptr(), nb, B3, E, srow, chunks, group,
        CTAS, b2, None if guard is None else guard.data_ptr(), ptr,
        ptr + 4 * slots, ptr + 4 * (slots + 3 * b2), stream),
        "compact_capped")
    compact_block_bits.launches += 1
    tail = slots + 3 * b2  # n, g_over
    return (out[:slots], out[tail], out[tail + 1],
            out.as_strided((b2, 3), (3, 1), slots))


compact_block_bits.launches = 0
compact_block_bits.inputs = None


def _raise_on(err: int, what: str) -> None:
    if err == -1:
        raise RuntimeError(f"{what}: no cluster of {CTAS} CTAs of 1,024 "
                           f"threads fits on this card")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
