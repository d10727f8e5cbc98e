"""K5, the sparse record words: wrapper, build and plain version.

Replaces ``disn_tpu/ops/marching.py::_sparse_cell_words`` (XLA code the JAX
package wrote for the TPU): from the fine pass's rows of the active coarse
cells, the record words and change bits of every active 4^3 block, so that
the sparse-words flow never builds the [R^3] volume. The CUDA source is
``csrc/sparse_words.cu``; its header note gives what it computes, its bound
(bytes: the rows read once, the words written once) and the design.

``sparse_cell_words`` runs the whole step on the card for CUDA tensors
and the plain version, ``ops/marching._sparse_cell_words``, only for CPU
tensors; there is no fallback from the kernel to the plain version. On the
card the wrapper allocates the outputs and makes one call into the library
(``sparse_words_step``: the own-slot table, guard terms (1) and (2), the
zeroing of bits and cand, and the words), with no PyTorch op on the device.
The count of valid cells is an int, checked on the host, or a 0-d int32
tensor on the card, which the kernels read there (clamped to the cells
given), so that the step can be queued before the count is known.
``sparse_cell_words.launches`` counts those calls; when
``sparse_cell_words.events`` is a list, each call appends a (start, end)
pair of CUDA events recorded around the step, and when
``sparse_cell_words.inputs`` is a list, each call appends its (args,
kwargs), so that a caller can hold a launch against the plain version.

The kernel is built with nvcc into ``build/kernels/`` under the repository
root at first use (``build()``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from disn_tpu_torch import kernels
from disn_tpu_torch.ops import marching


def build() -> Path:
    """Compile csrc/sparse_words.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("sparse_words")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    # the kernel hard-codes the owned edges' far corners as corners 1..7
    pair_j = marching._owned_tables()[1]
    if pair_j.tolist() != list(range(1, 8)):
        raise AssertionError(f"owned edge order changed: {pair_j}")
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sparse_words_step.argtypes = [vp, vp, ci, ci, vp, vp, ci,
                                      ctypes.c_float, ci, vp, vp, vp, vp, vp,
                                      vp]
    lib.sparse_words_step.restype = ci
    return lib


def _check(rows, cell_ids, count, vol_c, R) -> int:
    """Raise on what the kernel does not take; returns c = (R - 1) / 4."""
    c = (R - 1) // marching.BLOCK
    if R - 1 != marching.BLOCK * c or c < 1:
        raise ValueError(f"R - 1 ({R - 1}) must be a positive multiple of "
                         f"{marching.BLOCK}")
    if rows.dtype != torch.float32 or vol_c.dtype != torch.float32:
        raise TypeError(f"rows and vol_c must be float32, got {rows.dtype} "
                        f"and {vol_c.dtype}")
    if cell_ids.dtype != torch.int32:
        raise TypeError(f"cell_ids must be int32, got {cell_ids.dtype}")
    nk = cell_ids.shape[0]
    if cell_ids.dim() != 1 or tuple(rows.shape) != (nk * marching.LANES,):
        raise ValueError(f"want cell_ids [nk] and rows [nk*64], got "
                         f"{tuple(cell_ids.shape)} and {tuple(rows.shape)}")
    if tuple(vol_c.shape) != (c + 1,) * 3:
        raise ValueError(f"vol_c must be [{c + 1}]^3, got "
                         f"{tuple(vol_c.shape)}")
    if torch.is_tensor(count):
        if count.dim() != 0 or count.dtype != torch.int32:
            raise TypeError(f"a count tensor must be 0-d int32, got "
                            f"{tuple(count.shape)} {count.dtype}")
    elif not 0 <= count <= nk:
        raise ValueError(f"count {count} outside [0, {nk}]")
    for t in (rows, cell_ids, vol_c) + ((count,) if torch.is_tensor(count)
                                        else ()):
        if t.device != rows.device:
            raise ValueError(f"all inputs must be on {rows.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return c


def sparse_cell_words(rows: torch.Tensor, cell_ids: torch.Tensor, count,
                      vol_c: torch.Tensor, *, R: int, iso: float):
    """K5: (words [2|4, NK*64] int32, bits [B3^3, 2] int32, cand [B3^3]
    bool, own_tbl [c^3] int32, guard int32 0-d) of the fine pass's rows
    [NK*64] f32 of cells cell_ids [NK] int32 (the first `count` valid: an
    int in [0, NK], or a 0-d int32 tensor on their device, clamped to [0,
    NK] where it is read) over the coarse grid vol_c [c+1]^3 f32 of an R^3
    volume; see marching._sparse_cell_words. CUDA tensors launch the
    kernel on the current stream; CPU tensors take the plain version."""
    c = _check(rows, cell_ids, count, vol_c, R)
    if rows.device.type == "cpu":
        return marching._sparse_cell_words(rows, cell_ids, count, vol_c, R,
                                           iso)
    dev = rows.device
    nk = cell_ids.shape[0]
    nw = 2 if marching._tq_bits(R) == 8 else 4
    words = torch.empty((nw, nk * marching.LANES), dtype=torch.int32,
                        device=dev)
    bits = torch.empty(((c + 1) ** 3, 2), dtype=torch.int32, device=dev)
    cand = torch.empty((c + 1) ** 3, dtype=torch.bool, device=dev)  # 1 B
    own_tbl = torch.empty(c ** 3, dtype=torch.int32, device=dev)
    guard = torch.empty(1, dtype=torch.int32, device=dev)
    if sparse_cell_words.inputs is not None:
        sparse_cell_words.inputs.append(((rows, cell_ids, count, vol_c),
                                         dict(R=R, iso=iso)))
    lib = _lib()
    cur = torch.cuda.current_stream(dev)
    timed = sparse_cell_words.events is not None
    if timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(cur)
    on_card = torch.is_tensor(count)
    err = lib.sparse_words_step(
        rows.data_ptr(), cell_ids.data_ptr(), nk, 0 if on_card else count,
        count.data_ptr() if on_card else None, vol_c.data_ptr(), c,
        float(iso), int(nw == 2), words.data_ptr(), bits.data_ptr(),
        cand.data_ptr(), own_tbl.data_ptr(), guard.data_ptr(),
        cur.cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_words step failed: CUDA error {err}")
    if timed:
        end.record(cur)
        sparse_cell_words.events.append((start, end))
    sparse_cell_words.launches += 1
    return words, bits, cand, own_tbl, guard[0]


sparse_cell_words.launches = 0
sparse_cell_words.events = None
sparse_cell_words.inputs = None
