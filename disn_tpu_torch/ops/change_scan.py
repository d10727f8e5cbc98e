"""K2s, the volume flow's candidate scan: wrapper and build.

Replaces ``disn_tpu/ops/marching.py::_sign_change_cells`` with the bit
packing and candidate flags of ``_active_cells_from_coarse`` and the full
scan of ``_active_cells_ext`` (XLA code the JAX package wrote for the
TPU): over an [R,R,R] f32 volume, each 4^3 block's 64 sign-change bits,
the candidate blocks (the coarse cells of a list and the ghost blocks
that copy them, or every block) and the change counts. The CUDA source is
``csrc/change_scan.cu``; its header note gives what it computes, its bound
(bytes: the volume read once) and the design.

``change_scan`` takes CUDA tensors only and launches on the current
stream: one memset and the scan kernel, with the marking kernel before it
in the coarse form; nothing is read back. The plain version is
``ops/marching._candidate_scan_plain``, and ``ops/marching._candidate_scan``
sends a CPU tensor there and a CUDA tensor here. There is no fallback
from the kernel to the plain version. ``change_scan.launches`` counts its
calls; when ``change_scan.inputs`` is a list, each call appends its
(args, kwargs), so that a caller can hold a launch against the plain
version.

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


def build() -> Path:
    """Compile csrc/change_scan.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("change_scan")


def bind(path) -> ctypes.CDLL:
    """The library at `path` with its entry's argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.change_scan.argtypes = [vp, ci, ctypes.c_float, vp, ci, vp, ci, vp,
                                vp, vp, vp]
    lib.change_scan.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build())


def _check(volume, coarse_ids, count) -> None:
    """Raise on what the kernels do not take."""
    idx = volume.get_device()
    if idx < 0:
        raise ValueError(f"the candidate scan's kernel takes CUDA tensors, "
                         f"got {volume.device}")
    R = volume.shape[0]
    if (volume.dtype != torch.float32 or volume.dim() != 3
            or tuple(volume.shape) != (R, R, R) or R < 2):
        raise ValueError(f"volume must be [R,R,R] float32 with R >= 2, got "
                         f"{tuple(volume.shape)} {volume.dtype}")
    if R ** 3 >= 2 ** 31:
        raise ValueError(f"R = {R} is past the int32 range of the cells")
    tensors = [volume]
    if coarse_ids is not None:
        if (R - 1) // BLOCK < 1:
            raise ValueError(f"R = {R} has no coarse cell of {BLOCK}^3")
        if coarse_ids.dtype != torch.int32 or coarse_ids.dim() != 1:
            raise ValueError(f"coarse_ids must be [n] int32, got "
                             f"{tuple(coarse_ids.shape)} {coarse_ids.dtype}")
        tensors.append(coarse_ids)
    elif count is not None:
        raise ValueError("count needs coarse_ids")
    if count is not None:
        if (not torch.is_tensor(count) or count.dim() != 0
                or count.dtype != torch.int32):
            raise TypeError(f"count must be a 0-d int32 tensor or None, got "
                            f"{count!r}")
        tensors.append(count)
    for t in tensors:
        if t.get_device() != idx:
            raise ValueError(f"all inputs must be on {volume.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def change_scan(volume: torch.Tensor, iso: float,
                coarse_ids: torch.Tensor | None = None,
                count: torch.Tensor | None = None):
    """ops/marching._candidate_scan on the card, bit for bit its plain
    version: volume [R,R,R] f32; coarse_ids [n] int32 over the (B3 - 1)^3
    coarse grid (B3 = ceil(R/4)), the first `count` of them (a 0-d int32
    on the card) or all of them the candidates; None: every block. ->
    (bits [B3^3, 2] int32, cand [B3^3] bool, counts [3] int32 (total,
    inside, outside)), views of one allocation, nothing read back."""
    _check(volume, coarse_ids, count)
    if change_scan.inputs is not None:
        change_scan.inputs.append(((volume, iso),
                                   dict(coarse_ids=coarse_ids, count=count)))
    lib = _lib()
    R = volume.shape[0]
    nb = (-(-R // BLOCK)) ** 3
    # bits, the counts (and a pad word), then the flags: the memset
    # zeroes the counts and the flags together
    buf = torch.empty(2 * nb + 4 + -(-nb // 4), dtype=torch.int32,
                      device=volume.device)
    bits = buf[:2 * nb].view(nb, 2)
    counts = buf[2 * nb:2 * nb + 3]
    cand = buf[2 * nb + 4:].view(torch.uint8)[:nb].view(torch.bool)
    every = coarse_ids is None
    stream = torch._C._cuda_getCurrentRawStream(volume.get_device())
    err = lib.change_scan(
        volume.data_ptr(), R, float(iso),
        None if every else coarse_ids.data_ptr(),
        0 if every else coarse_ids.shape[0],
        None if count is None else count.data_ptr(), int(every),
        bits.data_ptr(), counts.data_ptr(), cand.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"change_scan failed: CUDA error {err}")
    change_scan.launches += 1
    return bits, cand, counts


change_scan.launches = 0
change_scan.inputs = None
