"""K4, the band cull of the coarse grid: wrappers and build.

Replaces ``disn_tpu/infer/sparse.py::_band_tau`` and ``::_active_cells``
(XLA code the JAX package wrote for the TPU): the cull band's tau, and the
coarse cells that may hold the surface, ascending, with their count. The
CUDA source is ``csrc/band_cull.cu``; its header note gives what it
computes, its bound (bytes: the grid read once, the ids written once;
launch latency in practice) and the design.

``band_tau`` and ``active_cells`` take CUDA tensors only and launch the
kernels on the current stream; the plain versions are
``infer/sparse._band_tau_plain`` and ``_active_cells_plain``, and
``infer/sparse._band_tau`` / ``_active_cells`` send a CPU tensor there and
a CUDA tensor here. There is no fallback from a kernel to a plain version.
Each wrapper's ``launches`` counts its calls into the library (one or
three kernels for ``band_tau``, two for ``active_cells``).

The kernels are built with nvcc into ``build/kernels/`` under the
repository root at first use (``build()``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from disn_tpu_torch import kernels


def build() -> Path:
    """Compile csrc/band_cull.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("band_cull")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.band_tau_scratch.argtypes = []
    lib.band_tau_step.argtypes = [vp, ci, vp, cf, ci, vp, vp, vp]
    lib.cull_tiles.argtypes = [ci]
    lib.active_cells_step.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp, vp,
                                      vp]
    for fn in (lib.band_tau_scratch, lib.band_tau_step, lib.cull_tiles,
               lib.active_cells_step):
        fn.restype = ci
    return lib


def _check_grid(vol_c: torch.Tensor) -> int:
    """Raise on a grid the kernels do not take; returns rc."""
    if vol_c.device.type != "cuda":
        raise ValueError(f"the band cull's kernels take CUDA tensors, got "
                         f"{vol_c.device}")
    if vol_c.dtype != torch.float32:
        raise TypeError(f"vol_c must be float32, got {vol_c.dtype}")
    rc = vol_c.shape[0]
    if vol_c.dim() != 3 or tuple(vol_c.shape) != (rc,) * 3 or rc < 2:
        raise ValueError(f"vol_c must be [rc, rc, rc] with rc >= 2, got "
                         f"{tuple(vol_c.shape)}")
    if rc ** 3 >= 2 ** 31:
        raise ValueError(f"vol_c of {rc}^3 points is past the int32 range")
    if not vol_c.is_contiguous():
        raise ValueError("vol_c must be contiguous")
    return rc


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def band_tau(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
             band_factor: float, autocal: bool) -> torch.Tensor:
    """tau as a 0-d float32 on the grid's card: band_factor x the coarse
    cell diagonal of the box sdf_params [6] float32 (x0, y0, z0, x1, y1,
    z1), times max(1, the near-band slope) when `autocal`; see
    infer/sparse._band_tau_plain, which it equals bit for bit."""
    if _check_grid(vol_c) != rc:
        raise ValueError(f"rc {rc} is not the grid's {vol_c.shape[0]}")
    if (sdf_params.dtype != torch.float32
            or tuple(sdf_params.shape) != (6,)
            or sdf_params.device != vol_c.device
            or not sdf_params.is_contiguous()):
        raise ValueError(f"sdf_params must be a contiguous [6] float32 on "
                         f"{vol_c.device}, got {tuple(sdf_params.shape)} "
                         f"{sdf_params.dtype} on {sdf_params.device}")
    lib = _lib()
    dev = vol_c.device
    scratch = torch.empty(lib.band_tau_scratch(), dtype=torch.float32,
                          device=dev)
    tau = torch.empty(1, dtype=torch.float32, device=dev)
    _raise_on(lib.band_tau_step(
        vol_c.data_ptr(), rc, sdf_params.data_ptr(), float(band_factor),
        int(bool(autocal)), scratch.data_ptr(), tau.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "band_tau_step")
    band_tau.launches += 1
    return tau[0]


band_tau.launches = 0


def active_cells(vol_c: torch.Tensor, tau: torch.Tensor | None,
                 mode: str = "band", max_cells: int | None = None):
    """The cells of the grid vol_c [rc]^3 float32 that may hold the surface
    (mode 'band': a corner |v| < tau, a 0-d float32 on the grid's card, or
    corner signs that disagree; mode 'sign': a sign change among the 27
    cells around, tau not read), as infer/sparse._active_cells_plain gives
    them, bit for bit: (ids [count] int32 ascending, count) with one read
    of the count from the card, or, with `max_cells`, (ids [max_cells]
    int32 padded with 0, count 0-d int32 on the card) with nothing read
    back."""
    c = _check_grid(vol_c) - 1
    if mode not in ("band", "sign"):
        raise ValueError(f"mode must be 'band' or 'sign', got {mode!r}")
    dev = vol_c.device
    if mode == "band" and not (torch.is_tensor(tau) and tau.dim() == 0
                               and tau.dtype == torch.float32
                               and tau.device == dev):
        raise ValueError(f"tau must be a 0-d float32 on {dev}, got "
                         + (f"{tuple(tau.shape)} {tau.dtype} on {tau.device}"
                            if torch.is_tensor(tau) else repr(tau)))
    n_cells = c ** 3
    if max_cells is not None and max_cells < 0:
        raise ValueError(f"max_cells {max_cells} < 0")
    lib = _lib()
    cap = n_cells if max_cells is None else max_cells
    tiles = torch.empty(lib.cull_tiles(c), dtype=torch.int32, device=dev)
    ids = torch.empty(cap, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    _raise_on(lib.active_cells_step(
        vol_c.data_ptr(), c, int(mode == "sign"),
        tau.data_ptr() if mode == "band" else None, cap,
        int(max_cells is not None), tiles.data_ptr(), ids.data_ptr(),
        count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "active_cells_step")
    active_cells.launches += 1
    if max_cells is not None:
        return ids, count[0]
    n = int(count)
    return ids[:n], n


active_cells.launches = 0
