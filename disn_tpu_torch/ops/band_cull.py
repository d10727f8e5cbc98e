"""K4, the band cull of the coarse grid: wrappers and build.

Replaces ``disn_tpu/infer/sparse.py::_band_tau`` and ``::_active_cells``
(XLA code the JAX package wrote for the TPU): the cull band's tau, and the
coarse cells that may hold the surface, ascending, with their count. The
CUDA source is ``csrc/band_cull.cu``, one kernel launched as one
thread-block cluster; its header note gives what it computes, its bound
(bytes: the grid read once, the ids written once; launch latency and one
cluster's few SMs in practice) and the design.

Three entries launch it, each once a call, on the current stream:
``band_cull`` (tau and the cull with it: phase_a's), ``band_tau`` (tau
alone) and ``active_cells`` (the cull alone, tau read on the card). They
take CUDA tensors only; the plain versions are
``infer/sparse._band_tau_plain`` and ``_active_cells_plain``, and
``infer/sparse._band_cull`` / ``_band_tau`` / ``_active_cells`` send a CPU
tensor there and a CUDA tensor here. There is no fallback from the kernel
to a plain version. Each entry's ``launches`` counts its launches.

The cluster takes ``CTAS`` CTAs of 1,024 threads (16 needs the non-portable
cluster size; 8 is the portable one). Each round, every CTA takes a slab
of ``cull_plan(rc, CTAS)`` cell planes, in row-major order (``cull_slabs``).

The kernel is built with nvcc into ``build/kernels/`` under the repository
root at first use (``build()``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from disn_tpu_torch import kernels

CTAS = 16   # CTAs of the cluster
ZMAX = 64   # cell planes a CTA takes in a round, at most (csrc: ZMAX)
# the kernel's flags (csrc/band_cull.cu: Flags)
TAU, AUTOCAL, CULL, SIGN, TAU_IN, ZERO_TAIL = 1, 2, 4, 8, 16, 32


def build() -> Path:
    """Compile csrc/band_cull.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("band_cull")


def bind(path) -> ctypes.CDLL:
    """The library at `path` with its entry's argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.band_cull_launch.argtypes = [vp, ci, vp, cf, ci, vp, vp, ci, vp, vp,
                                     ci, ci, ctypes.POINTER(ci), vp]
    lib.band_cull_launch.restype = ci
    lib.band_cull_zmax.argtypes = []
    lib.band_cull_zmax.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = bind(build())
    if lib.band_cull_zmax() != ZMAX:
        raise RuntimeError(f"band_cull.cu's ZMAX {lib.band_cull_zmax()} is "
                           f"not the wrapper's {ZMAX}")
    return lib


@functools.lru_cache(maxsize=None)
def cull_plan(rc: int, ctas: int) -> int:
    """Cell planes a CTA takes in a round: the c = rc - 1 planes spread
    over the cluster's CTAs in one round where ZMAX allows it."""
    return max(1, min(ZMAX, -(-(rc - 1) // ctas)))


def cull_slabs(rc: int, ctas: int) -> list[tuple[int, int, int, int]]:
    """(round, CTA, first plane, end plane) of every slab the kernel walks,
    in its order: round r's CTA j takes planes [(r ctas + j) zr, + zr)
    (clipped to c), so the slabs run in row-major order."""
    c, zr = rc - 1, cull_plan(rc, ctas)
    rounds = -(-c // (ctas * zr))
    return [(r, j, min((r * ctas + j) * zr, c), min((r * ctas + j + 1) * zr,
                                                   c))
            for r in range(rounds) for j in range(ctas)]


def _check_grid(vol_c: torch.Tensor) -> int:
    """Raise on a grid the kernel does not take; returns rc."""
    if vol_c.get_device() < 0:
        raise ValueError(f"the band cull's kernel takes CUDA tensors, got "
                         f"{vol_c.device}")
    if vol_c.dtype != torch.float32:
        raise TypeError(f"vol_c must be float32, got {vol_c.dtype}")
    shape = vol_c.shape
    rc = shape[0]
    if len(shape) != 3 or shape[1] != rc or shape[2] != rc or rc < 2:
        raise ValueError(f"vol_c must be [rc, rc, rc] with rc >= 2, got "
                         f"{tuple(shape)}")
    if rc ** 3 >= 2 ** 31:
        raise ValueError(f"vol_c of {rc}^3 points is past the int32 range")
    if not vol_c.is_contiguous():
        raise ValueError("vol_c must be contiguous")
    return rc


def _check_box(sdf_params: torch.Tensor, vol_c: torch.Tensor) -> None:
    if (sdf_params.dtype != torch.float32 or sdf_params.shape != (6,)
            or sdf_params.get_device() != vol_c.get_device()
            or not sdf_params.is_contiguous()):
        raise ValueError(f"sdf_params must be a contiguous [6] float32 on "
                         f"{vol_c.device}, got {tuple(sdf_params.shape)} "
                         f"{sdf_params.dtype} on {sdf_params.device}")


def _check_mode(mode: str, max_cells: int | None) -> None:
    if mode not in ("band", "sign"):
        raise ValueError(f"mode must be 'band' or 'sign', got {mode!r}")
    if max_cells is not None and max_cells < 0:
        raise ValueError(f"max_cells {max_cells} < 0")


def _launch(vol_c, rc, flags, sp=None, band_factor=0.0, tau_in=None,
            tau_out=None, cap=0, ids=None, count=None, host_count=None):
    """One launch of the kernel; raises on its error."""
    err = _lib().band_cull_launch(
        vol_c.data_ptr(), rc, sp, band_factor, flags, tau_in, tau_out, cap,
        ids, count, cull_plan(rc, CTAS), CTAS, host_count,
        torch._C._cuda_getCurrentRawStream(vol_c.get_device()))
    if err == -1:
        raise RuntimeError(f"no cluster of {CTAS} CTAs of 1,024 threads fits "
                           f"on this card")
    if err != 0:
        raise RuntimeError(f"band_cull_launch failed: CUDA error {err}")


def _cull(vol_c, rc, flags, mode, max_cells, sp=None, band_factor=0.0,
          tau_in=None, tau_out=None):
    """The cull's outputs around one launch: (ids, count) as
    active_cells returns them."""
    c = rc - 1
    if mode == "sign":
        flags |= SIGN
    dev = vol_c.device
    if max_cells is None:  # the count read back once, ids sized for all
        ids = torch.empty(c ** 3, dtype=torch.int32, device=dev)
        n = ctypes.c_int()
        _launch(vol_c, rc, flags, sp, band_factor, tau_in, tau_out, c ** 3,
                ids.data_ptr(), None, ctypes.byref(n))
        return ids[:n.value], n.value
    out = torch.empty(max_cells + 1, dtype=torch.int32, device=dev)
    _launch(vol_c, rc, flags | ZERO_TAIL, sp, band_factor, tau_in, tau_out,
            max_cells, out.data_ptr(), out.data_ptr() + 4 * max_cells)
    return out[:max_cells], out[max_cells]


def band_cull(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
              band_factor: float, autocal: bool, mode: str = "band",
              max_cells: int | None = None):
    """tau and the cull with it in one launch: (tau, ids, count), tau as
    band_tau gives it and (ids, count) as active_cells gives them for that
    tau (mode 'sign' computes tau and does not read it); bit for bit
    infer/sparse._band_tau_plain then _active_cells_plain."""
    if _check_grid(vol_c) != rc:
        raise ValueError(f"rc {rc} is not the grid's {vol_c.shape[0]}")
    _check_box(sdf_params, vol_c)
    _check_mode(mode, max_cells)
    tau = torch.empty((), dtype=torch.float32, device=vol_c.device)
    flags = TAU | CULL | (AUTOCAL if autocal else 0)
    ids, count = _cull(vol_c, rc, flags, mode, max_cells,
                       sdf_params.data_ptr(), float(band_factor),
                       tau_out=tau.data_ptr())
    band_cull.launches += 1
    return tau, ids, count


band_cull.launches = 0


def band_tau(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
             band_factor: float, autocal: bool) -> torch.Tensor:
    """tau as a 0-d float32 on the grid's card: band_factor x the coarse
    cell diagonal of the box sdf_params [6] float32 (x0, y0, z0, x1, y1,
    z1), times max(1, the near-band slope) when `autocal`; see
    infer/sparse._band_tau_plain, which it equals bit for bit."""
    if _check_grid(vol_c) != rc:
        raise ValueError(f"rc {rc} is not the grid's {vol_c.shape[0]}")
    _check_box(sdf_params, vol_c)
    tau = torch.empty((), dtype=torch.float32, device=vol_c.device)
    _launch(vol_c, rc, TAU | (AUTOCAL if autocal else 0),
            sdf_params.data_ptr(), float(band_factor), tau_out=tau.data_ptr())
    band_tau.launches += 1
    return tau


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
    rc = _check_grid(vol_c)
    _check_mode(mode, max_cells)
    dev = vol_c.device
    if mode == "band" and not (torch.is_tensor(tau) and tau.dim() == 0
                               and tau.dtype == torch.float32
                               and tau.device == dev):
        raise ValueError(f"tau must be a 0-d float32 on {dev}, got "
                         + (f"{tuple(tau.shape)} {tau.dtype} on {tau.device}"
                            if torch.is_tensor(tau) else repr(tau)))
    out = _cull(vol_c, rc, CULL | (TAU_IN if mode == "band" else 0), mode,
                max_cells, tau_in=tau.data_ptr() if mode == "band" else None)
    active_cells.launches += 1
    return out


active_cells.launches = 0
