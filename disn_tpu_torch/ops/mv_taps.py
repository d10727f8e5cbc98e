"""K8, the multi-view decode's tap mean: wrapper, build, plain version and
tile plan.

Replaces the tap mean of ``disn_tpu/infer/multiview.py:111-119``
(``_mv_decode``'s folded arm, XLA code fused under jit, not a Pallas
kernel): P world points projected through each of V cameras, each view's
folded [137,137,512] map sampled bilinearly at the projection (a tap past
the image counts zero), the V samples averaged in float32 and cast to the
map's type. The CUDA source is ``csrc/mv_taps.cu``; its header note gives
the order of its arithmetic, its bound (operations: 8 FLOP a
view-channel on the FMA units), the floor its rounding sets (14.5 issue
slots a view-channel in bf16, 16 shared-memory bytes in f32: 1.40 / 1.54
ms a step of 262,144 points at V = 24) and the design.

The design stages taps in shared memory a tile at a time: a CTA owns
TILE_PTS consecutive points in the caller's order and SLICE_C channels of
each pixel (4 CTAs a tile); it projects the tile under every view into
tables, forms each view's pixel box and, when the box holds at most
STAGE_PX pixels, copies it into one of STAGES stages (a ring over the
views, two boxes landing while one is summed) with 16-byte asynchronous
copies (``cp.async``) spread over its threads; the sums read the taps from
there. A tile-view whose box does not fit reads its taps from global
memory (the direct path: scattered points, such as the coarse grid in its
natural order or the dense stream). ``tile_plan`` is the plain version of
that choice, and a ``-DMV_TRACE`` build counts both kinds
(``trace_launch``). Callers that want the staged path feed neighbouring
points together: ``core/grids.block_order`` (the coarse grid in 4^3
blocks) and ``fused_decode.cell_points`` (a cell's 64 points). The floor
above bounds what any order of these operations can reach; the kernel
reaches about half of it on a fine step (chip_smoke.py's [mv taps],
PERF.md).

``mv_tap_mean`` launches the kernel on the current stream for CUDA
tensors and takes ``mv_tap_mean_plain`` for CPU tensors; there is no
fallback from the kernel to the plain version. ``mv_tap_mean.launches``
counts its launches; when ``mv_tap_mean.events`` is a list, each launch
appends its (start, end) CUDA events, and when ``mv_tap_mean.inputs`` is
a list, its (args, kwargs), so that a caller can time a launch and hold
it against the plain version.

The kernel is built with nvcc into ``build/kernels/`` under the
repository root at first use (``build()``) and loaded with ctypes; a
``-DMV_TRACE`` build (``build(("MV_TRACE",))``, read by ``trace_launch``)
counts staged and direct tile-views.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from disn_tpu_torch import kernels
from disn_tpu_torch.core import camera
from disn_tpu_torch.ops import image as image_ops

C_FEAT = 512  # channels of a folded map
TILE_PTS = 64  # consecutive points a CTA takes (a fine cell, a 4^3 block)
SLICE_C = 128  # channels of each pixel a CTA stages (256 bytes bf16, 512 f32)
# STAGES and STAGE_PX are compiled into csrc/mv_taps.cu; bind() checks
# these against them.
STAGES = 3  # stages in the ring over the views: two land while one is summed
# pixels a stage holds: a tile-view whose box has more reads its taps from
# global memory. Every fine cell's box (at most ~36 px) fits; a CTA's 3
# stages and tables take 57,856 bytes in bf16, 94,720 in f32 (two CTAs
# an SM)
STAGE_PX = 48


def build(defines: tuple[str, ...] = ()) -> Path:
    """Compile csrc/mv_taps.cu with `defines` (once per source hash and
    flags) and return the library's path; the compiler's report is
    ``<lib>.log`` beside it."""
    return kernels.nvcc_build("mv_taps", defines)


def bind(path) -> ctypes.CDLL:
    """The library at `path` with its entries' argument types; raises if
    its compiled tile, slice and stages are not this module's."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mv_taps_launch.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.mv_taps_launch.restype = ci
    if hasattr(lib, "mv_taps_trace"):
        lib.mv_taps_trace.argtypes = [vp, ci]
        lib.mv_taps_trace.restype = ci
    cfg = (ctypes.c_int * 4)()
    lib.mv_taps_config(cfg)
    if tuple(cfg) != (TILE_PTS, SLICE_C, STAGES, STAGE_PX):
        raise RuntimeError(f"{Path(path).name} tiles {cfg[0]} points and "
                           f"{cfg[1]} channels a pixel in {cfg[2]} stages of "
                           f"{cfg[3]} px; ops/mv_taps expects {TILE_PTS}, "
                           f"{SLICE_C}, {STAGES} and {STAGE_PX}")
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build())


def mv_tap_mean_plain(merged: torch.Tensor, trans_mats: torch.Tensor,
                      pts: torch.Tensor, *, img_w: int = 137,
                      img_h: int = 137) -> torch.Tensor:
    """The tap mean in PyTorch ops, in the kernel's order: the points
    through each camera (core/camera.project_points), each view's map
    sampled by ops/image.resampler in float32, the samples summed view by
    view, divided by V and cast to merged's type. The divide takes V as a
    0-d tensor on the samples' device: on CUDA a Python float divisor
    becomes a multiply by its reciprocal, which is not the kernel's IEEE
    divide. merged [V,H,W,C], trans_mats [V,4,3], pts [P,3] -> [P,C]."""
    v = merged.shape[0]
    px = camera.project_points(pts[None].expand(v, -1, -1), trans_mats,
                               img_w=img_w, img_h=img_h)
    acc = image_ops.resampler(merged[:1], px[:1])[0]
    for i in range(1, v):
        acc = acc + image_ops.resampler(merged[i:i + 1], px[i:i + 1])[0]
    return (acc / torch.tensor(float(v), device=acc.device)).to(merged.dtype)


def tile_plan(trans_mats: torch.Tensor, pts: torch.Tensor, *,
              img_w: int = 137, img_h: int = 137, tile: int = TILE_PTS,
              stage_px: int = STAGE_PX) -> torch.Tensor:
    """Which tile-views the kernel stages: [V, ceil(P / tile)] bool, True
    where the tile's pixel box under view v holds at most stage_px pixels.
    The box spans the tile's base taps (floor of the projection, NaN read
    as pixel 0) to their x0 + 1 and y0 + 1 taps, clamped to the image; a
    partial last tile spans its points alone. trans_mats [V,4,3], pts
    [P,3]; on any device."""
    v, n = trans_mats.shape[0], pts.shape[0]
    px = camera.project_points(pts[None].expand(v, -1, -1), trans_mats,
                               img_w=img_w, img_h=img_h)
    x0 = torch.nan_to_num(torch.floor(px[..., 0])).long()
    y0 = torch.nan_to_num(torch.floor(px[..., 1])).long()
    x1 = torch.where(x0 + 1 <= img_w - 1, x0 + 1, x0)
    y1 = torch.where(y0 + 1 <= img_h - 1, y0 + 1, y0)
    pad = -n % tile

    def box(lo, hi):
        lo = torch.nn.functional.pad(lo, (0, pad), value=1 << 30)
        hi = torch.nn.functional.pad(hi, (0, pad), value=-1)
        return (hi.view(v, -1, tile).amax(2) - lo.view(v, -1, tile).amin(2)
                + 1)

    return box(x0, x1) * box(y0, y1) <= stage_px


def _check(merged, trans_mats, pts, img_w, img_h) -> None:
    """Raise on what the kernel does not take."""
    if merged.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"merged must be float32 or bfloat16, got "
                        f"{merged.dtype}")
    if (merged.dim() != 4 or merged.shape[0] < 1
            or tuple(merged.shape[1:]) != (img_h, img_w, C_FEAT)):
        raise ValueError(f"merged must be [V,{img_h},{img_w},{C_FEAT}], got "
                         f"{tuple(merged.shape)}")
    v = merged.shape[0]
    if (tuple(trans_mats.shape) != (v, 4, 3)
            or trans_mats.dtype != torch.float32):
        raise ValueError(f"trans_mats must be [{v},4,3] float32, got "
                         f"{tuple(trans_mats.shape)} {trans_mats.dtype}")
    if pts.dim() != 2 or pts.shape[1] != 3 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be [P,3] float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    if pts.shape[0] >= 2 ** 31:
        raise ValueError(f"{pts.shape[0]} points are past the kernel's "
                         f"int32 point index")
    for t in (merged, trans_mats, pts):
        if t.device != merged.device:
            raise ValueError(f"all inputs must be on {merged.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    # the kernel reads the maps in 16-byte vectors
    if merged.device.type == "cuda" and merged.data_ptr() % 16:
        raise ValueError("merged must be 16-byte aligned")


def launch(lib, merged, trans_mats, pts, out, img_w: int,
           img_h: int) -> int:
    """One launch of `lib`'s kernel on the current stream over checked
    CUDA inputs into `out`; returns the CUDA error code."""
    return lib.mv_taps_launch(
        int(merged.dtype == torch.bfloat16), merged.data_ptr(),
        trans_mats.data_ptr(), pts.data_ptr(), out.data_ptr(),
        pts.shape[0], merged.shape[0], img_w, img_h,
        torch.cuda.current_stream(merged.device).cuda_stream)


def trace_launch(lib, merged, trans_mats, pts, *, img_w: int = 137,
                 img_h: int = 137) -> list[int]:
    """One launch of `lib`, a -DMV_TRACE build, over pts on the card,
    synchronised: its six counts (staged and direct tile-views, one a tile
    and view; then thread 0's clocks waiting for a stage, in all, forming
    the tables and boxes and issuing copies, each summed over the CTAs)."""
    _check(merged, trans_mats, pts, img_w, img_h)
    buf = (ctypes.c_ulonglong * 6)()
    torch.cuda.synchronize(merged.device)
    lib.mv_taps_trace(buf, 1)
    out = torch.empty(pts.shape[0], C_FEAT, dtype=merged.dtype,
                      device=merged.device)
    err = launch(lib, merged, trans_mats, pts, out, img_w, img_h)
    if err:
        raise RuntimeError(f"mv_taps launch failed: CUDA error {err}")
    torch.cuda.synchronize(merged.device)
    lib.mv_taps_trace(buf, 1)
    return [int(b) for b in buf]


def mv_tap_mean(merged: torch.Tensor, trans_mats: torch.Tensor,
                pts: torch.Tensor, *, img_w: int = 137,
                img_h: int = 137) -> torch.Tensor:
    """For each of the P points, the mean over the V views of the bilinear
    sample of each view's folded map at the point's projection, in float32,
    cast to merged's type: merged [V,img_h,img_w,512] f32|bf16, trans_mats
    [V,4,3] f32, pts [P,3] f32 -> [P,512]. CUDA tensors launch K8 on the
    current stream (one launch; nothing read back); CPU tensors take
    mv_tap_mean_plain."""
    _check(merged, trans_mats, pts, img_w, img_h)
    if merged.device.type == "cpu":
        return mv_tap_mean_plain(merged, trans_mats, pts, img_w=img_w,
                                 img_h=img_h)
    if merged.device.type != "cuda":
        raise ValueError(f"unsupported device {merged.device}")
    n = pts.shape[0]
    out = torch.empty((n, C_FEAT), dtype=merged.dtype, device=merged.device)
    if n == 0:
        return out
    if mv_tap_mean.inputs is not None:
        mv_tap_mean.inputs.append(((merged, trans_mats, pts),
                                   dict(img_w=img_w, img_h=img_h)))
    cur = torch.cuda.current_stream(merged.device)
    timed = mv_tap_mean.events is not None
    if timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(cur)
    err = launch(_lib(), merged, trans_mats, pts, out, img_w, img_h)
    if err != 0:
        raise RuntimeError(f"mv_taps kernel launch failed: CUDA error {err}")
    if timed:
        end.record(cur)
        mv_tap_mean.events.append((start, end))
    mv_tap_mean.launches += 1
    return out


mv_tap_mean.launches = 0
mv_tap_mean.events = None
mv_tap_mean.inputs = None
