"""K8, the multi-view decode's tap mean: wrapper, build and plain version.

Replaces the tap mean of ``disn_tpu/infer/multiview.py:111-119``
(``_mv_decode``'s folded arm, XLA code fused under jit, not a Pallas
kernel): P world points projected through each of V cameras, each view's
folded [137,137,512] map sampled bilinearly at the projection (a tap past
the image counts zero), the V samples averaged in float32 and cast to the
map's type. The CUDA source is ``csrc/mv_taps.cu``; its header note gives
the order of its arithmetic, its bound (operations: 8 FLOP a
view-channel on the FMA units) and the design.

``mv_tap_mean`` launches the kernel on the current stream for CUDA
tensors and takes ``mv_tap_mean_plain`` for CPU tensors; there is no
fallback from the kernel to the plain version. ``mv_tap_mean.launches``
counts its launches; when ``mv_tap_mean.events`` is a list, each launch
appends its (start, end) CUDA events, and when ``mv_tap_mean.inputs`` is
a list, its (args, kwargs), so that a caller can time a launch and hold
it against the plain version.

The kernel is built with nvcc into ``build/kernels/`` under the
repository root at first use (``build()``) and loaded with ctypes.
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


def build() -> Path:
    """Compile csrc/mv_taps.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("mv_taps")


def bind(path) -> ctypes.CDLL:
    """The library at `path` with its entry's argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mv_taps_launch.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.mv_taps_launch.restype = ci
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
    err = _lib().mv_taps_launch(
        int(merged.dtype == torch.bfloat16), merged.data_ptr(),
        trans_mats.data_ptr(), pts.data_ptr(), out.data_ptr(), n,
        merged.shape[0], img_w, img_h, cur.cuda_stream)
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
