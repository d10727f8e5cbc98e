"""TF1-exact image resampling ops (port of disn_tpu/ops/image.py).

* ``resize_bilinear``: ``tf.image.resize_bilinear`` with the TF1 defaults
  (align_corners=False, half_pixel_centers=False) — the LEGACY mapping
  ``src = dst * (in/out)``, as two dense float32 matmuls with static 2-sparse
  interpolation matrices.
* ``resampler``: ``tf.contrib.resampler.resampler`` — bilinear gather at
  continuous (x, y) pixel coordinates, zero outside the image.

Maps are NHWC, as in the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def widen(t: torch.Tensor) -> torch.Tensor:
    """float64 stays float64; every other type becomes float32."""
    return t if t.dtype == torch.float64 else t.float()


@functools.lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] TF1-legacy bilinear interpolation matrix: src = dst*in/out,
    lower = floor(src), upper = min(lower+1, in-1)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        src = o * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        t = src - lo
        w[o, lo] += 1.0 - t
        w[o, hi] += t
    return w


@functools.lru_cache(maxsize=64)
def _interp_tensor(out_size: int, in_size: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """_interp_matrix on `device`, made once: a copy from pageable host
    memory to a card waits for the card's stream to drain, which, once per
    resize, left the card idle while the host caught up."""
    return torch.from_numpy(_interp_matrix(out_size, in_size)).to(device,
                                                                  dtype)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """[B,H,W,C] -> [B,out_h,out_w,C]. Interpolates in float32 (float64 for
    a float64 map) and casts back to the input type. On a GPU the caller
    keeps TF32 off (torch.backends.cuda.matmul.allow_tf32, False by
    default) for f32 maps."""
    _, h, w, _ = img.shape
    if (h, w) == (out_h, out_w):
        return img
    x = widen(img)
    wh = _interp_tensor(out_h, h, x.device, x.dtype)
    ww = _interp_tensor(out_w, w, x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", wh, x)
    x = torch.einsum("pw,bhwc->bhpc", ww, x)
    return x.to(img.dtype)


def resampler(data: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample data [B,H,W,C] at coords [B,N,2] (x, y) -> [B,N,C].

    (0,0) is the corner pixel; taps outside [0, W-1] x [0, H-1] contribute
    zero. The result is float32 (the JAX version promotes a bf16 map against
    its f32 tap weights the same way), float64 for a float64 map."""
    b, h, w, c = data.shape
    x, y = coords[..., 0].float(), coords[..., 1].float()
    x0f, y0f = torch.floor(x), torch.floor(y)
    tx = (x - x0f)[..., None]
    ty = (y - y0f)[..., None]
    x0 = torch.nan_to_num(x0f).long()
    y0 = torch.nan_to_num(y0f).long()
    flat = data.reshape(b, h * w, c)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return widen(vals) * valid[..., None]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty
