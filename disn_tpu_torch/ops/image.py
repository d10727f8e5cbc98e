"""TF1-exact image resampling ops (port of disn_tpu/ops/image.py).

* ``resize_bilinear``: ``tf.image.resize_bilinear`` with the TF1 defaults
  (align_corners=False, half_pixel_centers=False) — the LEGACY mapping
  ``src = dst * (in/out)``, as two dense float32 matmuls with static 2-sparse
  interpolation matrices.
* ``resize_nearest``: ``tf.image.resize_nearest_neighbor`` (legacy
  coords), for alpha channels.
* ``resampler``: ``tf.contrib.resampler.resampler`` — bilinear gather at
  continuous (x, y) pixel coordinates, zero outside the image;
  ``resampler_clamped`` the same with edge-clamped taps.
* ``sample_native`` and ``resize_then_sample``: the two per-scale
  local-feature samplers (Config.sampling 'native' and 'tf1').

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


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int
                   ) -> torch.Tensor:
    """TF1 tf.image.resize_nearest_neighbor (legacy coords): src =
    min(floor(dst * in/out), in-1). [B,H,W,C] -> [B,out_h,out_w,C]."""
    _, h, w, _ = img.shape
    if (h, w) == (out_h, out_w):
        return img
    iy = np.minimum((np.arange(out_h) * (h / out_h)).astype(np.int32), h - 1)
    ix = np.minimum((np.arange(out_w) * (w / out_w)).astype(np.int32), w - 1)
    return img[:, torch.from_numpy(iy).to(img.device)][
        :, :, torch.from_numpy(ix).to(img.device)]


def resampler_clamped(data: torch.Tensor, coords: torch.Tensor
                      ) -> torch.Tensor:
    """Bilinear sample with edge-clamped taps (replicate padding) instead of
    the zero padding of resampler. The tap weights take the MAP's type, so
    a bf16 map is interpolated in bf16, as in the JAX version."""
    b, h, w, c = data.shape
    x = torch.clamp(coords[..., 0], 0.0, w - 1.0)
    y = torch.clamp(coords[..., 1], 0.0, h - 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    tx = (x - x0f)[..., None].to(data.dtype)
    ty = (y - y0f)[..., None].to(data.dtype)
    x0 = torch.nan_to_num(x0f).long()
    y0 = torch.nan_to_num(y0f).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = data.reshape(b, h * w, c)

    def g(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1,
                                                                    c))

    top = g(y0, x0) * (1 - tx) + g(y0, x1) * tx
    bot = g(y1, x0) * (1 - tx) + g(y1, x1) * tx
    return top * (1 - ty) + bot * ty


def sample_native(feat: torch.Tensor, coords: torch.Tensor, out_h: int,
                  out_w: int) -> torch.Tensor:
    """The 'native' sampling mode: 4 edge-clamped taps on the ORIGINAL
    feature map at TF1-legacy-scaled coordinates (src = dst * in/out). Not
    equal to resize_then_sample off linear maps (a sub-texel difference)."""
    h, w = feat.shape[1], feat.shape[2]
    scale = torch.tensor([w / out_w, h / out_h], dtype=coords.dtype)
    return resampler_clamped(feat, coords * scale.to(coords.device))


@functools.lru_cache(maxsize=64)
def _taps(out_size: int, in_size: int, device: torch.device
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, t) of the TF1-legacy resize of in_size to out_size, per
    output pixel, on `device`, made once."""
    src = np.arange(out_size) * (in_size / out_size)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    t = (src - lo).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, t))


def resize_then_sample(feat: torch.Tensor, coords: torch.Tensor,
                       out_h: int, out_w: int) -> torch.Tensor:
    """resize_bilinear(feat, out) then resampler at coords (the reference's
    per-scale local-feature op, model_normalization.py:171-185) without
    making the resized map: each of the 4 resized pixels a sample mixes is
    itself a 2x2 mix of source pixels, so 16 source taps with combined
    weights. Gathers and lerps in float32 (float64 for a float64 map) and
    casts back to the map's type. [B,H,W,C], [B,N,2] -> [B,N,C]."""
    b, h, w, c = feat.shape
    x, y = coords[..., 0], coords[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    tx = (x - x0f)[..., None]
    ty = (y - y0f)[..., None]
    x0 = torch.clamp(torch.nan_to_num(x0f).long(), 0, out_w - 1)
    y0 = torch.clamp(torch.nan_to_num(y0f).long(), 0, out_h - 1)
    x1 = torch.clamp(x0 + 1, max=out_w - 1)
    y1 = torch.clamp(y0 + 1, max=out_h - 1)
    # at the right/bottom edge tx == 0, so the clamped duplicate is inert
    ylo, yhi, yt = _taps(out_h, h, feat.device)
    xlo, xhi, xt = _taps(out_w, w, feat.device)
    flat = widen(feat.reshape(b, h * w, c))

    def g(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1,
                                                                    c))

    def sample_resized(oy, ox):
        """The virtually resized map at integer output pixels (oy, ox)."""
        sy0, sy1, wty = ylo[oy], yhi[oy], yt[oy][..., None]
        sx0, sx1, wtx = xlo[ox], xhi[ox], xt[ox][..., None]
        top = g(sy0, sx0) * (1 - wtx) + g(sy0, sx1) * wtx
        bot = g(sy1, sx0) * (1 - wtx) + g(sy1, sx1) * wtx
        return top * (1 - wty) + bot * wty

    top = sample_resized(y0, x0) * (1 - tx) + sample_resized(y0, x1) * tx
    bot = sample_resized(y1, x0) * (1 - tx) + sample_resized(y1, x1) * tx
    return (top * (1 - ty) + bot * ty).to(feat.dtype)
