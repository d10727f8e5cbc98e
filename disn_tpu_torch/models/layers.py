"""Minimal functional layers (port of disn_tpu/models/layers.py).

Params are plain dicts of tensors in the JAX package's TF layouts:
``{"weights": [kh,kw,in,out] (HWIO) | [kd,kh,kw,in,out] (DHWIO) |
[in,out], "biases": [out]}``, so a JAX param tree converts leaf by leaf
(convert.params_from_jax). Activations are NHWC (NDHWC) at the function
boundaries.

Compute type: convs and matmuls run in the compute type (bf16 on the GPU
accumulates in float32 inside cuDNN/cuBLAS); the bias is added in the
compute type and the result cast back to it, as the JAX layers do.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


def xavier_uniform(gen: torch.Generator, shape: tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    """Glorot/Xavier uniform, the default of slim.conv2d."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2 * limit) - limit


def truncated_normal(gen: torch.Generator, shape: tuple[int, ...],
                     stddev: float, device: torch.device) -> torch.Tensor:
    """Normal draws cut at +-2 standard deviations, times stddev: uniform
    draws mapped through the normal's inverse cdf over [-2, 2]."""
    lo, hi = (math.erf(x / math.sqrt(2.0)) for x in (-2.0, 2.0))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    z = torch.erfinv(u * (hi - lo) + lo) * math.sqrt(2.0)
    return torch.clamp(z, -2.0, 2.0) * stddev


def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              device: torch.device) -> Params:
    return {"weights": xavier_uniform(gen, (kh, kw, cin, cout), device),
            "biases": torch.zeros(cout, device=device)}


def init_dense(gen: torch.Generator, cin: int, cout: int,
               device: torch.device, stddev: float | None = None) -> Params:
    """Xavier-uniform weights, or truncated_normal(stddev) when given."""
    w = (xavier_uniform(gen, (cin, cout), device) if stddev is None
         else truncated_normal(gen, (cin, cout), stddev, device))
    return {"weights": w, "biases": torch.zeros(cout, device=device)}


def init_conv3d_transpose(gen: torch.Generator, k: tuple[int, int, int],
                          cin: int, cout: int, device: torch.device
                          ) -> Params:
    """DHWIO transpose-conv kernel, Xavier uniform, zero biases."""
    return {"weights": xavier_uniform(gen, (*k, cin, cout), device),
            "biases": torch.zeros(cout, device=device)}


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF's SAME split of one spatial axis: (before, after) with the output
    ceil(size / stride) long and the smaller half before. Symmetric at
    stride 1 and odd k; at stride 2 or more it is often not (an 11x11
    stride-4 conv on 224 pads 3 and 4, a 3x3 stride-2 one on 56 pads 0
    and 1)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride: int, padding: str
          ) -> tuple[tuple[int, int], tuple[int, int]]:
    """((top, bottom), (left, right)) of NCHW x for padding 'SAME' (TF's
    split) or 'VALID' (none)."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return (same_padding(x.shape[2], kh, stride),
            same_padding(x.shape[3], kw, stride))


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME", relu: bool = True,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC conv with an HWIO kernel, TF's SAME (or VALID) padding. x:
    [B,H,W,Cin] (kept in channels_last memory, so the NHWC view is free);
    the weights go to OIHW for torch. At stride 1 a symmetric pad is the
    conv's own (odd k: VGG-16, the camera net); otherwise the input is
    padded explicitly and the conv is VALID."""
    w = p["weights"].to(compute_dtype).permute(3, 2, 0, 1)
    xc = x.to(compute_dtype).permute(0, 3, 1, 2)
    kh, kw = w.shape[2:]
    (top, bottom), (left, right) = _pads(xc, kh, kw, stride, padding)
    if stride == 1 and top == bottom and left == right:
        y = F.conv2d(xc, w, padding=(top, left))
    else:
        # only the rows and columns some window reads: a strided conv whose
        # input runs past its last window takes a oneDNN path on the CPU
        # that aborts now and then in the backward pass
        xp = F.pad(xc, (left, right, top, bottom))
        used_h = (xp.shape[2] - kh) // stride * stride + kh
        used_w = (xp.shape[3] - kw) // stride * stride + kw
        y = F.conv2d(xp[:, :, :used_h, :used_w], w, stride=stride)
    y = y + p["biases"].to(y.dtype)[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(compute_dtype).permute(0, 2, 3, 1)


def dense(p: Params, x: torch.Tensor, relu: bool = True,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[..., in] @ [in, out] + b in the compute type."""
    y = torch.matmul(x.to(compute_dtype), p["weights"].to(compute_dtype))
    y = y + p["biases"].to(y.dtype)
    if relu:
        y = torch.relu(y)
    return y.to(compute_dtype)


def max_pool2d(x: torch.Tensor, k: int = 2, stride: int = 2,
               padding: str = "VALID") -> torch.Tensor:
    """Max pool on NHWC; 'SAME' pads TF's split with -inf (lax's
    reduce_window starts at -inf), so a padded tap never wins."""
    xc = x.permute(0, 3, 1, 2)
    (top, bottom), (left, right) = _pads(xc, k, k, stride, padding)
    if top or bottom or left or right:
        xc = F.pad(xc, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(xc, kernel_size=k, stride=stride).permute(0, 2, 3, 1)


def _conv_transpose_padding(k: int, s: int, padding: str
                            ) -> tuple[int, int]:
    """(before, after) zero padding of the stride-dilated input, lax's
    rule for a transpose conv (jax.lax.conv_transpose)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return pad_a, pad_len - pad_a


def conv3d_transpose(p: Params, x: torch.Tensor,
                     stride: tuple[int, int, int], padding: str = "SAME",
                     relu: bool = True,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """NDHWC transpose conv with a DHWIO kernel (tf_util.conv3d_transpose),
    as jax.lax.conv_transpose computes it with transpose_kernel=False: the
    input dilated by the stride, zero-padded by _conv_transpose_padding,
    and correlated with the kernel AS STORED. That is
    F.conv_transpose3d with the kernel flipped in D, H and W (its [in,
    out] order is already conv_transpose3d's), which pads k-1 on both
    sides; the outer k-1-pad rows are cut. Stride 2: k=2 SAME and k=3 SAME
    double n, k=3 VALID gives 2n+1."""
    w = p["weights"].to(compute_dtype)
    crops = []
    for k, s in zip(w.shape[:3], stride):
        a, b = _conv_transpose_padding(k, s, padding)
        if a > k - 1 or b > k - 1:
            raise ValueError(f"padding {padding} pads more than k - 1 at "
                             f"k={k}, stride {s}")
        crops.append((k - 1 - a, k - 1 - b))
    y = F.conv_transpose3d(x.to(compute_dtype).permute(0, 4, 1, 2, 3),
                           w.flip(0, 1, 2).permute(3, 4, 0, 1, 2),
                           stride=tuple(stride))
    y = y[:, :, crops[0][0]:y.shape[2] - crops[0][1],
          crops[1][0]:y.shape[3] - crops[1][1],
          crops[2][0]:y.shape[4] - crops[2][1]]
    y = y + p["biases"].to(y.dtype)[:, None, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(compute_dtype).permute(0, 2, 3, 4, 1)


def init_batch_norm(c: int, device: torch.device) -> Params:
    """gamma/beta and the moving moments (tf.contrib.layers.batch_norm's
    layout, decay 0.9)."""
    return {"gamma": torch.ones(c, device=device),
            "beta": torch.zeros(c, device=device),
            "moving_mean": torch.zeros(c, device=device),
            "moving_variance": torch.ones(c, device=device)}


def batch_norm(p: Params, x: torch.Tensor, is_training: bool = False,
               decay: float = 0.9, eps: float = 1e-3
               ) -> tuple[torch.Tensor, Params]:
    """Batch normalisation over every axis but the channels (the last).
    Returns (normed, new_p). Training: the batch's mean and POPULATION
    variance (ddof 0, as jnp.var) normalise, and new_p carries the moving
    moments updated in the step by EMA at `decay`; inference: the moving
    moments normalise and new_p is p. Statistics in float32, the result in
    x's type. The reference runs its encoder with bn=False, so no shipped
    model calls this."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    if is_training:
        mean = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
        new_p = dict(
            p, moving_mean=decay * p["moving_mean"] + (1 - decay) * mean,
            moving_variance=decay * p["moving_variance"]
            + (1 - decay) * var)
    else:
        mean, var = p["moving_mean"], p["moving_variance"]
        new_p = p
    inv = torch.rsqrt(var + eps) * p["gamma"]
    return ((xf - mean) * inv + p["beta"]).to(x.dtype), new_p


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float = 0.5,
            is_training: bool = True,
            noise_shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """Inverted dropout with keep probability 1 - rate (tf.nn.dropout): a
    kept value is scaled by 1/keep, the mask drawn from `gen` (on x's
    device). The identity when not training or rate <= 0, which is how
    every reference graph runs it."""
    if not is_training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = noise_shape if noise_shape is not None else x.shape
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def _weight_leaves(tree: Any):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _weight_leaves(v)
        elif k == "weights":
            yield v


def l2_regularizer(params: Params, scale: float) -> torch.Tensor:
    """scale * sum over every 'weights' leaf of ||w||^2 / 2, biases
    excluded (slim.l2_regularizer), summed in float32."""
    total = sum(torch.sum(torch.square(w.float())) / 2.0
                for w in _weight_leaves(params))
    return scale * total


def param_count(params: Params) -> int:
    return sum(v.numel() if torch.is_tensor(v) else param_count(v)
               for v in params.values())
