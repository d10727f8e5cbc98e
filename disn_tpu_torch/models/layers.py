"""Minimal functional layers (port of disn_tpu/models/layers.py).

Params are plain dicts of tensors in the JAX package's TF layouts:
``{"weights": [kh,kw,in,out] (HWIO) | [in,out], "biases": [out]}``, so a
JAX param tree converts leaf by leaf (convert.params_from_jax). Activations
are NHWC at the function boundaries.

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


def conv2d(p: Params, x: torch.Tensor, relu: bool = True,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SAME 3x3 (or any odd-size) stride-1 conv. x: [B,H,W,Cin] NHWC (kept
    in channels_last memory, so the NHWC view is free); HWIO weights go to
    OIHW for torch."""
    w = p["weights"].to(compute_dtype).permute(3, 2, 0, 1)
    xc = x.to(compute_dtype).permute(0, 3, 1, 2)
    kh, kw = w.shape[2:]
    y = F.conv2d(xc, w, padding=(kh // 2, kw // 2))
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


def max_pool2d(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pool on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=k, stride=stride)
    return y.permute(0, 2, 3, 1)


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
