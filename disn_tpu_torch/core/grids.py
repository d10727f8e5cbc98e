"""Dense SDF query-grid construction (port of disn_tpu/core/grids.py).

The reference builds the inference grid with np.meshgrid(z, y, x,
indexing='ij') and concatenates (x, y, z): flat order has x fastest, then
y, then z (test/create_sdf.py:243-258), the `.dist` value order.
"""
from __future__ import annotations

import numpy as np
import torch


def dense_grid_np(sdf_params: np.ndarray, resolution: int) -> np.ndarray:
    """[res^3, 3] float32 grid points, x fastest."""
    x = np.linspace(sdf_params[0], sdf_params[3], num=resolution,
                    dtype=np.float64)
    y = np.linspace(sdf_params[1], sdf_params[4], num=resolution,
                    dtype=np.float64)
    z = np.linspace(sdf_params[2], sdf_params[5], num=resolution,
                    dtype=np.float64)
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    return pts.astype(np.float32)


def dense_grid(sdf_params: torch.Tensor, resolution: int) -> torch.Tensor:
    """[res^3, 3] f32 grid on sdf_params' device, x fastest."""
    sp = sdf_params.float()
    t = torch.linspace(0.0, 1.0, resolution, dtype=torch.float32,
                       device=sp.device)
    x = sp[0] + t * (sp[3] - sp[0])
    y = sp[1] + t * (sp[4] - sp[1])
    z = sp[2] + t * (sp[5] - sp[2])
    xx = x.repeat(resolution * resolution)
    yy = y.repeat_interleave(resolution).repeat(resolution)
    zz = z.repeat_interleave(resolution * resolution)
    return torch.stack([xx, yy, zz], dim=-1)


def grid_block(sdf_params: torch.Tensor, resolution: int, start: int,
               block: int) -> torch.Tensor:
    """[block, 3] grid points for flat indices [start, start+block),
    computed on the fly (x fastest), so a decode can stream over the 257^3
    grid without making it."""
    sp = sdf_params.float()
    idx = start + torch.arange(block, device=sp.device)
    ix = idx % resolution
    iy = (idx // resolution) % resolution
    iz = idx // (resolution * resolution)
    # an IEEE divide by float32(resolution - 1), as the reference divides:
    # on CUDA, dividing by a Python float multiplies by its reciprocal
    denom = torch.full((), float(resolution - 1), dtype=torch.float32,
                       device=sp.device)
    f = torch.stack([ix, iy, iz], dim=-1).float() / denom
    return sp[0:3] + f * (sp[3:6] - sp[0:3])


_BLOCK_ORDERS: dict = {}  # (resolution, device) -> block_order's perm


def block_order(resolution: int, device) -> torch.Tensor:
    """The flat (x fastest) indices of a resolution^3 grid in 4^3-block
    order: [res^3] int64, a permutation. First the whole 4^3 blocks of the
    grid's low corner (every coordinate below 4 (res // 4)), blocks z, y,
    x with x fastest and each block's 64 points z, y, x with x fastest;
    then the rest (on a 4k + 1 grid the three high faces) in the same block
    order, partial blocks included. Consecutive 64 points of the first part
    are one block: neighbours in 3D, whose projections share taps (K8,
    ops/mv_taps, stages a run of 64 points' taps in shared memory). Built
    on `device` once a resolution, with no copy to or from the host."""
    dev = torch.device(device)
    key = (resolution, dev)
    if key not in _BLOCK_ORDERS:
        idx = torch.arange(resolution ** 3, device=dev)
        ix = idx % resolution
        iy = (idx // resolution) % resolution
        iz = idx // (resolution * resolution)
        whole = 4 * (resolution // 4)
        nb = -(-resolution // 4)
        rest = (ix >= whole) | (iy >= whole) | (iz >= whole)
        order = (((((rest.long() * nb + iz // 4) * nb + iy // 4) * nb
                   + ix // 4) * 4 + iz % 4) * 4 + iy % 4) * 4 + ix % 4
        _BLOCK_ORDERS[key] = torch.argsort(order)
    return _BLOCK_ORDERS[key]


def trilinear_sample(values: torch.Tensor, sdf_params: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolate a [R,R,R] (z,y,x-indexed) volume at [N,3]
    (x,y,z) points, clamped to the box (scipy's RegularGridInterpolator
    in preprocessing/create_point_sdf_grid.py:20-27)."""
    R = values.shape[0]
    sp = sdf_params.to(points.dtype)
    f = (points - sp[0:3]) / (sp[3:6] - sp[0:3]) * (R - 1)
    f = torch.clamp(f, 0.0, R - 1.0)
    i0 = torch.clamp(torch.floor(f).long(), 0, R - 2)
    w = f - i0.to(f.dtype)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    def at(dz, dy, dx):
        return values[z0 + dz, y0 + dy, x0 + dx]

    c00 = at(0, 0, 0) * (1 - wx) + at(0, 0, 1) * wx
    c01 = at(0, 1, 0) * (1 - wx) + at(0, 1, 1) * wx
    c10 = at(1, 0, 0) * (1 - wx) + at(1, 0, 1) * wx
    c11 = at(1, 1, 0) * (1 - wx) + at(1, 1, 1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz
