"""Mesh voxelization for the IoU protocol (port of disn_tpu/ops/voxelize.py).

The reference inserts each mesh into pymesh's VoxelGrid(2/dim) and marks
the voxels of the result (test/test_iou.py:208-233): surface-voxel
occupancy on a dim^3 grid covering [-1.1, 1.3). ``voxelize_surface``
computes it exactly with the native 13-axis triangle-box test
(native/voxelsat.cpp); a failed build of that raises. ``voxelize_sampled``
approximates it by area-proportional point sampling on the host (kept as
the comparison arm of the tests), and ``occupancy_device`` does the same
on a device with PyTorch ops (the evaluator's ``--device-iou``).
"""
from __future__ import annotations

import numpy as np
import torch

from disn_tpu_torch import device as device_mod


def voxelize_surface(verts: np.ndarray, faces: np.ndarray, dim: int = 110,
                     offset: float = 1.1, span: float = 2.4) -> np.ndarray:
    """Boolean [dim,dim,dim] occupancy of the cells a triangle crosses."""
    from disn_tpu_torch import native
    return native.voxelize_sat(verts, faces, dim=dim, offset=offset,
                               span=span)


def voxelize_sampled(verts: np.ndarray, faces: np.ndarray, dim: int = 110,
                     offset: float = 1.1, span: float = 2.4,
                     samples_per_cell: float = 4.0) -> np.ndarray:
    """Surface occupancy from the triangle corners and area-proportional
    samples on each triangle (counts proportional to area, so cells are
    covered rather than the surface sampled uniformly)."""
    occ = np.zeros((dim, dim, dim), dtype=bool)
    if len(faces) == 0:
        return occ
    cell = span / dim
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]

    def mark(pts):
        idx = np.floor((pts + offset) / span * dim).astype(np.int64)
        ok = ((idx >= 0) & (idx < dim)).all(axis=1)
        idx = idx[ok]
        occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True

    mark(verts)
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    n_samples = np.maximum(
        1, np.ceil(samples_per_cell * areas / (cell * cell)).astype(np.int64))
    rng = np.random.RandomState(0)
    total = int(n_samples.sum())
    tri_idx = np.repeat(np.arange(len(faces)), n_samples)
    r1 = np.sqrt(rng.rand(total, 1)).astype(np.float32)
    r2 = rng.rand(total, 1).astype(np.float32)
    pts = ((1 - r1) * v0[tri_idx] + r1 * (1 - r2) * v1[tri_idx]
           + r1 * r2 * v2[tri_idx])
    mark(pts)
    return occ


def _pow2(n: int) -> int:
    out = 1
    while out < n:
        out *= 2
    return out


def occupancy_device(verts: np.ndarray, faces: np.ndarray, dim: int = 110,
                     offset: float = 1.1, span: float = 2.4,
                     samples_per_cell: float = 4.0, seed: int = 0,
                     device: str | torch.device | None = None) -> np.ndarray:
    """Boolean [dim,dim,dim] surface occupancy sampled on `device` (the GPU
    by default; it raises without one): triangles drawn by area through a
    cumulative sum and searchsorted, uniform points on them, the corners,
    and a scatter into a [dim^3] grid. The cumulative sum is taken on the
    host in float64: CUDA's float cumsum is not deterministic, and a grid
    must repeat for a seed (a mesh's IoU with itself is 1). The sample
    count is the JAX
    package's (a power of two between 2^12 and 2^22); the draws come from a
    torch.Generator on `device` seeded with `seed`, so they are not the JAX
    package's, nor the same on the CPU and on the card."""
    dev = device_mod.resolve(device)
    if len(faces) == 0:
        return np.zeros((dim, dim, dim), dtype=bool)
    v_np = np.asarray(verts, np.float32)
    f_np = np.asarray(faces, np.int64)
    cell = span / dim
    areas = 0.5 * np.linalg.norm(
        np.cross(v_np[f_np[:, 1]] - v_np[f_np[:, 0]],
                 v_np[f_np[:, 2]] - v_np[f_np[:, 0]]), axis=1)
    total = int(max(len(v_np) * 3,
                    np.ceil(samples_per_cell * areas.sum() / cell ** 2)))
    n = _pow2(min(max(total, 1 << 12), 1 << 22))
    tri = torch.from_numpy(v_np).to(dev)[torch.from_numpy(f_np).to(dev)]
    cdf = np.cumsum(areas, dtype=np.float64)
    cdf = torch.from_numpy((cdf / max(cdf[-1], 1e-12)).astype(np.float32)
                           ).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand(n, generator=gen, device=dev)
    fi = torch.clamp(torch.searchsorted(cdf, u), 0, len(f_np) - 1)
    r1 = torch.sqrt(torch.rand((n, 1), generator=gen, device=dev))
    r2 = torch.rand((n, 1), generator=gen, device=dev)
    t = tri[fi]
    pts = torch.cat([(1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1]
                     + r1 * r2 * t[:, 2], tri.reshape(-1, 3)])
    idx = torch.floor((pts + offset) / span * dim).long()
    ok = ((idx >= 0) & (idx < dim)).all(1)
    idx = idx[ok]
    occ = torch.zeros(dim ** 3, dtype=torch.bool, device=dev)
    occ[(idx[:, 0] * dim + idx[:, 1]) * dim + idx[:, 2]] = True
    return occ.reshape(dim, dim, dim).cpu().numpy()


def occupancy_iou(o1: np.ndarray, o2: np.ndarray) -> float:
    """|A and B| / |A or B| of two boolean grids (0 when both are empty)."""
    union = np.logical_or(o1, o2).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(o1, o2).sum()) / float(union)


def iou_meshes_device(mesh1, mesh2, dim: int = 110, seed: int = 0,
                      device: str | torch.device | None = None) -> float:
    """IoU of two meshes' occupancy_device grids, both drawn from `seed`."""
    return occupancy_iou(
        occupancy_device(*mesh1, dim=dim, seed=seed, device=device),
        occupancy_device(*mesh2, dim=dim, seed=seed, device=device))


def fill_solid(occ_surface: np.ndarray) -> np.ndarray:
    """Solid occupancy from a closed surface shell by exterior flood fill
    (scipy's label, 6-connectivity): free cells not connected to the
    grid's border are inside."""
    from scipy import ndimage
    free = ~occ_surface
    labels, _ = ndimage.label(
        free, structure=ndimage.generate_binary_structure(3, 1))
    border_labels = np.unique(np.concatenate([
        labels[0].ravel(), labels[-1].ravel(),
        labels[:, 0].ravel(), labels[:, -1].ravel(),
        labels[:, :, 0].ravel(), labels[:, :, -1].ravel()]))
    outside = np.isin(labels, border_labels[border_labels > 0])
    return ~outside


def iou_meshes(mesh1: tuple[np.ndarray, np.ndarray],
               mesh2: tuple[np.ndarray, np.ndarray], dim: int = 110,
               solid: bool = False) -> float:
    """The reference IoU protocol between two meshes."""
    o1 = voxelize_surface(*mesh1, dim=dim)
    o2 = voxelize_surface(*mesh2, dim=dim)
    if solid:
        o1, o2 = fill_solid(o1), fill_solid(o2)
    return occupancy_iou(o1, o2)
