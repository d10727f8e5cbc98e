"""Wiring for the fused decode kernel (port of disn_tpu/infer/fused.py).

The CUDA kernel samples the whole folded map from device memory, so no tap
can fall outside a tile: unlike the TPU version there is no per-cell escape
count and no rescue pass. ``decode_cells`` is the kernel plus the head's
output scaling; ``dense_grid_via_cells`` decodes a full [R,R,R] grid (all
cells through the kernel, the three boundary planes per point);
``kernel_enabled`` decides, as the JAX package's does, which configs and
grids the kernel serves: every decode of the port asks it.
"""
from __future__ import annotations

from typing import Any

import torch

from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import dense as dense_mod
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import fused_decode

Params = dict[str, Any]

STRIDE = fused_decode.STRIDE
PLANE_BLOCK = 65536  # boundary-plane points decoded per step

_cell_points = fused_decode.cell_points


def kernel_enabled(cfg: Config, fold: str, stride: int, fine_r: int,
                   strict: bool = True) -> bool:
    """Whether the kernel decodes a grid of fine_r points a side: fold
    '137' (twostream + tf1), stride-4 cells, fine_r - 1 a multiple of 4,
    137^2 images, and cfg.fused_kernel not 'off' (which takes the plain
    decode). The JAX package's rule but for one term: it also asks
    fine_r - 1 >= 48, so that a cell's footprint fits its TPU tile. The
    CUDA kernel samples the whole map from device memory and has no tile
    to outgrow, so here it serves the small grids too (17^3 to 45^3:
    the coarse pass of sdf_res 64 and 128, and any fine grid below 49^3)
    where the JAX package decodes plainly.

    fused_kernel='on' raises on an ineligible grid instead of quietly
    taking the plain decode; strict=False asks without raising (the
    coarse pass of the sparse flow, which keeps the kernel where it is
    eligible and decodes plainly otherwise)."""
    if cfg.fused_kernel == "off":
        return False
    ok = (fold == "137" and stride == STRIDE and (fine_r - 1) % STRIDE == 0
          and cfg.img_w == 137 and cfg.img_h == 137)
    if strict and cfg.fused_kernel == "on" and not ok:
        raise ValueError(
            "fused_kernel='on' but the config is ineligible (needs "
            f"twostream+tf1 fold='137' (got {fold!r}), stride {STRIDE} "
            f"(got {stride}), grid - 1 a multiple of {STRIDE} (got {fine_r}), "
            "137x137 images); "
            "use 'auto' to fall back to the plain decode")
    return ok


def decode_cells(params: Params, endpoints: dict, trans_mat: torch.Tensor,
                 sdf_params: torch.Tensor, cell_ids: torch.Tensor,
                 cfg: Config, *, fine_r: int, coarse_c: int) -> torch.Tensor:
    """Decode every stride^3 point of `cell_ids` ([n] int) -> [n*64] f32
    scaled SDF values, in cell_points order."""
    cd = disn.compute_dtype(cfg)
    fmap = endpoints["fold137"][0].contiguous()
    wpack = fused_decode.pack_weights(params, endpoints["g_contrib"], cd)
    raw = fused_decode.fused_cell_decode(
        fmap, wpack, trans_mat.float().contiguous(),
        sdf_params.float().contiguous(), cell_ids.int().contiguous(),
        fine_r=fine_r, coarse_c=coarse_c, img_w=cfg.img_w, img_h=cfg.img_h)
    pred = raw[None]
    if cfg.tanh:
        pred = torch.tanh(pred)
    return dense_mod.scale_pred(pred, cfg)[0]


def plane_points(resolution: int, sdf_params: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The grid points no stride-4 cell owns: the planes z=R-1, y=R-1 and
    x=R-1, as ([3R^2, 3] points, [3R^2] flat indices)."""
    n_plane = resolution * resolution
    q = torch.arange(3 * n_plane, device=sdf_params.device)
    which = q // n_plane
    r = q % n_plane
    a = r // resolution
    b = r % resolution
    last = resolution - 1
    fx = torch.where(which == 2, last, b)
    fy = torch.where(which == 0, a, torch.where(which == 1, last, b))
    fz = torch.where(which == 0, last, a)
    f = torch.stack([fx, fy, fz], dim=-1).float()
    sp = sdf_params.float()
    # an IEEE divide by a scalar on the device, as cell_points does: a
    # Python float would become a multiply by its reciprocal on CUDA
    denom = torch.full((), float(resolution - 1), dtype=torch.float32,
                       device=f.device)
    pts = sp[0:3] + f / denom * (sp[3:6] - sp[0:3])
    return pts, (fz * resolution + fy) * resolution + fx


def decode_planes(params: Params, endpoints: dict, trans_mat: torch.Tensor,
                  sdf_params: torch.Tensor, resolution: int, cfg: Config,
                  vol: torch.Tensor, embedding: torch.Tensor | None = None,
                  folded=None) -> None:
    """Write the exact boundary-plane values into the flat volume `vol`
    (in place) by the plain decode of `folded` (dense.normalize_fold's
    modes; the embedding serves the arms that read it), PLANE_BLOCK points
    at a time."""
    pts, flats = plane_points(resolution, sdf_params)
    vol[flats] = dense_mod.decode_points(
        params, endpoints, embedding, trans_mat, pts, cfg, folded=folded,
        block=PLANE_BLOCK).float()


def dense_grid_via_cells(params: Params, endpoints: dict,
                         trans_mat: torch.Tensor, sdf_params: torch.Tensor,
                         resolution: int, cfg: Config) -> torch.Tensor:
    """Full [R,R,R] f32 volume: interior points via the kernel over all
    ((R-1)/4)^3 cells, the three boundary planes via _decode_block."""
    if (resolution - 1) % STRIDE:
        raise ValueError(f"resolution - 1 ({resolution - 1}) must be a "
                         f"multiple of {STRIDE}")
    c = (resolution - 1) // STRIDE
    cell_ids = torch.arange(c ** 3, dtype=torch.int32,
                            device=sdf_params.device)
    vals = decode_cells(params, endpoints, trans_mat, sdf_params, cell_ids,
                        cfg, fine_r=resolution, coarse_c=c)
    _, flats = _cell_points(cell_ids, c, resolution, sdf_params)
    vol = torch.full((resolution ** 3,), float("nan"),
                     device=sdf_params.device)
    vol[flats] = vals
    decode_planes(params, endpoints, trans_mat, sdf_params, resolution, cfg,
                  vol)
    return vol.reshape(resolution, resolution, resolution)
