"""Image -> mesh reconstruction (port of the synchronous core of
disn_tpu/infer/pipeline.py).

One call: encode + fold the image, build the SDF volume (two-level sparse
when the grid allows, else the exact dense path) and extract the welded
mesh, returned as numpy (verts, faces). On the sparse path the fine pass
ends in the extractor's candidate scan and the owned-edge extractor builds
the welded mesh on the device, so one copy brings it to the host; the
dense paths go through marching tetrahedra and the host weld. The JAX
package's remote-link machinery (speculative buckets, parallel fetch
streams, background assembly) is not ported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import dense as dense_mod
from disn_tpu_torch.infer import sparse as sparse_mod
from disn_tpu_torch.ops import marching
from disn_tpu_torch.postprocessing import clean_small_parts

Params = dict[str, Any]

UNIT_BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


def _sparse_eligible(cfg: Config) -> bool:
    """Regress heads whose grid the stride-4 cells divide take the sparse
    band cull; binary heads and other grids the exact dense path."""
    return (cfg.sparse_stride == sparse_mod.STRIDE
            and cfg.sdf_res % sparse_mod.STRIDE == 0 and not cfg.binary)


def predict_volume(params: Params, img, trans_mat, sdf_params, cfg: Config,
                   device: str | torch.device | None = None,
                   stats: dict | None = None) -> torch.Tensor:
    """Image -> [R,R,R] f32 SDF volume (z,y,x) on `device`."""
    if _sparse_eligible(cfg):
        return sparse_mod.sparse_dense_sdf(params, img, trans_mat,
                                           sdf_params, cfg, device=device,
                                           stats=stats)
    return dense_mod.dense_sdf(params, img, trans_mat, sdf_params, cfg,
                               device=device)


def volume_to_mesh(vol: torch.Tensor, sdf_params, iso: float = 0.0,
                   clean: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """[R,R,R] volume (on any device) -> welded numpy (verts, faces) by
    marching tetrahedra and the host weld, the mesh oracle. clean=True
    drops small and off-centre components."""
    verts, faces = marching.extract_mesh(vol, sdf_params, iso=iso)
    if clean and len(faces):
        verts, faces = clean_small_parts(verts, faces)
    return verts, faces


def image_to_mesh(params: Params, img, trans_mat, cfg: Config,
                  sdf_params=None, iso: float | None = None,
                  clean: bool = False,
                  device: str | torch.device | None = None,
                  stats: dict | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Single image ([H,W,3] float in [0,1], or uint8 normalised on the
    device) -> (vertices [V,3] f32, faces [F,3] i32).

    sdf_params defaults to the unit box [-1,1]^3. The sparse path scans
    the fine cells inside the active coarse cells and extracts the welded
    mesh on the device (route ``owned_ids``); if the scan's guard finds a
    sign change outside those cells, the whole volume is scanned instead
    (``owned_scan``). When the active cells overflow the cap, or the config
    is not eligible for the sparse path, the dense volume goes through
    volume_to_mesh (``tets``).

    `stats`, when given, receives per-stage wall times in ms (each stage
    synchronised: encode, prep, phase_a, phase_b and scan or
    dense_fallback, then extraction, which covers everything after the
    volume and the scan, with its parts extract on the device and fetch to
    the host on the owned routes), ``active_cells``, and ``route`` with,
    on the sparse path, ``fine_cells`` and ``guard``."""
    dev = device_mod.resolve(device)
    if sdf_params is None:
        sdf_params = UNIT_BOX
    iso = cfg.iso if iso is None else iso
    scan = None
    if _sparse_eligible(cfg):
        vol, scan = sparse_mod.sparse_volume(
            params, img, trans_mat, sdf_params, cfg, device=dev,
            stats=stats, scan_iso=iso)
    else:
        vol = dense_mod.dense_sdf(params, img, trans_mat, sdf_params, cfg,
                                  device=dev)
    with device_mod.stage(stats, "extraction_ms", dev):
        if scan is None:
            route = "tets"
            verts, faces = volume_to_mesh(vol, sdf_params, iso=iso)
        else:
            ids, n_cells, guard, _ = scan
            if guard == 0:
                route = "owned_ids"
                verts, faces = marching.extract_mesh_from_ids(
                    vol, sdf_params, ids, iso=iso, device=dev, stats=stats)
            else:
                route = "owned_scan"
                verts, faces = marching.extract_mesh_owned(
                    vol, sdf_params, iso=iso, device=dev, stats=stats)
    if stats is not None:
        stats["route"] = route
        if scan is not None:
            stats.update(fine_cells=n_cells, guard=guard)
    if clean and len(faces):
        verts, faces = clean_small_parts(verts, faces)
    return verts, faces
