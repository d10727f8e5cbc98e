"""SDF ground truth of a mesh (port of disn_tpu/preprocessing/sdf_gen.py;
the reference's preprocessing/create_point_sdf_grid.py and
create_point_sdf_fullgrid.py).

Per mesh: normalise to the unit sphere (centroid and max radius m of
16384 surface samples), compute the signed distance grid on the host
(native/distfield.cpp through ``disn_tpu_torch.native``, narrow-banded),
flip it for an inside-out car, plane or watercraft (the centre voxel's
sign), stratified-sample query points in 4 bands inside +-bandwidth with
25% quotas and next-band spill-over, and write ``ori_sample.h5`` and the
ground-truth mesh ``isosurf.obj``, extracted by ops/marching.extract_mesh
on the card unless ``device="cpu"``.

``object_field`` is the host half (the distance field; the CLI runs it in
a thread pool, since ctypes drops the GIL) and ``write_object`` the rest,
so ``generate_object`` = the two in turn.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch import native
from disn_tpu_torch.config import INSIDEOUT_CATS
from disn_tpu_torch.core import codecs
from disn_tpu_torch.core.meshes import sample_surface
from disn_tpu_torch.ops import marching


def normalize_mesh(verts: np.ndarray, faces: np.ndarray,
                   n_surface: int = 16384, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Unit-sphere normalisation (get_normalize_mesh): centroid and max
    radius m of `n_surface` surface samples. Returns (normalised verts,
    centroid, m, the samples in normalised coordinates)."""
    rng = np.random.RandomState(seed)
    surf = sample_surface(verts, faces, n_surface, rng)
    centroid = surf.mean(axis=0)
    m = float(np.sqrt(((surf - centroid) ** 2).sum(axis=1)).max())
    normalized = (verts - centroid) / m
    return normalized.astype(np.float32), centroid.astype(np.float32), m, \
        ((surf - centroid) / m).astype(np.float32)


def stratified_sample_grid(sdf_values: np.ndarray, sdf_params: np.ndarray,
                           num_sample: int, bandwidth: float, iso_val: float,
                           rng: np.random.RandomState) -> np.ndarray:
    """[N,4] (x, y, z, sdf) samples of the grid, 4 bands inside
    +-bandwidth of iso with 25% quotas and next-band spill-over, drawn with
    replacement (sample_sdf)."""
    res1 = sdf_values.shape[0]
    flat = sdf_values.reshape(-1)
    axes = [np.linspace(sdf_params[i], sdf_params[i + 3], res1)
            .astype(np.float32) for i in range(3)]
    dis = flat - iso_val
    bands = [(-bandwidth, -0.3 * bandwidth), (-0.3 * bandwidth, 0.0),
             (0.0, 0.3 * bandwidth), (0.3 * bandwidth, bandwidth)]
    quotas = [num_sample // 4] * 4
    out = []
    for i, (lo, hi) in enumerate(bands):
        ind = np.nonzero((dis >= lo) & (dis < hi))[0]
        if len(ind) < quotas[i]:
            if i + 1 < 4:
                quotas[i + 1] += quotas[i] - len(ind)
            quotas[i] = len(ind)
        if len(ind) == 0:
            continue
        pick = ind[rng.randint(len(ind), size=quotas[i])]
        xi = pick % res1
        yi = (pick // res1) % res1
        zi = pick // res1 ** 2
        out.append(np.stack([axes[0][xi], axes[1][yi], axes[2][zi],
                             flat[pick]], axis=1))
    return np.concatenate(out, axis=0).astype(np.float32)


def check_insideout(cat_id: str, sdf_values: np.ndarray) -> bool:
    """Whether a mesh of a category often stored inverted (cars, planes,
    watercraft) is: its centre voxel lies outside."""
    if cat_id not in INSIDEOUT_CATS:
        return False
    c = sdf_values.shape[0] // 2
    return bool(sdf_values[c, c, c] > 0.0)


@dataclass
class ObjectField:
    """The host half of one object: its distance field and normalisation."""
    vol: np.ndarray        # [(res+1)]^3 float32, [z,y,x]
    bbox: np.ndarray       # [6] float64
    centroid: np.ndarray   # [3] float32
    m: float
    surf: np.ndarray       # [16384,3] surface samples, normalised
    seconds: float         # the distance field's host time


def object_field(verts: np.ndarray, faces: np.ndarray, sdf_res: int = 256,
                 expand_rate: float = 1.2, bandwidth: float = 0.1,
                 full_grid_reduce: int = 0, seed: int = 0,
                 threads: int = 0) -> ObjectField:
    """Normalise the mesh and compute its distance field over the cube of
    half-width expand_rate x its largest coordinate. Narrow band of twice
    the sampling bandwidth (the reference runs its tool at -g 0.1), except
    for the full-grid (3D-CNN) variant, which stores every value."""
    norm_verts, centroid, m, surf = normalize_mesh(verts, faces, seed=seed)
    half = float(np.abs(norm_verts).max() * expand_rate)
    bbox = np.array([-half] * 3 + [half] * 3, np.float64)
    band = 0.0 if full_grid_reduce else 2.0 * bandwidth
    t0 = time.perf_counter()
    vol = native.compute_distance_field(norm_verts, faces, sdf_res, bbox,
                                        threads=threads, band=band)
    return ObjectField(vol, bbox, centroid, m, surf,
                       time.perf_counter() - t0)


def write_object(field: ObjectField, out_dir: str, cat_id: str = "",
                 num_sample: int = 32768, bandwidth: float = 0.1,
                 iso_val: float = 0.003, full_grid_reduce: int = 0,
                 seed: int = 0, device: str | torch.device | None = None,
                 stats: dict | None = None) -> dict:
    """The rest of generate_object on a field: the inside-out flip (and
    its flag file), the samples into ori_sample.h5, the ground-truth mesh
    into isosurf.obj (marching_tets on `device`, the weld on the host),
    and with full_grid_reduce > 0 every reduce-th grid value into
    ori_sample_grid.h5. `stats`, when given, receives ``distfield_s``,
    ``marching_tets_ms`` and ``weld_ms``."""
    dev = device_mod.resolve(device)
    os.makedirs(out_dir, exist_ok=True)
    h5_path = os.path.join(out_dir, "ori_sample.h5")
    vol = field.vol
    if check_insideout(cat_id, vol):
        # the reference writes the flag and skips the object; here the
        # field is flipped and the flag records it
        vol = -vol
        with open(os.path.join(out_dir, "isinsideout.txt"), "w") as f:
            f.write("flipped\n")
    rng = np.random.RandomState(seed)
    sdf_params = field.bbox.astype(np.float32)
    norm_params = np.concatenate([field.centroid, [np.float32(field.m)]]
                                 ).astype(np.float32)
    samples = stratified_sample_grid(vol, sdf_params, num_sample, bandwidth,
                                     iso_val, rng)
    codecs.write_sdf_h5(h5_path, samples, norm_params=norm_params,
                        sdf_params=sdf_params, ori_pt=field.surf)
    timings: dict = {} if stats is None else stats
    timings["distfield_s"] = field.seconds
    with device_mod.stage(timings, "marching_tets_ms", dev):
        tri_pos, tri_keys, count = marching.marching_tets(
            torch.from_numpy(vol).to(dev), sdf_params, iso=iso_val)
        tri_pos, tri_keys = tri_pos.cpu().numpy(), tri_keys.cpu().numpy()
    with device_mod.stage(timings, "weld_ms", torch.device("cpu")):
        mc_verts, mc_faces = marching.weld(tri_pos, tri_keys, count)
    codecs.write_obj(os.path.join(out_dir, "isosurf.obj"), mc_verts,
                     mc_faces)
    out = {"h5": h5_path, "skipped": False, "num_samples": len(samples)}
    if full_grid_reduce:
        sub = vol[::full_grid_reduce, ::full_grid_reduce, ::full_grid_reduce]
        codecs.write_sdf_h5(os.path.join(out_dir, "ori_sample_grid.h5"),
                            sub.reshape(-1, 1), norm_params=norm_params,
                            sdf_params=sdf_params, ori_pt=field.surf)
        out["full_grid"] = sub.shape[0]
    return out


def is_done(out_dir: str) -> bool:
    """Whether the object's ori_sample.h5 exists (skip_existing)."""
    return os.path.exists(os.path.join(out_dir, "ori_sample.h5"))


def generate_object(verts: np.ndarray, faces: np.ndarray, out_dir: str,
                    cat_id: str = "", sdf_res: int = 256,
                    expand_rate: float = 1.2, num_sample: int = 32768,
                    bandwidth: float = 0.1, iso_val: float = 0.003,
                    full_grid_reduce: int = 0, seed: int = 0,
                    skip_existing: bool = True,
                    device: str | torch.device | None = None,
                    stats: dict | None = None) -> dict:
    """The whole pipeline of one object -> {out_dir}/ori_sample.h5 and
    isosurf.obj (object_field, then write_object); {"h5", "skipped": True}
    when skip_existing and the h5 exists."""
    os.makedirs(out_dir, exist_ok=True)
    if skip_existing and is_done(out_dir):
        return {"h5": os.path.join(out_dir, "ori_sample.h5"),
                "skipped": True}
    dev = device_mod.resolve(device)
    field = object_field(verts, faces, sdf_res, expand_rate, bandwidth,
                         full_grid_reduce, seed)
    return write_object(field, out_dir, cat_id, num_sample, bandwidth,
                        iso_val, full_grid_reduce, seed, dev, stats)
