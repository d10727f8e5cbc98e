"""On-disk formats the training data uses (a copy of the training half of
disn_tpu/core/codecs.py): the SDF-sample h5 and the image+camera h5 of each
object and view, and the `.dist` distance-field writer.

`h5py` is imported when a file is read or written, not with the module, and
a clear error says so when it is missing.

`.dist` layout:
    int32  -res, res, res
    float64 x0 y0 z0 x1 y1 z1        (bbox: bottom-left, top-right corners)
    float32 values[(res+1)^3]        (x fastest, then y, then z)
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading or writing the dataset's h5 files needs the h5py "
            "package, which is not installed") from e
    return h5py


def write_dist(path: str, res: int, params: np.ndarray,
               values: np.ndarray) -> None:
    """values may be flat [(res+1)^3] (x fastest) or [z,y,x] shaped."""
    values = np.ascontiguousarray(np.asarray(values, dtype=np.float32)
                                  ).reshape(-1)
    if values.size != (res + 1) ** 3:
        raise ValueError(f"{values.size} values for res {res}")
    with open(path, "wb") as f:
        f.write(struct.pack("iii", -res, res, res))
        f.write(struct.pack("d" * 6, *[float(p) for p in params]))
        f.write(values.tobytes())


# SDF sample h5 (per object): pc_sdf_original [M,3], pc_sdf_sample [N,4]
# (x, y, z, sdf), norm_params [4] (centroid, m), sdf_params [6].

@dataclass
class SdfSamples:
    ori_pt: np.ndarray        # [M,3] surface/original points
    sample_pt: np.ndarray     # [N,3] (None for the full-grid variant)
    sample_sdf: np.ndarray    # [N]
    norm_params: np.ndarray   # [4]
    sdf_params: np.ndarray    # [6]


def write_sdf_h5(path: str, samples: np.ndarray, norm_params: np.ndarray,
                 sdf_params: np.ndarray,
                 ori_pt: np.ndarray | None = None) -> None:
    h5py = _h5py()
    if ori_pt is None:
        ori_pt = np.zeros((1, 3), dtype=np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for name, data in (("pc_sdf_original", ori_pt),
                           ("pc_sdf_sample", samples),
                           ("norm_params", norm_params),
                           ("sdf_params", sdf_params)):
            f.create_dataset(name, data=np.asarray(data, np.float32),
                             compression="gzip", compression_opts=4)


def read_sdf_h5(path: str) -> SdfSamples:
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        if not ("pc_sdf_original" in f and "pc_sdf_sample" in f
                and "norm_params" in f):
            raise KeyError(f"{path}: missing sdf datasets")
        ori = f["pc_sdf_original"][:].astype(np.float32)
        sample = f["pc_sdf_sample"][:].astype(np.float32)
        if sample.shape[1] == 4:
            sample_pt, sample_sdf = sample[:, :3], sample[:, 3]
        else:
            sample_pt, sample_sdf = None, sample[:, 0]  # full-grid variant
        return SdfSamples(
            ori_pt=ori[:, :3],
            sample_pt=sample_pt,
            sample_sdf=sample_sdf,
            norm_params=f["norm_params"][:].astype(np.float32),
            sdf_params=f["sdf_params"][:].astype(np.float32),
        )


# Image+camera h5 (per view): img_arr [H,W,4] uint8, trans_mat [4,3], K, RT,
# obj_rot_mat [3,3], regress_mat [4,3].

@dataclass
class ViewRecord:
    img_arr: np.ndarray       # [H,W,4] uint8 RGBA
    trans_mat: np.ndarray     # [4,3] float32
    K: np.ndarray             # [3,3]
    RT: np.ndarray            # [3,4]
    obj_rot_mat: np.ndarray   # [3,3]
    regress_mat: np.ndarray   # [4,3]


_VIEW_MATS = ("trans_mat", "K", "RT", "obj_rot_mat", "regress_mat")


def write_view_h5(path: str, rec: ViewRecord) -> None:
    h5py = _h5py()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("img_arr", data=rec.img_arr.astype(np.uint8),
                         compression="gzip", compression_opts=4)
        for k in _VIEW_MATS:
            f.create_dataset(k, data=getattr(rec, k).astype(np.float32),
                             compression="gzip", compression_opts=4)


def read_view_h5(path: str) -> ViewRecord:
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        return ViewRecord(img_arr=f["img_arr"][:],
                          **{k: f[k][:].astype(np.float32)
                             for k in _VIEW_MATS})
