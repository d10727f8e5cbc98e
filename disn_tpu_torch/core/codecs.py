"""On-disk formats (a copy of disn_tpu/core/codecs.py without the grid
readers): the SDF-sample h5 and the image+camera h5 of each object and
view, the `.dist` distance-field reader and writer, and OBJ meshes.

`h5py` (and Pillow, for a PNG) is imported when a file is read or
written, not with the module, and a clear error says so when it is
missing. Large OBJ files go through the C
formatter and parser of ``disn_tpu_torch.native`` (above 4096 vertices and
64 KB, the JAX package's thresholds, so both packages write the same
bytes); a failed build of those raises. The Python loops below the
thresholds are the plain versions the tests hold the C code against.

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


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "reading a PNG image needs the Pillow package, which is not "
            "installed; pass a view h5 instead") from e
    return Image


def read_png_u8(path: str, mode: str = "RGBA") -> np.ndarray:
    """An image file -> [H,W,C] uint8, converted to `mode` (RGB or
    RGBA)."""
    with _pil_image().open(path) as im:
        return np.asarray(im.convert(mode), np.uint8)


def read_png(path: str, mode: str = "RGB") -> np.ndarray:
    """An image file -> [H,W,C] float32 in [0,1], converted to `mode`
    (RGB or RGBA)."""
    return np.asarray(read_png_u8(path, mode), np.float32) / 255.0


@dataclass
class DistField:
    params: np.ndarray  # [6] float32 bbox (x0 y0 z0 x1 y1 z1)
    values: np.ndarray  # [(res+1), (res+1), (res+1)] float32, [z,y,x]

    @property
    def res(self) -> int:
        return self.values.shape[0] - 1


def read_dist(path: str, expect_res: int | None = None) -> DistField:
    """A `.dist` file -> DistField; raises on an inconsistent header, a
    resolution other than `expect_res`, or a wrong value count."""
    with open(path, "rb") as f:
        raw = f.read()
    ress = np.frombuffer(raw[:12], dtype=np.int32)
    res = int(ress[1])
    if -ress[0] != res or ress[2] != res:
        raise ValueError(f"{path}: inconsistent header {ress}")
    if expect_res is not None and res != expect_res:
        raise ValueError(f"{path}: res {res} != expected {expect_res}")
    params = np.frombuffer(raw[12:60], dtype=np.float64).astype(np.float32)
    values = np.frombuffer(raw[60:], dtype=np.float32)
    n = res + 1
    if values.size != n ** 3:
        raise ValueError(f"{path}: {values.size} values, expected {n ** 3}")
    return DistField(params=params, values=values.reshape(n, n, n).copy())


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


def read_sdf_params(path: str) -> np.ndarray:
    """Only the sdf_params dataset of an SDF-sample h5: the one field
    reconstruction needs, without decompressing the sample arrays."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        return f["sdf_params"][:].astype(np.float32)


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


# OBJ meshes: faces 0-based in memory, 1-based on disk.

NATIVE_OBJ_VERTS = 4096      # write_obj formats in C above this many vertices
NATIVE_OBJ_BYTES = 1 << 16   # read_obj parses in C above this file size


def write_obj(path: str, vertices: np.ndarray,
              faces: np.ndarray | None = None) -> None:
    """A triangle mesh (or a point cloud when faces is None) as ASCII OBJ,
    six decimals a coordinate."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    vertices = np.asarray(vertices)
    if len(vertices) > NATIVE_OBJ_VERTS:
        from disn_tpu_torch import native
        data = native.format_obj(vertices, faces)
        with open(path, "wb") as f:
            f.write(data)
        return
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in vertices]
    if faces is not None:
        lines += [f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}"
                  for f in np.asarray(faces)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [V,3] f32, triangles [F,3] i32): polygons fan-triangulated;
    normals, texture coordinates and materials ignored."""
    if os.path.getsize(path) > NATIVE_OBJ_BYTES:
        from disn_tpu_torch import native
        with open(path, "rb") as f:
            return native.parse_obj(f.read())
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (np.asarray(verts, dtype=np.float32),
            np.asarray(faces, dtype=np.int32).reshape(-1, 3))
