"""Image+camera h5 of each rendered view (port of
disn_tpu/preprocessing/img_gen.py; the reference's
preprocessing/create_img_h5.py).

For each view the Blender intrinsics K and extrinsics RT come from the
render metadata (azimuth, elevation, distance ratio), composed with the
fixed model-frame rotation and the object's unit-sphere de-normalisation;
the 137x137 RGBA image is stored with trans_mat = (K RT rot norm)^T and
regress_mat = (RT rot norm)^T, one h5 per view. Host numpy only.
"""
from __future__ import annotations

import os

import numpy as np

from disn_tpu_torch.core import camera, codecs


def view_record_from_meta(img_rgba: np.ndarray, az: float, el: float,
                          distance_ratio: float, centroid: np.ndarray,
                          m: float, inl: float = 0.0,
                          img_w: int = 137, img_h: int = 137
                          ) -> codecs.ViewRecord:
    trans, regress, K, RT = camera.view_params_to_trans_mat(
        az, el, distance_ratio, centroid, m, img_w=img_w, img_h=img_h)
    return codecs.ViewRecord(
        img_arr=np.asarray(img_rgba, np.uint8),
        trans_mat=trans, K=K, RT=RT,
        obj_rot_mat=camera.obj_rot_matrix(az, el, inl),
        regress_mat=regress)


def parse_render_metadata(path: str
                          ) -> list[tuple[float, float, float, float]]:
    """rendering_metadata.txt lines ('az el inl distance fov ...') -> (az,
    el, inl, distance_ratio) per view."""
    out = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 4:
                out.append((float(p[0]), float(p[1]), float(p[2]),
                            float(p[3])))
    return out


def generate_object_views(images: list[np.ndarray],
                          metas: list[tuple[float, float, float, float]],
                          norm_params: np.ndarray, out_dir: str,
                          skip_existing: bool = True) -> list[str]:
    """One h5 per view, {out_dir}/{view:02d}.h5; returns the paths.
    norm_params is the [4] (centroid, m) of the object's SDF h5: both
    files must agree on the normalisation."""
    os.makedirs(out_dir, exist_ok=True)
    centroid = np.asarray(norm_params[:3], np.float64)
    m = float(norm_params[3])
    paths = []
    for i, (img, (az, el, inl, dist)) in enumerate(zip(images, metas)):
        path = os.path.join(out_dir, f"{i:02d}.h5")
        paths.append(path)
        if skip_existing and os.path.exists(path):
            continue
        rec = view_record_from_meta(img, az, el, dist, centroid, m, inl=inl)
        codecs.write_view_h5(path, rec)
    return paths
