"""Camera math: Blender-style projection, world->pixel matrix composition and
the point->pixel projector (port of disn_tpu/core/camera.py).

The composed world->pixel transform is a TRANSPOSED 4x3 matrix that
right-multiplies homogeneous points; the projector divides by the third
(depth) column and clamps to the image box. The host helpers are numpy in
float64, the projector is torch in float32.
"""
from __future__ import annotations

import numpy as np
import torch

# Blender intrinsics of the ShapeNet renderer.
F_MM = 35.0
SENSOR_SIZE_MM = 32.0
PIXEL_ASPECT_RATIO = 1.0
RESOLUTION_PCT = 100.0
SKEW = 0.0
CAM_MAX_DIST = 1.75

# Blender object->camera frame fix.
CAM_ROT = np.array(
    [
        [1.910685676922942e-15, 4.371138828673793e-08, 1.0],
        [1.0, -4.371138828673793e-08, -0.0],
        [4.371138828673793e-08, 1.0, -4.371138828673793e-08],
    ]
)

# Fixed 90-degree turn about y of the view-frame point rotation.
ROT90Y = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float32)


def blender_proj(az: float, el: float, distance_ratio: float,
                 img_w: int = 137, img_h: int = 137
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Intrinsics K (3x3) and extrinsics RT (3x4) from view metadata
    (azimuth/elevation in degrees, distance as a ratio of CAM_MAX_DIST)."""
    scale = RESOLUTION_PCT / 100.0
    f_u = F_MM * img_w * scale / SENSOR_SIZE_MM
    f_v = F_MM * img_h * scale * PIXEL_ASPECT_RATIO / SENSOR_SIZE_MM
    u_0 = img_w * scale / 2
    v_0 = img_h * scale / 2
    K = np.array([[f_u, SKEW, u_0], [0, f_v, v_0], [0, 0, 1]],
                 dtype=np.float64)

    sa, ca = np.sin(np.radians(-az)), np.cos(np.radians(-az))
    se, ce = np.sin(np.radians(-el)), np.cos(np.radians(-el))
    R_world2obj = np.array(
        [[ca * ce, -sa, ca * se], [sa * ce, ca, sa * se], [-se, 0, ce]]
    ).T
    R_obj2cam = CAM_ROT.T
    R_world2cam = R_obj2cam @ R_world2obj
    cam_location = np.array([[distance_ratio * CAM_MAX_DIST], [0.0], [0.0]])
    T_world2cam = -1 * R_obj2cam @ cam_location
    R_camfix = np.array([[1.0, 0, 0], [0, -1, 0], [0, 0, -1]])
    R_world2cam = R_camfix @ R_world2cam
    T_world2cam = R_camfix @ T_world2cam
    RT = np.hstack((R_world2cam, T_world2cam))
    return K, RT


def rotate_matrix(angle: float = -np.pi / 2) -> np.ndarray:
    """The fixed 4x4 model-frame rotation."""
    c, s = np.cos(angle), np.sin(angle)
    rx = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                  dtype=np.float64)
    rz = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                  dtype=np.float64)
    sy = np.diag([1.0, -1.0, 1.0, 1.0])
    neg = np.diag([-1.0, -1.0, -1.0, 1.0])
    return neg @ rz @ rz @ sy @ rx


def norm_matrix(centroid: np.ndarray, m: float) -> np.ndarray:
    """Unit-sphere de-normalization matrix T_inv @ M_inv."""
    M_inv = np.diag([m, m, m, 1.0])
    T_inv = np.eye(4)
    T_inv[:3, 3] = np.asarray(centroid, dtype=np.float64)
    return T_inv @ M_inv


def view_params_to_trans_mat(az: float, el: float, distance_ratio: float,
                             centroid: np.ndarray, m: float,
                             img_w: int = 137, img_h: int = 137
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """Full composition for one view: (trans_mat 4x3, regress_mat 4x3, K,
    RT), both matrices transposed for right-multiplication."""
    K, RT = blender_proj(az, el, distance_ratio, img_w=img_w, img_h=img_h)
    rot = rotate_matrix(-np.pi / 2)
    nm = norm_matrix(centroid, m)
    trans = np.linalg.multi_dot([K, RT, rot, nm])
    regress = np.linalg.multi_dot([RT, rot, nm])
    return (trans.T.astype(np.float32), regress.T.astype(np.float32),
            K.astype(np.float32), RT.astype(np.float32))


def obj_rot_matrix(az_deg: float, el_deg: float, inl_deg: float
                   ) -> np.ndarray:
    """View-frame rotation applied to the sample points when cfg.rot is
    set: ROT90Y @ (inl @ el @ az)^T, float32."""
    az = np.deg2rad(az_deg + 180.0)
    el = np.deg2rad(el_deg)
    inl = np.deg2rad(inl_deg)
    caz, saz = np.cos(az), np.sin(az)
    cel, sel = np.cos(el), np.sin(el)
    cin, sin_ = np.cos(inl), np.sin(inl)
    az_mat = np.array([[caz, 0, saz], [0, 1, 0], [-saz, 0, caz]],
                      dtype=np.float32)
    el_mat = np.array([[1, 0, 0], [0, cel, -sel], [0, sel, cel]],
                      dtype=np.float32)
    inl_mat = np.array([[cin, -sin_, 0], [sin_, cin, 0], [0, 0, 1]],
                       dtype=np.float32)
    cam_mat = (inl_mat @ el_mat @ az_mat).T
    return (ROT90Y @ cam_mat).astype(np.float32)


def project_points(sample_pc: torch.Tensor, trans_mat: torch.Tensor,
                   img_w: int = 137, img_h: int = 137) -> torch.Tensor:
    """Project [..., N, 3] points with a [..., 4, 3] matrix -> [..., N, 2]
    (x, y) pixel coordinates clamped to [0, img_w-1] x [0, img_h-1]:
    homogeneous append, matmul, divide by the z column, clamp.

    Float32 throughout, with the dot products written out term by term in
    the order the CUDA decode kernel evaluates them (no matmul, so no
    reduced-precision path can touch them: a bf16-rounded projection moves
    samples by ~0.3 px). NaN survives the clamp, as in jnp.clip."""
    pc = sample_pc.float()
    t = trans_mat.float()[..., None, :, :]  # broadcast over the point axis
    u = (pc[..., 0] * t[..., 0, 0] + pc[..., 1] * t[..., 1, 0]
         + pc[..., 2] * t[..., 2, 0] + t[..., 3, 0])
    v = (pc[..., 0] * t[..., 0, 1] + pc[..., 1] * t[..., 1, 1]
         + pc[..., 2] * t[..., 2, 1] + t[..., 3, 1])
    w = (pc[..., 0] * t[..., 0, 2] + pc[..., 1] * t[..., 1, 2]
         + pc[..., 2] * t[..., 2, 2] + t[..., 3, 2])
    return torch.stack([torch.clamp(u / w, 0.0, img_w - 1.0),
                        torch.clamp(v / w, 0.0, img_h - 1.0)], dim=-1)
