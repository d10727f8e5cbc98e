"""Camera math: Blender-style projection, world->pixel matrix composition,
the point->pixel projector and the camera net's rotation helpers (port of
disn_tpu/core/camera.py).

The composed world->pixel transform is a TRANSPOSED 4x3 matrix that
right-multiplies homogeneous points; the projector divides by the third
(depth) column and clamps to the image box. The host helpers are numpy in
float64, the projector and the rotation helpers are torch (float32, or
float64 on float64 inputs).
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

# Fixed intrinsics at 137x137: f_pix = 35 * 137 / 32, c = 68.5.
K_137 = np.array(
    [[149.84375, 0.0, 68.5], [0.0, 149.84375, 68.5], [0.0, 0.0, 1.0]],
    dtype=np.float32,
)

# Fixed 90-degree turn about y of the view-frame point rotation.
ROT90Y = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float32)

# Translation-head bias of the camera net (dataset statistics).
POSENET_T_BIAS = np.array([-0.00193892, 0.00169222, 1.3949631],
                          dtype=np.float32)


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


def compose_trans_mat(K: np.ndarray, RT: np.ndarray, rot_mat: np.ndarray,
                      norm_mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(trans_mat, regress_mat) = ((K RT rot norm)^T, (RT rot norm)^T),
    both 4x3 right-multiply matrices in float32."""
    trans = np.linalg.multi_dot([K, RT, rot_mat, norm_mat])
    regress = np.linalg.multi_dot([RT, rot_mat, norm_mat])
    return trans.T.astype(np.float32), regress.T.astype(np.float32)


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
    trans, regress = compose_trans_mat(K, RT, rot, nm)
    return trans, regress, K.astype(np.float32), RT.astype(np.float32)


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
                   img_w: int = 137, img_h: int = 137,
                   xyshift: torch.Tensor | None = None,
                   clamp: bool = True) -> torch.Tensor:
    """Project [..., N, 3] points with a [..., 4, 3] matrix -> [..., N, 2]
    (x, y) pixel coordinates clamped to [0, img_w-1] x [0, img_h-1]:
    homogeneous append, matmul, divide by the z column, clamp. clamp=False
    gives the raw projection (the camera net's 2D loss trains on it); a
    [..., 2] xyshift adds the camera net's half-image-relative shift,
    xyshift / 2 * img_h pixels, before the clamp.

    Float32 (float64 when an input is float64) throughout, with the dot
    products written out term by term in the order the CUDA decode kernel
    evaluates them (no matmul, so no reduced-precision path can touch
    them: a bf16-rounded projection moves samples by ~0.3 px). NaN
    survives the clamp, as in jnp.clip."""
    dt = torch.promote_types(
        torch.promote_types(sample_pc.dtype, trans_mat.dtype), torch.float32)
    pc = sample_pc.to(dt)
    t = trans_mat.to(dt)[..., None, :, :]  # broadcast over the point axis
    u = (pc[..., 0] * t[..., 0, 0] + pc[..., 1] * t[..., 1, 0]
         + pc[..., 2] * t[..., 2, 0] + t[..., 3, 0])
    v = (pc[..., 0] * t[..., 0, 1] + pc[..., 1] * t[..., 1, 1]
         + pc[..., 2] * t[..., 2, 1] + t[..., 3, 1])
    w = (pc[..., 0] * t[..., 0, 2] + pc[..., 1] * t[..., 1, 2]
         + pc[..., 2] * t[..., 2, 2] + t[..., 3, 2])
    x, y = u / w, v / w
    if xyshift is not None:
        shift = xyshift.to(dt)[..., None, :] / 2.0 * img_h
        x, y = x + shift[..., 0], y + shift[..., 1]
    if clamp:
        x = torch.clamp(x, 0.0, img_w - 1.0)
        y = torch.clamp(y, 0.0, img_h - 1.0)
    return torch.stack([x, y], dim=-1)


def ortho6d_to_rotation(poses: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt [B, 6] -> rotation matrices [B, 3, 3] whose COLUMNS are
    x, y, z: x = normalise(poses[:, :3]), z = normalise(x cross
    poses[:, 3:]), y = z cross x; norms are clamped at 1e-8."""
    def normalize(v):
        mag = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
        return v / torch.clamp(mag, min=1e-8)

    x = normalize(poses[:, 0:3])
    z = normalize(torch.linalg.cross(x, poses[:, 3:6], dim=1))
    y = torch.linalg.cross(z, x, dim=1)
    return torch.stack([x, y, z], dim=2)


def geodesic_distance(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Angle between rotation matrices [B, 3, 3]: arccos((tr(m1 m2^T) - 1)
    / 2), the cosine clipped to [-1, 1] first."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))
