"""Debug/visual output writers (a copy of disn_tpu/utils/output.py, which
re-imagines the reference's utils/output_utils.py).

Colored point-cloud OBJ writers with a built-in magma-like colormap (the
reference pulls matplotlib's cm.magma, output_utils.py:114-124; matplotlib is
not a dependency here), bounding-box OBJ writer, and the train-time visual
dump of projected sample points drawn onto the input image
(train/train_sdf.py:403-428) as a PNG-free PPM (no cv2 dependency).
"""
from __future__ import annotations

import os

import numpy as np

# magma colormap anchor points (t, r, g, b) — interpolated linearly
_MAGMA = np.array([
    [0.00, 0.001, 0.000, 0.014],
    [0.25, 0.281, 0.059, 0.425],
    [0.50, 0.716, 0.215, 0.475],
    [0.75, 0.987, 0.536, 0.382],
    [1.00, 0.987, 0.991, 0.750],
])


def magma(t: np.ndarray) -> np.ndarray:
    """[N] in [0,1] -> [N,3] rgb."""
    t = np.clip(np.asarray(t, np.float64), 0.0, 1.0)
    out = np.empty(t.shape + (3,))
    for c in range(3):
        out[..., c] = np.interp(t, _MAGMA[:, 0], _MAGMA[:, c + 1])
    return out


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def save_colored_point_cloud(path: str, pts: np.ndarray,
                             colors: np.ndarray) -> None:
    """OBJ with per-vertex colors (v x y z r g b)."""
    _ensure_dir(path)
    with open(path, "w") as f:
        for p, c in zip(pts, colors):
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")


def save_scaled_point_cloud(path: str, pts: np.ndarray, values: np.ndarray,
                            lo: float | None = None,
                            hi: float | None = None) -> None:
    """Heat-map colored point cloud: values -> magma
    (output_scale_point_cloud, output_utils.py:114-124)."""
    v = np.asarray(values, np.float64).reshape(-1)
    lo = float(v.min()) if lo is None else lo
    hi = float(v.max()) if hi is None else hi
    t = (v - lo) / max(hi - lo, 1e-12)
    save_colored_point_cloud(path, pts, magma(t))


def save_bounding_box(path: str, lo: np.ndarray, hi: np.ndarray) -> None:
    """Wireframe bbox as an OBJ line set."""
    _ensure_dir(path)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7), (5, 1), (5, 4),
             (5, 7), (6, 2), (6, 4), (6, 7)]
    with open(path, "w") as f:
        for c in corners:
            f.write(f"v {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
        for a, b in edges:
            f.write(f"l {a + 1} {b + 1}\n")


def save_ppm(path: str, img: np.ndarray) -> None:
    """[H,W,3] float [0,1] or uint8 -> binary PPM (P6)."""
    _ensure_dir(path)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img[:, :, :3].tobytes())


def draw_points_on_image(img: np.ndarray, px: np.ndarray,
                         color=(1.0, 0.2, 0.2)) -> np.ndarray:
    """Splat projected (x, y) pixel points onto a copy of the image — the
    train-time camera-consistency visual (train/train_sdf.py:403-418)."""
    out = np.array(img[..., :3], np.float32, copy=True)
    h, w = out.shape[:2]
    xi = np.clip(np.round(px[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(px[:, 1]).astype(int), 0, h - 1)
    out[yi, xi] = color
    return out
