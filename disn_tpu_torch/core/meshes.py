"""Triangle-mesh helpers shared by the evaluation samplers (a copy of
disn_tpu/core/meshes.py)."""
from __future__ import annotations

import numpy as np


def triangle_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """Area-weighted uniform surface sampling [n,3] (sqrt-warped
    barycentric coordinates)."""
    rng = rng or np.random.RandomState(0)
    areas = triangle_areas(verts, faces)
    p = areas / max(areas.sum(), 1e-12)
    fi = rng.choice(len(faces), size=n, p=p)
    v0, v1, v2 = verts[faces[fi, 0]], verts[faces[fi, 1]], verts[faces[fi, 2]]
    r1 = np.sqrt(rng.rand(n, 1)).astype(np.float32)
    r2 = rng.rand(n, 1).astype(np.float32)
    return ((1 - r1) * v0 + r1 * (1 - r2) * v1 + r1 * r2 * v2
            ).astype(np.float32)
