"""Edge inputs of K8 (the multi-view tap mean) for its CPU and card tests:
cameras under which points land exactly on a folded map's last row and
column, off the image, at infinity and on a NaN projection."""
import numpy as np


def edge_cameras(v: int) -> np.ndarray:
    """w = z + 1; view i maps x = 1 to u = (64 + 8i) + (72 - 8i) = 136
    exactly, the last column (y likewise: the last row): [V,4,3]."""
    t = np.zeros((v, 4, 3), np.float32)
    for i in range(v):
        t[i, 0, 0] = t[i, 1, 1] = 64 + 8 * i
        t[i, 2, 2] = 1.0
        t[i, 3] = [72 - 8 * i, 72 - 8 * i, 1.0]
    return t


# under edge_cameras: the last column, the last row, both, the corner
# pixel, off the image on each side (clamped), w = 0 with u, v != 0 (inf,
# clamped), and (x, y, z) = (-1.125, -1.125, -1): u = v = w = 0 in view 0,
# so its projection is NaN
EDGE_PTS = np.array([[1, 0.25, 0], [0.25, 1, 0], [1, 1, 0],
                     [-1.125, -1.125, 0], [2, 0.5, 0], [-3, 0.5, 0],
                     [0.5, 2, 0], [0.5, -3, 0], [5, 5, 0], [0.5, 0.5, -1],
                     [-1.125, -1.125, -1]], np.float32)
