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


CELL_STEP = 1.0 / 256   # the spacing of a 257^3 grid's points in [-1,1]


def cell(x: float, y: float, z: float) -> np.ndarray:
    """A fine cell's 64 points from corner (x, y, z), x fastest, as
    fused_decode.cell_points orders them: [64,3]."""
    o = np.arange(4) * CELL_STEP
    zz, yy, xx = np.meshgrid(o + z, o + y, o + x, indexing="ij")
    return np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)


def plan_tiles() -> tuple[np.ndarray, list]:
    """Six 64-point tiles under edge_cameras (any V) and whether K8 stages
    each at PLAN_STAGE_PX pixels a stage: an interior cell (a 2-3 px box),
    a cell on the last column (x0 = 136: its box reads the clamped taps
    alone), a cell at pixel (0, 0) whose last point is the NaN one (its
    box covers pixel 0: staged), an interior cell with the NaN point (the
    box spans pixel 0 to the cell: direct), 64 random points in [-1,1]^3
    (direct), and a partial last tile of 10 interior points. [330,3]."""
    interior = cell(0.0, 0.0, 0.0)
    nan_staged = cell(-1.125, -1.125, 0.0)
    nan_staged[-1] = EDGE_PTS[-1]
    nan_direct = interior.copy()
    nan_direct[-1] = EDGE_PTS[-1]
    scattered = np.random.RandomState(0).uniform(-1, 1, (64, 3))
    pts = np.concatenate([interior, cell(1 - 3 * CELL_STEP, 0.25, 0.0),
                          nan_staged, nan_direct,
                          scattered.astype(np.float32), interior[:10]])
    return pts, [True, True, True, False, False, True]


PLAN_STAGE_PX = 32
