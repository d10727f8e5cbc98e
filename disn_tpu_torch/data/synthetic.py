"""Synthetic fixtures (port of disn_tpu/data/synthetic.py): objects with
closed-form SDFs (sphere, box, torus), the reference's stratified band
sampling of them, a sphere-tracing renderer through the Blender camera, a
miniature ShapeNet-like dataset tree, the canonical test camera and the
analytic octahedron head.

The numpy code draws from numpy's RandomState in the JAX package's order,
so the same seed writes the same arrays.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import camera, codecs
from disn_tpu_torch.models import disn as disn_mod


# Analytic SDFs (normalized model frame, unit-ball scale)

def sdf_sphere(p: np.ndarray, r: float = 0.6) -> np.ndarray:
    return np.linalg.norm(p, axis=-1) - r


def sdf_box(p: np.ndarray, half: float = 0.45) -> np.ndarray:
    q = np.abs(p) - half
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def sdf_torus(p: np.ndarray, R: float = 0.5, r: float = 0.2) -> np.ndarray:
    qx = np.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - R
    return np.sqrt(qx ** 2 + p[..., 1] ** 2) - r


SHAPES = {
    "sphere0": sdf_sphere,
    "box0": sdf_box,
    "torus0": sdf_torus,
}

SYNTH_CAT = "99999999"  # synthetic category synset id


def numeric_normal(fn, p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    g = np.stack([
        fn(p + np.array(d) * eps) - fn(p - np.array(d) * eps)
        for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    ], axis=-1)
    n = np.linalg.norm(g, axis=-1, keepdims=True)
    return g / np.maximum(n, 1e-12)


def stratified_sample(fn, num: int = 32768, bandwidth: float = 0.1,
                      bbox: float = 1.0,
                      rng: np.random.RandomState | None = None
                      ) -> np.ndarray:
    """[num, 4] (x, y, z, sdf) samples in 4 SDF bands with 25% quotas and
    spill-over: (-inf,-bw], (-bw,0], (0,bw], (bw,inf). Candidates are
    uniform in the bbox cube, drawn until every band quota fills."""
    rng = rng or np.random.RandomState(0)
    quota = num // 4
    bands: list[list[np.ndarray]] = [[], [], [], []]
    counts = [0, 0, 0, 0]

    def band_of(v):
        return np.where(v <= -bandwidth, 0,
                        np.where(v <= 0, 1, np.where(v <= bandwidth, 2, 3)))

    for _ in range(200):
        pts = rng.uniform(-bbox, bbox,
                          size=(max(num, 16384), 3)).astype(np.float32)
        vals = fn(pts).astype(np.float32)
        b = band_of(vals)
        for i in range(4):
            need = quota - counts[i]
            if need > 0:
                sel = np.nonzero(b == i)[0][:need]
                if sel.size:
                    bands[i].append(np.concatenate(
                        [pts[sel], vals[sel, None]], axis=1))
                    counts[i] += sel.size
        if all(c >= quota for c in counts):
            break
    # spill-over: fill any shortfall with uniform candidates
    out = [np.concatenate(bs, axis=0) if bs else np.zeros((0, 4), np.float32)
           for bs in bands]
    total = sum(o.shape[0] for o in out)
    if total < num:
        pts = rng.uniform(-bbox, bbox,
                          size=(num - total, 3)).astype(np.float32)
        vals = fn(pts).astype(np.float32)
        out.append(np.concatenate([pts, vals[:, None]], axis=1))
    samples = np.concatenate(out, axis=0)[:num]
    rng.shuffle(samples)
    return samples


def surface_points(fn, num: int = 2048,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """Approximate surface samples: random points projected along the SDF
    gradient (valid for exact SDFs)."""
    rng = rng or np.random.RandomState(1)
    p = rng.uniform(-0.9, 0.9, size=(num, 3)).astype(np.float32)
    for _ in range(4):
        d = fn(p)[..., None]
        p = p - d * numeric_normal(fn, p)
    return p.astype(np.float32)


def render_view(fn, az: float, el: float, distance_ratio: float,
                img_h: int = 137, img_w: int = 137,
                color: tuple[float, float, float] = (0.55, 0.62, 0.8)
                ) -> tuple[np.ndarray, codecs.ViewRecord]:
    """One RGBA view and the camera record the view h5 stores, by sphere
    tracing in the normalized model frame: with P = K @ RT @ rot (centroid
    0, m 1), the ray of pixel (u, v) is X(t) = C + t * A^-1 K^-1 [u,v,1],
    A = (RT @ rot)[:, :3], C = -A^-1 b."""
    centroid = np.zeros(3)
    m = 1.0
    trans, regress, K, RT = camera.view_params_to_trans_mat(
        az, el, distance_ratio, centroid, m, img_w=img_w, img_h=img_h)
    M = RT.astype(np.float64) @ camera.rotate_matrix(-np.pi / 2)  # 3x4
    A, b = M[:, :3], M[:, 3]
    Ainv = np.linalg.inv(A)
    C = -Ainv @ b

    u, v = np.meshgrid(np.arange(img_w) + 0.5, np.arange(img_h) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    d = (Ainv @ np.linalg.inv(K.astype(np.float64)) @ pix.T).T
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    t = np.full(d.shape[0], 0.5)
    for _ in range(48):
        p = C + t[:, None] * d
        t = t + fn(p)
    p = C + t[:, None] * d
    hit = np.abs(fn(p)) < 5e-3

    img = np.zeros((img_h * img_w, 4), dtype=np.float32)
    if hit.any():
        n = numeric_normal(fn, p[hit])
        light = np.array([0.4, 0.6, 0.7])
        light /= np.linalg.norm(light)
        lam = np.clip(n @ light, 0.0, 1.0)[:, None]
        shade = 0.25 + 0.75 * lam
        img[hit, :3] = shade * np.asarray(color)
        img[hit, 3] = 1.0
    img8 = (img.reshape(img_h, img_w, 4) * 255).astype(np.uint8)
    rec = codecs.ViewRecord(
        img_arr=img8, trans_mat=trans, K=K, RT=RT,
        obj_rot_mat=camera.obj_rot_matrix(az, el, 0.0), regress_mat=regress)
    return img8, rec


def view_angles(view: int, views: int) -> tuple[float, float, float]:
    """(azimuth, elevation, distance ratio) of view `view` of `views`."""
    return 360.0 * view / views + 10.0, 25.0, 0.85


def build_dataset(root: str, shapes: dict | None = None, views: int = 4,
                  num_samples: int = 8192,
                  img_hw: tuple[int, int] = (137, 137), seed: int = 0,
                  splits: tuple[str, ...] = ("train", "test"),
                  grid_res: int = 32) -> dict:
    """Write a miniature dataset tree:

        <root>/filelists/<cat>_{train,test}.lst
        <root>/sdf/<cat>/<obj>/ori_sample.h5
        <root>/renders/<cat>/<obj>/<view:02d>.h5
        <root>/sdf_grids/<cat>/<obj>/grid.dist   (the dense GT grid)

    Returns an info dict with the paths and the analytic SDFs used."""
    shapes = shapes or SHAPES
    rng = np.random.RandomState(seed)
    img_h, img_w = img_hw
    os.makedirs(os.path.join(root, "filelists"), exist_ok=True)
    names = list(shapes)
    sdf_params = np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)
    for split in splits:
        with open(os.path.join(root, "filelists",
                               f"{SYNTH_CAT}_{split}.lst"), "w") as f:
            f.write("\n".join(names) + "\n")

    R = grid_res + 1
    lin = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    grid_pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)

    for obj, fn in shapes.items():
        samples = stratified_sample(fn, num=num_samples, rng=rng)
        surf = surface_points(fn, rng=rng)
        codecs.write_sdf_h5(
            os.path.join(root, "sdf", SYNTH_CAT, obj, "ori_sample.h5"),
            samples, norm_params=np.array([0, 0, 0, 1], np.float32),
            sdf_params=sdf_params, ori_pt=surf)
        gpath = os.path.join(root, "sdf_grids", SYNTH_CAT, obj)
        os.makedirs(gpath, exist_ok=True)
        codecs.write_dist(os.path.join(gpath, "grid.dist"), grid_res,
                          sdf_params, fn(grid_pts).astype(np.float32))
        for view in range(views):
            _, rec = render_view(fn, *view_angles(view, views), img_h=img_h,
                                 img_w=img_w)
            codecs.write_view_h5(
                os.path.join(root, "renders", SYNTH_CAT, obj,
                             f"{view:02d}.h5"), rec)
    return {
        "root": root,
        "lst_dir": os.path.join(root, "filelists"),
        "sdf_dir": os.path.join(root, "sdf"),
        "rendered_dir": os.path.join(root, "renders"),
        "grid_dir": os.path.join(root, "sdf_grids"),
        "cats": {"synthetic": SYNTH_CAT},
        "shapes": shapes,
        "views": views,
        "sdf_params": sdf_params,
    }


def memory_records(shapes: dict | None = None, views: int = 4,
                   num_samples: int = 8192, seed: int = 0
                   ) -> tuple[dict, dict]:
    """The records build_dataset(shapes, views, num_samples, seed=seed)
    writes, in memory, as the h5 readers return them: ({obj: SdfSamples},
    {(obj, view): ViewRecord}), float32 arrays (the files store float32).
    For machines without h5py."""
    shapes = shapes or SHAPES
    rng = np.random.RandomState(seed)
    box = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    sdf, recs = {}, {}
    for obj, fn in shapes.items():
        samples = stratified_sample(fn, num=num_samples,
                                    rng=rng).astype(np.float32)
        surf = surface_points(fn, rng=rng).astype(np.float32)
        sdf[obj] = codecs.SdfSamples(
            ori_pt=surf, sample_pt=samples[:, :3], sample_sdf=samples[:, 3],
            norm_params=np.array([0, 0, 0, 1], np.float32), sdf_params=box)
        for view in range(views):
            _, rec = render_view(fn, *view_angles(view, views))
            recs[(obj, view)] = codecs.ViewRecord(
                img_arr=rec.img_arr, trans_mat=rec.trans_mat.astype(
                    np.float32), K=rec.K.astype(np.float32),
                RT=rec.RT.astype(np.float32),
                obj_rot_mat=rec.obj_rot_mat.astype(np.float32),
                regress_mat=rec.regress_mat.astype(np.float32))
    return sdf, recs


def memory_dataset(cfg: Config, records: tuple[dict, dict], seed: int = 0,
                   listinfo: list | None = None):
    """The port's SdfImageDataset serving memory_records' `records`
    instead of h5 files, over `listinfo` ((SYNTH_CAT, object, view)
    entries; by default every pair the records hold, once)."""
    from disn_tpu_torch.data import pipeline

    sdf, recs = records

    class MemoryDataset(pipeline.SdfImageDataset):
        def _load_sdf(self, cat_id, obj):
            return sdf[obj]

        def _read_view(self, cat_id, obj, view):
            return recs[(obj, view)]

    if listinfo is None:
        listinfo = [(SYNTH_CAT, obj, view) for obj, view in recs]
    return MemoryDataset(cfg, None, listinfo, seed=seed)


def tiny_config(**kw) -> Config:
    """Config scaled for the synthetic fixture / CI-sized runs."""
    base = dict(batch_size=2, num_sample_points=256, cat_limit=64,
                sdf_res=16, view_num=4)
    base.update(kw)
    return Config(**base)


def demo_trans_mat() -> np.ndarray:
    """The canonical synthetic test camera: a Blender-protocol view at
    az=45, el=20, distance ratio 1.1. w > 0 over the whole [-1,1]^3 box
    (min 0.25 at the far corners) and the unit object fills px 15..122."""
    trans, _, _, _ = camera.view_params_to_trans_mat(
        45.0, 20.0, 1.1, np.zeros(3), 1.0, img_w=137, img_h=137)
    return np.ascontiguousarray(trans, dtype=np.float32)


def analytic_octahedron_params(cfg: Config, seed: int = 0, r: float = 0.6,
                               gain: float = 1.0,
                               center: tuple = (0.0, 0.0, 0.0),
                               device: str | torch.device | None = None
                               ) -> dict:
    """Full TWOSTREAM param tree whose decode computes EXACTLY
    10*gain*(|x-cx|+|y-cy|+|z-cz| - r) (the L1-ball field) whatever the
    image: the global stream's ReLU chain builds |t| and the sum, the local
    stream's output layer is zeroed. The encoder and the rest of the local
    stream keep their random (seeded) weights, so every layer still runs.
    With cfg.binary the head emits logits (0, 10(s-r))."""
    if cfg.variant is not Variant.TWOSTREAM:
        raise ValueError("analytic params exist for the twostream variant "
                         "only")
    params = disn_mod.init(cfg, seed=seed, device=device)
    g = params["sdfprediction"]
    last = "conv5_bi" if cfg.binary else "conv5"

    def zeros_like(t):
        return np.zeros(tuple(t.shape), np.float32)

    w1 = zeros_like(g["fold1"]["conv1"]["weights"])   # [3, 64]
    for i in range(3):
        w1[i, 2 * i] = 1.0
        w1[i, 2 * i + 1] = -1.0                       # relu(+-t) pairs
    w2 = zeros_like(g["fold1"]["conv2"]["weights"])   # [64, 256]
    w2[0:6, 0] = 1.0                                  # s = |x|+|y|+|z|
    w3 = zeros_like(g["fold1"]["conv3"]["weights"])   # [256, 512]
    w3[0, 0] = 1.0
    wc1 = zeros_like(g["fold2"]["conv1"]["weights"])  # [512+1024, 512]
    wc1[0, 0] = 1.0                                   # point part first
    wc2 = zeros_like(g["fold2"]["conv2"]["weights"])  # [512, 256]
    wc2[0, 0] = 1.0
    w5 = zeros_like(g["fold2"][last]["weights"])      # [256, 1|2]
    b5 = zeros_like(g["fold2"][last]["biases"])
    if cfg.binary:
        w5[0, 1] = 10.0 * gain
        b5[1] = -10.0 * gain * r
    else:
        w5[0, 0] = 10.0 * gain                        # undo scale_pred /10
        b5[0] = -10.0 * gain * r
    b1 = zeros_like(g["fold1"]["conv1"]["biases"])
    for i in range(3):                                # |t - c| pairs
        b1[2 * i] = -center[i]
        b1[2 * i + 1] = center[i]
    dev = g["fold1"]["conv1"]["weights"].device

    def put(a):
        return torch.from_numpy(a).to(dev)

    for (a, b), w in {("fold1", "conv1"): w1, ("fold1", "conv2"): w2,
                      ("fold1", "conv3"): w3, ("fold2", "conv1"): wc1,
                      ("fold2", "conv2"): wc2, ("fold2", last): w5}.items():
        g[a][b]["weights"] = put(w)
        g[a][b]["biases"] = torch.zeros_like(g[a][b]["biases"])
    g["fold2"][last]["biases"] = put(b5)
    g["fold1"]["conv1"]["biases"] = put(b1)
    loc = params["sdfprediction_imgfeat"]
    loc["fold2"][last]["weights"] = torch.zeros_like(
        loc["fold2"][last]["weights"])
    for scope, name in (("fold2", last), ("fold2", "conv2"),
                        ("fold2", "conv1"), ("fold1", "conv1"),
                        ("fold1", "conv2"), ("fold1", "conv3")):
        loc[scope][name]["biases"] = torch.zeros_like(
            loc[scope][name]["biases"])
    return params
