"""Closed-loop metric parity (port of scripts/closed_loop_parity.py): the
production image -> mesh path at 257^3 against the analytic ground truth,
through the reference's whole metric protocol (CD x 1000 and EMD x 0.01 on
2048 surface samples, F-score at {0.5, 1, 2, 5, 10, 20}% x 2.5, IoU at
dim 110).

The analytic octahedron head decodes |x|+|y|+|z| - 0.6 exactly whatever
the image, so the whole path (K1, the sparse cull, K5, the record route's
host assembly) is scored against exact geometry: the ground-truth mesh is
the owned extractor's on that field, and the noise floor is two samplings
of the ground-truth mesh (RandomState 0 and 1).

Two rows, the reference demo's two camera modes:
  gt-cam : the demo camera feeds image_to_mesh (a seeded random image);
  cam-est: the bundled camera net (demo/tiny_posenet.npz, width 0.25, 128
           classes) estimates the camera of a torus render at an azimuth
           it was not trained on (152, el 25, distance 0.85), and that
           matrix feeds the same pipeline; the camera's error is reported
           with the reference's distances (rot3d, rot2d).

    python -m disn_tpu_torch.tools.closed_loop [gt-cam|cam-est|both]
        [--sdf-res 256] [--device cpu] [--json OUT]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.eval import metrics
from disn_tpu_torch.eval.runner import F_THRESHOLDS, SIDE_LEN
from disn_tpu_torch.ops import marching, voxelize

SDFP = np.array([-1, -1, -1, 1, 1, 1], np.float32)
OCTA_R = 0.6
N_POINTS = 2048
IOU_DIM = 110
POSENET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "demo", "tiny_posenet.npz")
CAM_VIEW = dict(az=152.0, el=25.0, distance_ratio=0.85)


def analytic_field(R: int, r: float = OCTA_R) -> np.ndarray:
    """The exact field |x|+|y|+|z| - r on the [-1,1]^3 grid of R points a
    side, [R,R,R] f32 (z,y,x)."""
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    return (np.abs(x) + np.abs(y) + np.abs(z) - r).astype(np.float32)


def gt_mesh(R: int = 257, device: str | torch.device | None = None
            ) -> tuple[np.ndarray, np.ndarray]:
    """The ground-truth mesh: the owned extractor on analytic_field(R)."""
    return marching.extract_mesh_owned(analytic_field(R), SDFP,
                                       device=device)


def score(pv, pf, gv, gf, device: str | torch.device | None = None
          ) -> dict:
    """The reference protocol between a predicted and a ground-truth mesh:
    2048 surface samples of each (RandomState 0 and 1), CD x 1000 and EMD
    x 0.01 on `device` (K6a-K6c on a card), their noise floor (the
    ground-truth mesh sampled with RandomState 0 against its RandomState 1
    samples), F1 at F_THRESHOLDS x SIDE_LEN, and the host IoU at dim 110."""
    dev = device_mod.resolve(device)
    pv, gv = np.asarray(pv, np.float32), np.asarray(gv, np.float32)
    pf, gf = np.asarray(pf), np.asarray(gf)
    ps = metrics.sample_mesh_surface(pv, pf, N_POINTS,
                                     np.random.RandomState(0))
    gs = metrics.sample_mesh_surface(gv, gf, N_POINTS,
                                     np.random.RandomState(1))
    gs0 = metrics.sample_mesh_surface(gv, gf, N_POINTS,
                                      np.random.RandomState(0))
    p, g, g0 = (torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                 )[None].to(dev) for a in (ps, gs, gs0))
    ths = np.asarray(F_THRESHOLDS, np.float32) * 0.01 * SIDE_LEN
    with torch.no_grad():
        ce = metrics.chamfer_emd(p, g)
        floor = metrics.chamfer_emd(g0, g)
        f1 = metrics.f_score(p, g, ths)["f1"][:, 0]
    iou = voxelize.iou_meshes((pv, pf), (gv, gf), dim=IOU_DIM)
    return {"cd": float(ce["cd"][0]), "emd": float(ce["emd"][0]),
            "cd_floor": float(floor["cd"][0]),
            "emd_floor": float(floor["emd"][0]),
            "f1": [float(x) for x in f1.cpu()], "iou": float(iou)}


def score_vs_analytic(pv, pf, R: int = 257,
                      device: str | torch.device | None = None) -> dict:
    """score() of a predicted octahedron mesh against gt_mesh(R), with the
    ground truth's vertex and face counts."""
    gv, gf = gt_mesh(R, device=device)
    out = score(pv, pf, gv, gf, device=device)
    out.update(gt_verts=len(gv), gt_faces=len(gf))
    return out


def _reconstruct(cfg: Config, img, trans, dev: torch.device) -> dict:
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    params = synthetic.analytic_octahedron_params(cfg, r=OCTA_R, device=dev)
    stats: dict = {}
    t0 = time.perf_counter()
    pv, pf = pipeline.image_to_mesh(params, img, trans, cfg,
                                    sdf_params=SDFP, device=dev, stats=stats)
    wall = (time.perf_counter() - t0) * 1e3
    out = score_vs_analytic(pv, pf, R=cfg.grid_resolution, device=dev)
    out.update(verts=len(pv), faces=len(pf), route=stats["route"],
               wall_ms=wall)
    return out


def gt_cam_row(cfg: Config | None = None,
               device: str | torch.device | None = None) -> dict:
    """The gt-cam row: image_to_mesh (sdf_res 256, bf16, full width by
    default) on a RandomState(0) image with the demo camera, scored."""
    from disn_tpu_torch.data import synthetic

    cfg = cfg or Config(sdf_res=256, compute_dtype="bfloat16")
    dev = device_mod.resolve(device)
    img = np.random.RandomState(0).rand(1, cfg.img_h, cfg.img_w,
                                        3).astype(np.float32)
    out = _reconstruct(cfg, img, synthetic.demo_trans_mat(), dev)
    out["row"] = "gt-cam"
    return out


def cam_est_camera(cfg: Config, device: str | torch.device | None = None
                   ) -> dict:
    """The bundled camera net (restored through the port's converter) on
    the torus render at CAM_VIEW: ``img`` [137,137,3] f32, the net's
    ``pred_trans_mat`` [4,3], and the reference's camera distances on 2048
    torus surface points (RandomState 7): ``rot3d`` the mean distance
    between the points moved by pred_RT and by the view's regress_mat,
    ``rot2d`` the mean distance in pixels between their projections by
    the predicted and the true trans_mat."""
    from disn_tpu_torch import convert
    from disn_tpu_torch.core import camera
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.models import posenet

    dev = device_mod.resolve(device)
    donor = convert.load_npz(POSENET)
    cam = device_mod.tree_to(donor.get("params", donor), dev)
    torus = synthetic.SHAPES["torus0"]
    img8, rec = synthetic.render_view(torus, **CAM_VIEW)
    img = img8[..., :3].astype(np.float32) / 255.0
    with torch.no_grad():
        out = posenet.apply(cam, torch.from_numpy(img[None]).to(dev), cfg)
    pred_trans = out["pred_trans_mat"][0].float().cpu().numpy()
    pred_rt = out["pred_RT"][0].float().cpu().numpy()
    pc = synthetic.surface_points(torus, num=2048,
                                  rng=np.random.RandomState(7))
    homo = np.concatenate([pc, np.ones((len(pc), 1), np.float32)], axis=1)
    rot3d = float(np.mean(np.linalg.norm(
        homo @ pred_rt - homo @ rec.regress_mat, axis=-1)))
    pc_t = torch.from_numpy(pc[None])
    gt_xy = camera.project_points(pc_t, torch.from_numpy(
        rec.trans_mat[None].astype(np.float32)), cfg.img_w, cfg.img_h)
    pred_xy = camera.project_points(pc_t, torch.from_numpy(
        pred_trans[None]), cfg.img_w, cfg.img_h)
    rot2d = float(torch.linalg.norm(pred_xy - gt_xy, dim=-1).mean())
    return {"img": img, "pred_trans_mat": pred_trans, "rot3d": rot3d,
            "rot2d": rot2d}


def cam_est_row(cfg: Config | None = None,
                device: str | torch.device | None = None) -> dict:
    """The cam-est row: cam_est_camera, then image_to_mesh (sdf_res 256,
    bf16, width 0.25 and 128 classes by default: the camera net's) with
    the predicted matrix, scored."""
    cfg = cfg or Config(sdf_res=256, compute_dtype="bfloat16",
                        width_mult=0.25, num_classes=128)
    dev = device_mod.resolve(device)
    cam = cam_est_camera(cfg, dev)
    out = _reconstruct(cfg, cam["img"][None], cam["pred_trans_mat"], dev)
    out.update(row="cam-est", pred_trans_mat=cam["pred_trans_mat"].tolist(),
               rot3d=cam["rot3d"], rot2d=cam["rot2d"])
    return out


def report(row: dict) -> str:
    """The script's lines for one row."""
    tag = f"[{row['row']}]"
    lines = [f"{tag} pred mesh: {row['verts']} verts {row['faces']} tris "
             f"(route {row['route']}, {row['wall_ms']:.1f} ms, first call); "
             f"gt mesh: {row['gt_verts']} verts {row['gt_faces']} tris",
             f"{tag} CD*1000={row['cd']:.4f} (noise floor "
             f"{row['cd_floor']:.4f})  EMD*0.01={row['emd']:.4f} (floor "
             f"{row['emd_floor']:.4f})  IoU({IOU_DIM})={row['iou']:.4f}",
             f"{tag} F1 @ {{0.5,1,2,5,10,20}}%x2.5: "
             + " ".join(f"{v:.4f}" for v in row["f1"])]
    if "rot3d" in row:
        lines.insert(0, f"{tag} camera net's error: rot3d_dist="
                        f"{row['rot3d']:.4f} rot2d_dist={row['rot2d']:.2f}px "
                        f"(137 px frame)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="both",
                    choices=("both", "gt-cam", "cam-est"))
    ap.add_argument("--sdf-res", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (the GPU by default)")
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    rows = []
    if args.which in ("both", "gt-cam"):
        rows.append(gt_cam_row(Config(sdf_res=args.sdf_res,
                                      compute_dtype="bfloat16"),
                               device=args.device))
        print(report(rows[-1]), flush=True)
    if args.which in ("both", "cam-est"):
        rows.append(cam_est_row(Config(sdf_res=args.sdf_res,
                                       compute_dtype="bfloat16",
                                       width_mult=0.25, num_classes=128),
                                device=args.device))
        print(report(rows[-1]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
