"""The camera pose net (port of disn_tpu/models/posenet.py).

From the VGG-16 embedding of an RGB image, four MLP heads predict a scale
(1024 -> 64 -> 32 -> 1, scaling the rotation), a rotation (1024 -> 512 ->
256 -> 6, Gram-Schmidt to a matrix), a translation (1024 -> 128 -> 64 -> 3,
plus the fixed POSENET_T_BIAS) and, with cfg.cam_shift, a 2-DoF pixel shift
(1024 -> 128 -> 64 -> 2). pred_RT = concat(scale * R, t) is a [B,4,3]
right-multiply matrix and pred_trans_mat = pred_RT @ K^T.

Param keys are the JAX package's (vgg_16, cameraprediction/{scale,
ortho6d, translation, xyshift}/fc1..fc3), so its trees convert by name.
The heads compute in float32 (float64 when cfg.compute_dtype is float64),
whatever the encoder's compute type.
"""
from __future__ import annotations

from typing import Any

import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import camera
from disn_tpu_torch.models import disn, layers, vgg

Params = dict[str, Any]

# (head, hidden widths, output width) in the order the heads are drawn
_HEADS = (("scale", (64, 32), 1), ("ortho6d", (512, 256), 6),
          ("translation", (128, 64), 3))
_SHIFT_HEAD = ("xyshift", (128, 64), 2)


def init_heads(gen: torch.Generator, device: torch.device,
               global_dim: int = 1024, shift: bool = False) -> Params:
    """The heads' params; the translation head's last kernel is a
    truncated normal with stddev 0.05, the rest Xavier uniform."""
    params: Params = {}
    for name, (h1, h2), out in _HEADS + ((_SHIFT_HEAD,) if shift else ()):
        params[name] = {
            "fc1": layers.init_dense(gen, global_dim, h1, device),
            "fc2": layers.init_dense(gen, h1, h2, device),
            "fc3": layers.init_dense(
                gen, h2, out, device,
                stddev=0.05 if name == "translation" else None)}
    return params


def init(cfg: Config, seed: int = 0,
         device: str | torch.device | None = None) -> Params:
    """Random params from a seeded torch.Generator on `device` (the GPU by
    default). The numbers differ from disn_tpu.models.posenet.init's; tests
    share params through convert.params_from_jax."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "vgg_16": vgg.init(gen, dev, in_channels=3,
                           num_classes=cfg.num_classes,
                           width_mult=cfg.width_mult),
        "cameraprediction": init_heads(gen, dev, cfg.num_classes,
                                       shift=cfg.cam_shift),
    }


def _head_dtype(cfg: Config) -> torch.dtype:
    return torch.float64 if cfg.compute_dtype == "float64" else torch.float32


def _head(p: Params, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    h = layers.dense(p["fc1"], x, compute_dtype=cd)
    h = layers.dense(p["fc2"], h, compute_dtype=cd)
    return layers.dense(p["fc3"], h, relu=False, compute_dtype=cd)


def apply_heads(params: Params, embedding: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32
                ) -> dict[str, torch.Tensor]:
    """embedding [B,G] -> {"pred_rotation" [B,3,3] (scaled),
    "pred_translation" [B,3], "pred_RT" [B,4,3]} and "pred_xyshift" [B,2]
    when the params have the shift head."""
    b = embedding.shape[0]
    cd = compute_dtype
    scale = _head(params["scale"], embedding, cd).reshape(b, 1, 1)
    rot6d = _head(params["ortho6d"], embedding, cd)
    bias = torch.as_tensor(camera.POSENET_T_BIAS, device=embedding.device)
    trans = _head(params["translation"], embedding, cd) + bias.to(cd)
    R = scale * camera.ortho6d_to_rotation(rot6d)
    out = {"pred_rotation": R, "pred_translation": trans,
           "pred_RT": torch.cat([R, trans[:, None, :]], dim=1)}
    if "xyshift" in params:
        out["pred_xyshift"] = _head(params["xyshift"], embedding, cd)
    return out


def encode(params: Params, img: torch.Tensor, cfg: Config
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The VGG-16 encoder on the image's RGB channels (any alpha channel
    dropped, and the image preprocessed as RGB: cfg.replace(alpha=False),
    as the JAX package encodes), in cfg's compute type, whatever cfg's
    variant or encoder: (embedding [B,num_classes], endpoints)."""
    img = img[..., :3]
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    rgb = cfg.replace(alpha=False)
    return vgg.apply(params["vgg_16"], disn.preprocess_image(img, rgb),
                     compute_dtype=disn.compute_dtype(rgb))


def apply(params: Params, img: torch.Tensor, cfg: Config,
          K: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """img [B,137,137,3|4] (float in [0,1], or uint8) -> apply_heads' dict
    plus "embedding" and "pred_trans_mat" [B,4,3] = pred_RT @ K^T (K_137
    by default), differentiable in `params`."""
    embedding, _ = encode(params, img, cfg)
    cd = _head_dtype(cfg)
    out = apply_heads(params["cameraprediction"], embedding, cd)
    out["embedding"] = embedding
    if K is None:
        K = torch.as_tensor(camera.K_137, device=embedding.device)
    out["pred_trans_mat"] = out["pred_RT"] @ K.to(cd).T
    return out


@torch.no_grad()
def predict_trans_mat(params: Params, img, cfg: Config,
                      device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """Images [B,137,137,C] (numpy or tensor, uint8 or float) -> the
    predicted cameras [B,4,3] float32 on `device` (the GPU by default),
    without gradients. `params` are moved to `device` (no copy for those
    already there)."""
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    img = torch.as_tensor(img).to(dev)
    return apply(params, img, cfg)["pred_trans_mat"].float()


def get_loss(end_points: dict[str, torch.Tensor],
             batch: dict[str, torch.Tensor], params: Params, cfg: Config,
             sum_scale: float = 1.0
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Camera losses: (loss, {name: 0-d tensor}).

    batch: sample_pc [B,N,3], RT [B,4,3] (the view's regress_mat),
    trans_mat [B,4,3], optional shifts [B,2]. tf.nn.l2_loss halves a sum
    of squares:
      rotpc_loss     l2 of homo_pc @ pred_RT - homo_pc @ RT
      rot2d_loss     l2 of the UNCLAMPED projections' difference / 1e4
                     (clamping would zero the gradient of every point an
                     early prediction puts outside the image)
      rotmatrix_loss mean square of pred_trans_mat - trans_mat
      rot3d_dist, rot2d_dist  mean point distances (the 2D one between
                     clamped projections), reported, not trained on
    cam_loss_mode: 3D = rotpc; 2D = rot2d; 3DM = rotpc + 0.3 rotmatrix;
    all = the three summed. With cfg.cam_shift the GT projection carries
    the batch's shifts and the shift head's l2 (x shift_weight) is added;
    with cfg.regularization the encoder's L2 term.

    The terms that sum over the batch (rotpc, rot2d, shiftxy) are
    multiplied by sum_scale: a data-parallel rank that holds 1/n of the
    batch passes n, so that the mean of every term over the ranks is the
    whole batch's, as is the mean of the gradients."""
    pred_RT = end_points["pred_RT"]
    pred_trans_mat = end_points["pred_trans_mat"]
    dt = pred_RT.dtype
    sample_pc = batch["sample_pc"].to(dt)
    RT = batch["RT"].to(dt)
    trans_mat = batch["trans_mat"].to(dt)

    ones = torch.ones(sample_pc.shape[:-1] + (1,), dtype=dt,
                      device=sample_pc.device)
    homo = torch.cat([sample_pc, ones], dim=-1)
    sub_3d = homo @ pred_RT - homo @ RT

    xyshift = end_points.get("pred_xyshift")
    gt_shift = batch.get("shifts") if cfg.cam_shift else None
    kw = dict(img_w=cfg.img_w, img_h=cfg.img_h)
    gt_xy_raw = camera.project_points(sample_pc, trans_mat, clamp=False,
                                      xyshift=gt_shift, **kw)
    pred_xy_raw = camera.project_points(sample_pc, pred_trans_mat,
                                        clamp=False, xyshift=xyshift, **kw)
    gt_xy_cl = camera.project_points(sample_pc, trans_mat, xyshift=gt_shift,
                                     **kw)
    pred_xy_cl = camera.project_points(sample_pc, pred_trans_mat,
                                       xyshift=xyshift, **kw)

    rotpc_loss = torch.sum(torch.square(sub_3d)) / 2.0 * sum_scale
    losses: dict[str, torch.Tensor] = {
        "rotpc_loss": rotpc_loss,
        "rot2d_loss": torch.sum(torch.square(pred_xy_raw - gt_xy_raw))
        / 2.0 / 1e4 * sum_scale,
        "rotmatrix_loss": torch.mean(torch.square(pred_trans_mat
                                                  - trans_mat)),
        "rot3d_dist": torch.mean(torch.sqrt(torch.sum(
            torch.square(sub_3d), dim=-1))),
        "rot2d_dist": torch.mean(torch.sqrt(torch.sum(
            torch.square(pred_xy_cl - gt_xy_cl), dim=-1))),
    }
    mode = cfg.cam_loss_mode
    if mode == "3D":
        loss = rotpc_loss
    elif mode == "2D":
        loss = losses["rot2d_loss"]
    elif mode == "3DM":
        loss = rotpc_loss + losses["rotmatrix_loss"] * 0.3
    else:
        loss = (losses["rot2d_loss"] + rotpc_loss
                + losses["rotmatrix_loss"])
    if cfg.cam_shift and xyshift is not None and "shifts" in batch:
        shift_loss = torch.sum(torch.square(batch["shifts"].to(dt)
                                            - xyshift)) / 2.0 * sum_scale
        losses["shiftxy_loss"] = shift_loss
        loss = loss + shift_loss * cfg.shift_weight
    if cfg.regularization:
        reg = layers.l2_regularizer(params["vgg_16"], cfg.weight_decay)
        losses["regularization"] = reg
        loss = loss + reg
    losses["overall_loss"] = loss
    return loss, losses
