"""Dense-grid SDF inference, fold='137' form (port of the twostream + tf1
path of disn_tpu/infer/dense.py).

fold='137': the reference's tf1 sampling (resize every endpoint map to
137x137, then resample) is linear in the map values, so the five endpoint
maps times their slices of the local fold2 weight collapse into ONE
[137,137,512] map built once per image; per point that leaves four
bilinear taps and the point MLPs. ``g_contrib = embedding @ W_g[512:]`` is
the global stream's per-image contribution.

``_decode_block`` is the plain per-point decode (the port uses it for the
three boundary planes); ``dense_sdf`` is the exact fallback that decodes
every cell through the fused kernel (infer/fused.dense_grid_via_cells).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import camera
from disn_tpu_torch.models import disn, sdfnet
from disn_tpu_torch.ops import image as image_ops

Params = dict[str, Any]


def scale_pred(pred: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Raw head output -> SDF value: pred/10, or (softmax_1 - 0.5)/10 for
    the binary head."""
    if cfg.binary:
        return (torch.softmax(pred, dim=-1)[..., 1] - 0.5) / cfg.sdf_weight
    return pred[..., 0] / cfg.sdf_weight


def normalize_fold(fold, cfg: Config) -> str:
    """Resolve a fold mode. The port implements '137' (twostream + tf1)."""
    if fold is None or fold == "auto":
        fold = ("137" if (cfg.variant is Variant.TWOSTREAM
                          and cfg.sampling == "tf1") else "none")
    if fold != "137":
        raise NotImplementedError(
            f"the port implements the fold='137' decode (twostream + tf1 "
            f"sampling); got fold={fold!r}")
    return fold


def fold_137(params: Params, embedding: torch.Tensor,
             endpoints: dict[str, torch.Tensor], cfg: Config
             ) -> dict[str, torch.Tensor]:
    """Endpoint maps of a batch of B images -> {"fold137": [B,137,137,512],
    "g_contrib": [B,512]}, both in the compute type.

    The resize is linear in the channels, so it commutes with the fold2
    slice's matmul; each map takes the order with fewer multiply-adds
    (``_resize_first``): conv1_2 and conv2_2 are resized at their 64 and
    128 channels, then folded at 137^2; the deeper maps are folded at their
    own size, then resized at 512 channels."""
    cd = disn.compute_dtype(cfg)
    _, w_local = sdfnet.split_local_fold2(params["sdfprediction_imgfeat"])
    w_local = w_local.to(cd)
    merged = None
    off = 0
    for n in disn.endpoint_names(cfg):
        x = endpoints[n].to(cd)
        c = x.shape[-1]
        w = w_local[off:off + c]
        off += c
        if _resize_first(x.shape[1], x.shape[2], c, w.shape[1], cfg):
            r = torch.matmul(
                image_ops.resize_bilinear(x, cfg.img_h, cfg.img_w), w)
        else:
            r = image_ops.resize_bilinear(torch.matmul(x, w), cfg.img_h,
                                          cfg.img_w)
        merged = r if merged is None else merged + r
    wg = params["sdfprediction"]["fold2"]["conv1"]["weights"]
    g_contrib = torch.matmul(embedding.to(cd), wg[512:].to(cd))
    return {"fold137": merged, "g_contrib": g_contrib}


def _resize_first(h: int, w: int, c: int, d: int, cfg: Config) -> bool:
    """Whether resizing an [h,w,c] map to 137^2 and then folding it to d
    channels takes fewer multiply-adds than the other order. The resize is
    two dense matmuls with the interpolation matrices: over the rows, then
    the columns."""
    oh, ow = cfg.img_h, cfg.img_w

    def resize(ch):
        return oh * h * w * ch + oh * ow * w * ch

    return resize(c) + oh * ow * c * d < h * w * c * d + resize(d)


def _prep(params: Params, img: torch.Tensor, cfg: Config,
          fold_local: str = "137"):
    """Encode the image once and fold its endpoints: (embedding,
    {"fold137", "g_contrib"})."""
    normalize_fold(fold_local, cfg)
    embedding, endpoints = disn.encode(params, img, cfg)
    return embedding, fold_137(params, embedding, endpoints, cfg)


def _decode_block(params: Params, endpoints: dict[str, torch.Tensor],
                  embedding: torch.Tensor | None, trans_mat: torch.Tensor,
                  pts: torch.Tensor, cfg: Config,
                  folded: str = "137") -> torch.Tensor:
    """[P,3] points -> [P] SDF values (compute type) for one image, by the
    plain per-point path: project, resample the folded map, prefold MLPs."""
    normalize_fold(folded, cfg)
    cd = disn.compute_dtype(cfg)
    pts_b = pts[None]
    px = camera.project_points(pts_b, trans_mat[None], img_w=cfg.img_w,
                               img_h=cfg.img_h)
    local_contrib = image_ops.resampler(endpoints["fold137"], px)
    pred = sdfnet.apply_two_stream_prefold(
        params["sdfprediction"], params["sdfprediction_imgfeat"], pts_b,
        endpoints["g_contrib"], local_contrib, cd)
    if cfg.tanh:
        pred = torch.tanh(pred)
    return scale_pred(pred, cfg)[0]


def as_inputs(img, trans_mat, sdf_params, dev: torch.device):
    """Host or device inputs -> (img [1,H,W,C], trans [4,3] f32, sdf_params
    [6] f32) on `dev`. u8 images stay u8 (normalised by disn.encode)."""
    img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                          else img).to(dev)
    if img.dim() == 3:
        img = img[None]
    trans = torch.as_tensor(trans_mat, dtype=torch.float32).to(dev)
    sdfp = torch.as_tensor(sdf_params, dtype=torch.float32).to(dev)
    return img, trans.contiguous(), sdfp.contiguous()


def dense_sdf(params: Params, img, trans_mat, sdf_params, cfg: Config,
              device: str | torch.device | None = None) -> torch.Tensor:
    """Image -> the exact [R,R,R] f32 volume (z,y,x indexed) on `device`:
    every stride-4 cell through the fused kernel, the three R-1 boundary
    planes through _decode_block."""
    from disn_tpu_torch.infer import fused

    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    img, trans, sdfp = as_inputs(img, trans_mat, sdf_params, dev)
    embedding, endpoints = _prep(params, img, cfg)
    return fused.dense_grid_via_cells(params, endpoints, trans, sdfp,
                                      cfg.grid_resolution, cfg)
