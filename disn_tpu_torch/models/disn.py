"""The DISN model graph (port of disn_tpu/models/disn.py): init of every
variant, the encoders (VGG-16, AlexNet, ResNet-18 by cfg.encoder) and the
image preprocessing (RGB, or RGBA with cfg.alpha), the forward pass
(the folded form that training runs for twostream + tf1, and the unfolded
form of every variant), the per-point local features and the two-stream
decode from given features (the multi-view general arm), and the loss.

Top-level param keys mirror the TF variable scopes (the encoder's
ENCODER_SCOPE, sdfprediction, sdfprediction_imgfeat, sdfimgfeat,
sdf3dcnn), so a JAX or TF checkpoint converts by name.
"""
from __future__ import annotations

from typing import Any

import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, EncoderKind, Variant
from disn_tpu_torch.core import camera
from disn_tpu_torch.models import encoders, layers, sdfnet, vgg
from disn_tpu_torch.ops import image as image_ops

Params = dict[str, Any]

ENCODER_SCOPE = {EncoderKind.VGG16: "vgg_16",
                 EncoderKind.ALEXNET: "alexnet",
                 EncoderKind.RESNET: "resnet_v1"}  # the TF scopes' names

# (init, apply, endpoint names) of each encoder
_ENCODERS = {
    EncoderKind.VGG16: (vgg.init, vgg.apply, vgg.ENDPOINTS),
    EncoderKind.ALEXNET: (encoders.init_alexnet, encoders.apply_alexnet,
                          encoders.ALEX_ENDPOINTS),
    EncoderKind.RESNET: (encoders.init_resnet, encoders.apply_resnet,
                         encoders.RESNET_ENDPOINTS)}


def endpoint_names(cfg: Config) -> tuple[str, ...]:
    """The encoder's endpoint maps used for local features, in concat
    order: all of them for twostream (VGG-16's five: 1472 channels at full
    width; AlexNet's five: 1376; ResNet's four stages: 960), the first
    three otherwise (448, 736, 448)."""
    names = _ENCODERS[cfg.encoder][2]
    return names if cfg.variant is Variant.TWOSTREAM else names[:3]


def compute_dtype(cfg: Config) -> torch.dtype:
    """bfloat16, float32, or float64: the port's training forward pass also
    runs in float64, where a card and the CPU round alike to 1e-16, so that
    chip_smoke.py can hold their gradients free of float32's ReLU flips."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.compute_dtype, torch.float32)


def init_encoder(cfg: Config, gen: torch.Generator,
                 device: torch.device) -> Params:
    """cfg.encoder's params for cfg.img_channels input channels."""
    return _ENCODERS[cfg.encoder][0](
        gen, device, in_channels=cfg.img_channels,
        num_classes=cfg.num_classes, width_mult=cfg.width_mult)


def init(cfg: Config, seed: int = 0,
         device: str | torch.device | None = None) -> Params:
    """Random params from a seeded torch.Generator on `device` (the GPU by
    default), the encoder under ENCODER_SCOPE[cfg.encoder]. The numbers
    differ from disn_tpu.models.disn.init's; tests share params through
    convert.params_from_jax."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {ENCODER_SCOPE[cfg.encoder]:
                      init_encoder(cfg, gen, dev)}
    g, b = cfg.num_classes, cfg.binary
    if cfg.variant in (Variant.TWOSTREAM, Variant.GLOBAL):
        params["sdfprediction"] = sdfnet.init_global_head(gen, dev, g, b)
    if cfg.variant is Variant.TWOSTREAM:
        params["sdfprediction_imgfeat"] = sdfnet.init_local_head(
            gen, dev, cfg.local_feat_dim, b)
    elif cfg.variant is Variant.ONESTREAM:
        params["sdfimgfeat"] = sdfnet.init_onestream_head(
            gen, dev, g, cfg.local_feat_dim, b)
    elif cfg.variant is Variant.THREEDCNN:
        params["sdf3dcnn"] = sdfnet.init_3dcnn_head(gen, dev, g, b)
    return params


def preprocess_image(img: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Resize [B,137,137,C] -> [B,224,224,C]: RGB by TF1 bilinear, and with
    cfg.alpha the alpha channel by TF1 nearest neighbour
    (model_normalization.py:65-73)."""
    if img.shape[1] == cfg.vgg_size and img.shape[2] == cfg.vgg_size:
        return img
    if cfg.alpha:
        rgb = image_ops.resize_bilinear(img[..., :3], cfg.vgg_size,
                                        cfg.vgg_size)
        a = image_ops.resize_nearest(img[..., 3:4], cfg.vgg_size,
                                     cfg.vgg_size)
        return torch.cat([rgb, a.to(rgb.dtype)], dim=-1)
    return image_ops.resize_bilinear(img, cfg.vgg_size, cfg.vgg_size)


def encode(params: Params, img: torch.Tensor, cfg: Config
           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Image [B,137,137,cfg.img_channels] (float in [0,1], or uint8,
    divided by 255 on the image's device) -> cfg.encoder's (embedding
    [B,num_classes], endpoints NHWC)."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    resized = preprocess_image(img, cfg)
    return _ENCODERS[cfg.encoder][1](params[ENCODER_SCOPE[cfg.encoder]],
                                     resized,
                                     compute_dtype=compute_dtype(cfg))


def apply(params: Params, batch: dict[str, torch.Tensor], cfg: Config, *,
          fold: bool = True) -> dict[str, torch.Tensor]:
    """Forward pass of a batch, differentiable in `params`.

    batch keys:
      img           [B,137,137,C] float in [0,1] (or uint8)
      sample_pc     [B,N,3] query points (model frame), projected
      sample_pc_rot [B,N,3] optional view-rotated copy fed to the MLPs
      trans_mat     [B,4,3] world->pixel right-multiply matrix
    Returns {"img_embedding", "pred_sdf" [B,N,1|2] ([B,65^3,1|2] for
    THREEDCNN)}, with "sample_img_points" for the variants that sample
    the image, and on the unfolded twostream arm "point_img_feat",
    "pred_sdf_value_global" and "pred_sdf_value_local", as the JAX dict.

    fold=True (the port's default; the JAX function's is False) takes the
    folded-137 form for twostream + tf1 sampling: the five endpoint maps
    and the per-point local_feat_dim->512 matmul collapse into one [B,137,137,512]
    map (infer/dense.fold_137), so a point samples 4 taps of it, and
    autograd scatters 4 rows per point back into it. Any other config
    falls through to the unfolded form, as in the JAX package, which is
    what lets the trainer (fold=True) train every variant."""
    # infer.dense imports this module, so it is imported here
    from disn_tpu_torch.infer import dense

    cd = compute_dtype(cfg)
    embedding, endpoints = encode(params, batch["img"], cfg)
    out: dict[str, torch.Tensor] = {"img_embedding": embedding}
    pts_dec = batch.get("sample_pc_rot", batch["sample_pc"])
    if cfg.variant is Variant.THREEDCNN:
        pred = sdfnet.apply_3dcnn_head(params["sdf3dcnn"], embedding, cd)
    elif cfg.variant is Variant.GLOBAL:
        # sample_pc, not the rotated copy, as the JAX function decodes it
        pred = sdfnet.apply_global_head(params["sdfprediction"],
                                        batch["sample_pc"], embedding, cd)
    else:
        img_points = camera.project_points(
            batch["sample_pc"], batch["trans_mat"], img_w=cfg.img_w,
            img_h=cfg.img_h)
        out["sample_img_points"] = img_points
        if (fold and cfg.variant is Variant.TWOSTREAM
                and cfg.sampling == "tf1"):
            folded = dense.fold_137(params, embedding, endpoints, cfg)
            local = image_ops.resampler(folded["fold137"], img_points)
            pred = sdfnet.apply_two_stream_prefold(
                params["sdfprediction"], params["sdfprediction_imgfeat"],
                pts_dec, folded["g_contrib"], local, cd)
        else:
            local = sample_local_features(endpoints, img_points, cfg)
            out["point_img_feat"] = local
            if cfg.variant is Variant.TWOSTREAM:
                pred_g = sdfnet.apply_global_head(
                    params["sdfprediction"], pts_dec, embedding, cd)
                pred_l = sdfnet.apply_local_head(
                    params["sdfprediction_imgfeat"], pts_dec, local, cd)
                out["pred_sdf_value_global"] = pred_g
                out["pred_sdf_value_local"] = pred_l
                pred = pred_g + pred_l
            else:
                pred = sdfnet.apply_onestream_head(
                    params["sdfimgfeat"], pts_dec, embedding, local, cd)
    if cfg.tanh:
        pred = torch.tanh(pred)
    out["pred_sdf"] = pred
    return out


def sample_local_features(endpoints: dict[str, torch.Tensor],
                          img_points: torch.Tensor, cfg: Config,
                          fused: bool = True) -> torch.Tensor:
    """Per-point multi-scale local features [B,N,cfg.local_feat_dim]: each
    endpoint map
    resized to 137^2 (TF1 bilinear) and resampled at the projected pixel
    coordinates (model_normalization.py:171-190). cfg.sampling 'native'
    samples the maps at their own scale instead; otherwise fused=True
    takes the 16-tap composition (ops/image.resize_then_sample) and
    fused=False makes the resized maps."""
    feats = []
    for name in endpoint_names(cfg):
        fmap = endpoints[name]
        if cfg.sampling == "native":
            feats.append(image_ops.sample_native(fmap, img_points, cfg.img_h,
                                                 cfg.img_w))
        elif fused:
            feats.append(image_ops.resize_then_sample(
                fmap, img_points, cfg.img_h, cfg.img_w))
        else:
            resized = image_ops.resize_bilinear(fmap, cfg.img_h, cfg.img_w)
            feats.append(image_ops.resampler(resized, img_points))
    return torch.cat(feats, dim=-1)


def decode_from_features(params: Params, pts: torch.Tensor,
                         embedding: torch.Tensor, local_feat: torch.Tensor,
                         cfg: Config) -> torch.Tensor:
    """The two unfolded streams from given features (get_decoder,
    model_normalization.py:223-238): pts [B,N,3], embedding [B,G],
    local_feat [B,N,cfg.local_feat_dim] -> [B,N,out] in the compute
    type."""
    cd = compute_dtype(cfg)
    g = sdfnet.apply_global_head(params["sdfprediction"], pts, embedding, cd)
    loc = sdfnet.apply_local_head(params["sdfprediction_imgfeat"], pts,
                                  local_feat, cd)
    return g + loc


def get_loss(end_points: dict[str, torch.Tensor], gt_sdf: torch.Tensor,
             params: Params, cfg: Config
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, {name: 0-d tensor}), in float32 (float64 in a float64 pass).

    Regression: L1 on (gt*10 - pred), near-surface points (gt <= 0.01)
    weighted x4, overall x1000. Binary: softmax cross-entropy on the sign
    labels x100. Plus the L2 weight decay when cfg.regularization is set.
    gt_sdf: [B,N,1], already iso-offset by the caller when training."""
    pred = image_ops.widen(end_points["pred_sdf"])
    gt_sdf = gt_sdf.to(pred.dtype)
    try:
        torch.broadcast_shapes(pred.shape[:-1], gt_sdf.shape[:-1])
    except RuntimeError:
        # THREEDCNN predicts its fixed 65^3 grid, not the sample points;
        # the JAX loss fails on the same broadcast
        raise ValueError(
            f"pred_sdf {tuple(pred.shape)} does not pair with the ground "
            f"truth {tuple(gt_sdf.shape)}: the loss compares values at the "
            f"batch's sample points (cfg.variant {cfg.variant.value})"
        ) from None
    losses: dict[str, torch.Tensor] = {}
    if cfg.binary:
        labels = (gt_sdf[..., 0] > 0).long()
        logp = torch.log_softmax(pred, dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])
        sdf_loss = torch.mean(ce) * 100.0
        losses["accuracy"] = torch.mean(
            (torch.argmax(pred, dim=-1) == labels).float())
    else:
        losses["accuracy"] = torch.mean(((gt_sdf > 0) == (pred > 0)).float())
        weight_mask = (torch.where(gt_sdf <= cfg.mask_margin,
                                   cfg.mask_weight, 0.0)
                       + torch.where(gt_sdf > cfg.mask_margin, 1.0, 0.0))
        sdf_loss = torch.mean(
            torch.abs(gt_sdf * cfg.sdf_weight - pred) * weight_mask) * 1000.0
        losses["sdf_loss_realvalue"] = torch.mean(
            torch.abs(gt_sdf - pred / cfg.sdf_weight))
    losses["sdf_loss"] = sdf_loss
    loss = sdf_loss
    if cfg.regularization:
        reg = layers.l2_regularizer(params, cfg.weight_decay)
        losses["regularization"] = reg
        loss = loss + reg
    losses["overall_loss"] = loss
    return loss, losses
