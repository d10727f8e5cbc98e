"""Multi-view fused reconstruction (port of disn_tpu/infer/multiview.py: the
reference's --multi_view path, placeholder_features + get_decoder,
models/model_normalization.py:38-45, 84-90, 223-238).

Each of an object's V views is encoded once; per query point the global
embeddings and the per-view local features (each view sampled through its
own trans_mat) are averaged, and the averages are decoded by the same two
MLP streams into one volume.

Folded arm (two-stream net, tf1 sampling): each view's endpoint maps and
the local fold2 slice collapse into one [137,137,512] map
(infer/dense.fold_137), and since sampling and the fold are linear, the
averaged local contribution is the mean of the V folded-map samples: per
point, V x 4 taps of 512 channels, their mean in float32, then the point
MLPs (sdfnet.apply_two_stream_prefold). General arm (native sampling):
per-view features through ops/image.sample_native or resize_then_sample,
their mean, then the unfolded streams (disn.decode_from_features).

On the card the folded arm's tap mean (projection, V x 4 taps, the f32
mean: XLA's fusion in the reference) is one launch of K8
(ops/mv_taps.mv_tap_mean, csrc/mv_taps.cu); the MLPs are PyTorch ops, as
the reference leaves them to XLA. The fused-decode kernel takes one map
and one camera, and here the mean over the views comes before the MLP's
nonlinearity. The general arm is PyTorch ops.

The sparse flow has the reference's two phases, run eagerly: phase_a
(encode and fold the views, decode the coarse (R-1)/s+1 grid, the cull
band, the active coarse cells: 'sign' for binary heads, else 'band') and
finish (decode exactly the active cells at the fine resolution, upsample
the coarse grid elsewhere, scatter, and decode the three boundary planes
when an active cell touches them). ``multiview_sdf_sparse`` returns None
when the active cells overflow the cap; ``multiview_sdf`` is the dense
stream. Both return the [R,R,R] f32 volume on the device.
"""
from __future__ import annotations

from typing import Any

import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import camera, grids
from disn_tpu_torch.infer import dense as dense_mod
from disn_tpu_torch.infer import fused
from disn_tpu_torch.infer import sparse as sparse_mod
from disn_tpu_torch.models import disn, sdfnet
from disn_tpu_torch.ops import fused_decode
from disn_tpu_torch.ops import image as image_ops
from disn_tpu_torch.ops import mv_taps

Params = dict[str, Any]

# the per-view features of one decode step, [V,P,512] (folded) or
# [V,P,1472] (general) in float32, stay within this many bytes: P is cut
# to whole 64-point cells (at V = 24 a folded step takes 10,880 points;
# the resampler's four gathers and lerps hold ~6x this at their peak).
# K8 makes no per-view features: on its route the [P,512] f32 MLP
# activations stay within it (262,144 points a step)
TAP_BYTES = 1 << 29
# the cull band in coarse cell diagonals: the reference's multi-view flow
# fixes it (cfg.band_factor is the single-view flow's)
BAND_FACTOR = 1.5


def encode_views(params: Params, imgs: torch.Tensor, cfg: Config):
    """imgs [V,H,W,C] -> (embeddings [V,G], endpoints of [V,h,w,c])."""
    return disn.encode(params, imgs, cfg)


def _use_fold(cfg: Config) -> bool:
    """The folded arm: the two-stream net with tf1 sampling."""
    return cfg.variant is Variant.TWOSTREAM and cfg.sampling == "tf1"


def _mv_prep(params: Params, imgs: torch.Tensor, cfg: Config,
             stats: dict | None = None):
    """Encode the V views in one batch; the decode state.

    Folded: (fused_embedding [1,G], merged [V,137,137,512], g_contrib
    [1,512], None). merged is each view's fold-137 map; g_contrib is the
    MEAN embedding's global-stream contribution (cast to the compute type,
    then times W_g[512:]), not the mean of the per-view ones, which rounds
    otherwise in bf16. General: (fused_embedding, None, None, endpoints).
    `stats` receives ``encode_ms`` and ``prep_ms``."""
    dev = imgs.device
    with device_mod.stage(stats, "encode_ms", dev):
        embeddings, endpoints = encode_views(params, imgs, cfg)
        fused_embedding = image_ops.widen(embeddings).mean(
            0, keepdim=True).to(embeddings.dtype)
    if not _use_fold(cfg):
        return fused_embedding, None, None, endpoints
    with device_mod.stage(stats, "prep_ms", dev):
        cd = disn.compute_dtype(cfg)
        merged = dense_mod.fold_137(params, embeddings, endpoints,
                                    cfg)["fold137"]
        wg = params["sdfprediction"]["fold2"]["conv1"]["weights"]
        g_contrib = torch.matmul(fused_embedding.to(cd), wg[512:].to(cd))
    return fused_embedding, merged, g_contrib, None


def _project(pts: torch.Tensor, trans_mats: torch.Tensor, cfg: Config
             ) -> torch.Tensor:
    """[P,3] points through each of V cameras -> [V,P,2] pixels."""
    v = trans_mats.shape[0]
    return camera.project_points(pts[None].expand(v, -1, -1), trans_mats,
                                 img_w=cfg.img_w, img_h=cfg.img_h)


def fused_point_features(endpoints: dict[str, torch.Tensor],
                         pts: torch.Tensor, trans_mats: torch.Tensor,
                         cfg: Config) -> torch.Tensor:
    """The general arm's per-point local features averaged over the views:
    [P, 1472]. pts [P,3]; trans_mats [V,4,3]; endpoints [V,h,w,c]."""
    sample = (image_ops.sample_native if cfg.sampling == "native"
              else image_ops.resize_then_sample)
    px = _project(pts, trans_mats, cfg)
    feats = torch.cat([sample(endpoints[n], px, cfg.img_h, cfg.img_w)
                       for n in disn.endpoint_names(cfg)], dim=-1)
    return image_ops.widen(feats).mean(0).to(feats.dtype)


def _mv_decode(params: Params, state, trans_mats: torch.Tensor,
               pts: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Fused decode of [P,3] world points -> [P] scaled SDF values in the
    compute type. Folded: the mean of the V views' bilinear taps in
    float32, cast to the compute type (K8 on the card), then the prefold
    streams."""
    fused_embedding, merged, g_contrib, endpoints = state
    if merged is not None:
        cd = merged.dtype
        local = mv_taps.mv_tap_mean(merged, trans_mats, pts, img_w=cfg.img_w,
                                    img_h=cfg.img_h)[None]    # [1,P,512]
        pred = sdfnet.apply_two_stream_prefold(
            params["sdfprediction"], params["sdfprediction_imgfeat"],
            pts[None], g_contrib, local, cd)
    else:
        local = fused_point_features(endpoints, pts, trans_mats, cfg)
        pred = disn.decode_from_features(params, pts[None], fused_embedding,
                                         local[None], cfg)
    if cfg.tanh:
        pred = torch.tanh(pred)
    return dense_mod.scale_pred(pred, cfg)[0]


def decode_step(state, cfg: Config) -> int:
    """Points a decode step takes: TAP_BYTES over the bytes of one point's
    per-view features, in whole 64-point cells; on K8's route (the folded
    arm on the card) over one point's [512] f32 MLP activations."""
    _, merged, _, endpoints = state
    if merged is not None and merged.is_cuda:
        per_point = 512 * 4
    else:
        v = (merged if merged is not None
             else endpoints[disn.endpoint_names(cfg)[0]]).shape[0]
        width = 512 if merged is not None else cfg.local_feat_dim
        per_point = v * width * 4
    return max(64, TAP_BYTES // per_point // 64 * 64)


def _decode_points(params: Params, state, trans_mats: torch.Tensor,
                   pts: torch.Tensor, cfg: Config) -> torch.Tensor:
    """[N,3] points -> [N] f32 values, decode_step points at a time."""
    step = decode_step(state, cfg)
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
    for i in range(0, pts.shape[0], step):
        out[i:i + step] = _mv_decode(params, state, trans_mats,
                                     pts[i:i + step], cfg)
    return out


def cell_cap(cfg: Config, stride: int, block: int = 32768,
             cell_cap_frac: float = 0.25) -> int:
    """Most active coarse cells the sparse flow decodes before it gives up:
    cell_cap_frac of the coarse cells (at least 256), rounded up to the
    reference's decode blocks of `block` points (whole cells)."""
    ppc = stride ** 3
    cap = max(256, int((cfg.sdf_res // stride) ** 3 * cell_cap_frac))
    cells_per_block = max(ppc, block // ppc * ppc) // ppc
    return -(-cap // cells_per_block) * cells_per_block


def _inputs(imgs, trans_mats, sdf_params, dev: torch.device):
    """Host or device inputs -> (imgs [V,H,W,C], trans [V,4,3] f32,
    sdf_params [6] f32) on `dev`; u8 images stay u8."""
    imgs, trans, sdfp = dense_mod.as_inputs(imgs, trans_mats, sdf_params,
                                            dev)
    return imgs, trans.reshape(-1, 4, 3), sdfp


def phase_a(params: Params, imgs: torch.Tensor, trans_mats: torch.Tensor,
            sdf_params: torch.Tensor, cfg: Config, stride: int,
            stats: dict | None = None):
    """Encode + fold the views, decode the coarse grid (in
    grids.block_order, each value scattered back to its place), cull it.
    Returns (state, vol_c [rc,rc,rc] f32, cell_ids [count] int32, count).
    `stats` receives ``encode_ms``, ``prep_ms`` and ``phase_a_ms``."""
    rc = cfg.sdf_res // stride + 1
    state = _mv_prep(params, imgs, cfg, stats)
    with device_mod.stage(stats, "phase_a_ms", sdf_params.device):
        # in 4^3-block order, so that K8 stages a block's taps
        perm = grids.block_order(rc, sdf_params.device)
        vol_c = torch.empty(rc ** 3, dtype=torch.float32,
                            device=sdf_params.device)
        vol_c[perm] = _decode_points(
            params, state, trans_mats,
            grids.grid_block(sdf_params, rc, 0, rc ** 3)[perm], cfg)
        vol_c = vol_c.reshape(rc, rc, rc)
        _, cell_ids, count = sparse_mod._band_cull(
            vol_c, sdf_params, rc, BAND_FACTOR, cfg,
            mode="sign" if cfg.binary else "band")
    return state, vol_c, cell_ids, count


def finish(params: Params, state, vol_c: torch.Tensor,
           cell_ids: torch.Tensor, trans_mats: torch.Tensor,
           sdf_params: torch.Tensor, cfg: Config, stride: int
           ) -> torch.Tensor:
    """The fine decode of exactly the active cells, the upsampled coarse
    grid elsewhere, and the boundary planes when an active cell touches
    the + boundary -> the [R,R,R] f32 volume."""
    fine_r = cfg.grid_resolution
    c = vol_c.shape[0] - 1
    vol = sparse_mod._upsample_aligned(vol_c, stride).reshape(-1)
    if cell_ids.shape[0]:
        pts, flats = fused_decode.cell_points(cell_ids, c, fine_r,
                                              sdf_params, stride)
        vol[flats] = _decode_points(params, state, trans_mats, pts, cfg)
    # exact plane values only matter inside ACTIVE boundary-layer cells
    # (the reference's soundness argument, disn_tpu/infer/sparse.py)
    ids = cell_ids.long()
    if bool(((ids % c == c - 1) | ((ids // c) % c == c - 1)
             | (ids // (c * c) == c - 1)).any()):
        pts, flats = fused.plane_points(fine_r, sdf_params)
        vol[flats] = _decode_points(params, state, trans_mats, pts, cfg)
    return vol.reshape(fine_r, fine_r, fine_r)


def multiview_sdf_sparse(params: Params, imgs, trans_mats, sdf_params,
                         cfg: Config, block: int = 32768,
                         cell_cap_frac: float = 0.25,
                         device: str | torch.device | None = None,
                         stats: dict | None = None
                         ) -> torch.Tensor | None:
    """V views ([V,H,W,C], u8 or float in [0,1]) with their [V,4,3]
    cameras -> the fused [R,R,R] f32 volume on `device` (the GPU by
    default) through the two-level sparse cull at cfg.sparse_stride, or
    None when the grid does not divide into coarse cells or the active
    cells overflow cell_cap (the caller then takes multiview_sdf).

    `stats` receives ``encode_ms``, ``prep_ms``, ``phase_a_ms``,
    ``finish_ms`` (the fine cells and planes), ``active_cells``,
    ``cell_cap`` and ``dense_fallback``."""
    dev = device_mod.resolve(device)
    stride = cfg.sparse_stride
    if cfg.sdf_res % stride or cfg.sdf_res // stride < 2:
        return None
    params = device_mod.tree_to(params, dev)
    imgs, trans, sdfp = _inputs(imgs, trans_mats, sdf_params, dev)
    state, vol_c, cell_ids, count = phase_a(params, imgs, trans, sdfp, cfg,
                                            stride, stats)
    cap = cell_cap(cfg, stride, block, cell_cap_frac)
    if stats is not None:
        stats.update(active_cells=count, cell_cap=cap,
                     dense_fallback=count > cap)
    if count > cap:
        return None
    with device_mod.stage(stats, "finish_ms", dev):
        return finish(params, state, vol_c, cell_ids, trans, sdfp, cfg,
                      stride)


def multiview_sdf(params: Params, imgs, trans_mats, sdf_params,
                  cfg: Config, device: str | torch.device | None = None,
                  stats: dict | None = None) -> torch.Tensor:
    """V views -> the fused [R,R,R] f32 volume on `device`, every grid
    point decoded (the exact path for cap overflows and grids the stride
    does not divide). `stats` receives ``encode_ms``, ``prep_ms`` and
    ``dense_ms``."""
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    imgs, trans, sdfp = _inputs(imgs, trans_mats, sdf_params, dev)
    state = _mv_prep(params, imgs, cfg, stats)
    fine_r = cfg.grid_resolution
    n = fine_r ** 3
    step = decode_step(state, cfg)
    vol = torch.empty(n, dtype=torch.float32, device=dev)
    with device_mod.stage(stats, "dense_ms", dev):
        for i in range(0, n, step):
            b = min(step, n - i)
            vol[i:i + b] = _mv_decode(params, state, trans,
                                      grids.grid_block(sdfp, fine_r, i, b),
                                      cfg)
    return vol.reshape(fine_r, fine_r, fine_r)
