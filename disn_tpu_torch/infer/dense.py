"""Dense-grid SDF inference (port of disn_tpu/infer/dense.py): image ->
(res+1)^3 SDF volume, every variant but THREEDCNN (which decodes a fixed
volume, pipeline.predict_volume).

fold='137' (twostream + tf1): the reference's tf1 sampling (resize every
endpoint map to 137x137, then resample) is linear in the map values, so
the five endpoint maps times their slices of the local fold2 weight
collapse into ONE [137,137,512] map built once per image; per point that
leaves four bilinear taps and the point MLPs. ``g_contrib = embedding @
W_g[512:]`` is the global stream's per-image contribution. fold='local'
multiplies each map by its slice but keeps the maps apart (their samples
sum); fold='none' samples the endpoint maps as they are.

``_decode_block`` is the plain per-point decode of every arm;
``_stream_blocks`` streams it over flat grid indices. ``dense_sdf``
decodes every stride-4 cell through the fused kernel when
infer/fused.kernel_enabled allows it (the three boundary planes per
point), and streams the whole grid through _decode_block otherwise.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import camera, grids
from disn_tpu_torch.models import disn, sdfnet
from disn_tpu_torch.ops import image as image_ops

Params = dict[str, Any]

BLOCK = 65536  # points a step of the plain decode


def scale_pred(pred: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Raw head output -> SDF value: pred/10, or (softmax_1 - 0.5)/10 for
    the binary head."""
    if cfg.binary:
        return (torch.softmax(pred, dim=-1)[..., 1] - 0.5) / cfg.sdf_weight
    return pred[..., 0] / cfg.sdf_weight


def normalize_fold(fold, cfg: Config) -> str:
    """Resolve a fold mode: 'none' | 'local' | '137' (bool and None
    accepted, as in the JAX package). None or 'auto' is '137' for
    twostream + tf1 sampling, the only config whose scales share one
    coordinate space (native sampling samples each map at its own scale),
    and 'none' otherwise; True is 'local', False 'none'."""
    if fold is None or fold == "auto":
        return ("137" if (cfg.variant is Variant.TWOSTREAM
                          and cfg.sampling == "tf1") else "none")
    if fold is True:
        return "local"
    if fold is False:
        return "none"
    if fold not in ("none", "local", "137"):
        raise ValueError(f"fold must be 'none', 'local' or '137', got "
                         f"{fold!r}")
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


def fold_endpoints(params: Params, embedding: torch.Tensor,
                   endpoints: dict[str, torch.Tensor], cfg: Config,
                   fold: str) -> dict[str, torch.Tensor]:
    """The encoder's endpoints -> _decode_block's for a resolved fold.
    '137' (twostream): {"fold137", "g_contrib"} (fold_137). 'local'
    (twostream): each endpoint map times its slice of the local stream's
    fold2/conv1 weight. Otherwise the variant's endpoint maps in the
    compute type."""
    cd = disn.compute_dtype(cfg)
    names = disn.endpoint_names(cfg)
    if cfg.variant is Variant.TWOSTREAM and fold == "137":
        return fold_137(params, embedding, endpoints, cfg)
    if cfg.variant is Variant.TWOSTREAM and fold == "local":
        _, w_local = sdfnet.split_local_fold2(params["sdfprediction_imgfeat"])
        w_local = w_local.to(cd)
        out, off = {}, 0
        for n in names:
            c = endpoints[n].shape[-1]
            out[n] = torch.matmul(endpoints[n].to(cd), w_local[off:off + c])
            off += c
        return out
    return {n: endpoints[n].to(cd) for n in names}


def _prep(params: Params, img: torch.Tensor, cfg: Config,
          fold_local=None):
    """Encode the image once: (embedding, fold_endpoints(..) for the
    resolved fold_local)."""
    embedding, endpoints = disn.encode(params, img, cfg)
    return embedding, fold_endpoints(params, embedding, endpoints, cfg,
                                     normalize_fold(fold_local, cfg))


def _decode_block(params: Params, endpoints: dict[str, torch.Tensor],
                  embedding: torch.Tensor | None, trans_mat: torch.Tensor,
                  pts: torch.Tensor, cfg: Config,
                  folded=None) -> torch.Tensor:
    """[P,3] points -> [P] SDF values (compute type) for one image, by the
    plain per-point path; `endpoints` come from _prep of the same fold.

    twostream: '137' resamples the folded map (prefold MLPs); 'local' sums
    the per-scale samples of the pre-multiplied maps (the global stream
    plus apply_local_head_folded); 'none' feeds each scale's samples to
    its slice of fold2/conv1 (apply_two_stream_split). onestream: the
    three scales' samples concatenated. global: the embedding alone
    (`endpoints` unused). Samples are tf1 (resize_then_sample) or native
    (sample_native) as cfg.sampling says."""
    fold = normalize_fold(folded, cfg)
    cd = disn.compute_dtype(cfg)
    pts_b = pts[None]
    if cfg.variant in (Variant.TWOSTREAM, Variant.ONESTREAM):
        px = camera.project_points(pts_b, trans_mat[None], img_w=cfg.img_w,
                                   img_h=cfg.img_h)
        sample = (image_ops.sample_native if cfg.sampling == "native"
                  else image_ops.resize_then_sample)
        names = disn.endpoint_names(cfg)
        if cfg.variant is Variant.TWOSTREAM and fold == "137":
            pred = sdfnet.apply_two_stream_prefold(
                params["sdfprediction"], params["sdfprediction_imgfeat"],
                pts_b, endpoints["g_contrib"],
                image_ops.resampler(endpoints["fold137"], px), cd)
        elif cfg.variant is Variant.TWOSTREAM and fold == "local":
            contrib = None
            for n in names:
                smp = sample(endpoints[n], px, cfg.img_h, cfg.img_w)
                contrib = smp if contrib is None else contrib + smp
            pred = (sdfnet.apply_global_head(params["sdfprediction"], pts_b,
                                             embedding, cd)
                    + sdfnet.apply_local_head_folded(
                        params["sdfprediction_imgfeat"], pts_b, contrib,
                        cd))
        elif cfg.variant is Variant.TWOSTREAM:
            feats = [sample(endpoints[n], px, cfg.img_h, cfg.img_w)
                     for n in names]
            pred = sdfnet.apply_two_stream_split(
                params["sdfprediction"], params["sdfprediction_imgfeat"],
                pts_b, embedding, feats, cd)
        else:
            local = torch.cat([sample(endpoints[n], px, cfg.img_h,
                                      cfg.img_w) for n in names], dim=-1)
            pred = sdfnet.apply_onestream_head(params["sdfimgfeat"], pts_b,
                                               embedding, local, cd)
    elif cfg.variant is Variant.GLOBAL:
        pred = sdfnet.apply_global_head(params["sdfprediction"], pts_b,
                                        embedding, cd)
    else:
        raise ValueError("THREEDCNN decodes a fixed volume; use "
                         "sdfnet.apply_3dcnn_head")
    if cfg.tanh:
        pred = torch.tanh(pred)
    return scale_pred(pred, cfg)[0]


def decode_points(params: Params, endpoints: dict, embedding, trans_mat,
                  pts: torch.Tensor, cfg: Config, folded=None,
                  block: int = BLOCK) -> torch.Tensor:
    """_decode_block over [P,3] points, `block` at a time -> [P] (compute
    type)."""
    out = [_decode_block(params, endpoints, embedding, trans_mat,
                         pts[i:i + block], cfg, folded=folded)
           for i in range(0, pts.shape[0], block)]
    if not out:
        return torch.zeros(0, device=pts.device)
    return torch.cat(out)


def _stream_blocks(params: Params, endpoints: dict, embedding, trans_mat,
                   sdf_params: torch.Tensor, cfg: Config, start: int,
                   count: int, block: int = BLOCK, folded=None
                   ) -> torch.Tensor:
    """SDF values [count] (compute type) of the flat grid indices [start,
    start + count) of the cfg.grid_resolution grid, decoded `block` points
    at a time (the last step takes what is left)."""
    r = cfg.grid_resolution
    out = [_decode_block(params, endpoints, embedding, trans_mat,
                         grids.grid_block(sdf_params, r, i,
                                          min(block, start + count - i)),
                         cfg, folded=folded)
           for i in range(start, start + count, block)]
    if not out:
        return torch.zeros(0, device=sdf_params.device)
    return torch.cat(out)


def dense_volume(params: Params, endpoints: dict, embedding, trans_mat,
                 sdf_params: torch.Tensor, cfg: Config, fold: str
                 ) -> torch.Tensor:
    """The exact [R,R,R] f32 volume of cfg.grid_resolution from _prep's
    outputs for the resolved `fold`: through the fused kernel when
    infer/fused.kernel_enabled allows it (the boundary planes per point),
    else every point through _decode_block."""
    from disn_tpu_torch.infer import fused

    r = cfg.grid_resolution
    if fused.kernel_enabled(cfg, fold, fused.STRIDE, r):
        return fused.dense_grid_via_cells(params, endpoints, trans_mat,
                                          sdf_params, r, cfg)
    vals = _stream_blocks(params, endpoints, embedding, trans_mat,
                          sdf_params, cfg, 0, r ** 3, folded=fold)
    return vals.float().reshape(r, r, r)


def _upload(a, dev: torch.device, dtype=None) -> torch.Tensor:
    """A host array or a tensor -> a tensor on `dev` (cast to `dtype`). A
    host array bound for a card is copied into a fresh page-locked buffer
    and from there without blocking (the port of the JAX package's
    _put_small): the calling thread does not wait for the work queued on
    the card, the caller's array may change as soon as this returns, and
    the pinned allocator keeps the buffer until its copy has run."""
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if dev.type != "cuda" or t.device.type != "cpu":
        return t.to(dev)
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf.to(dev, non_blocking=True)


def as_inputs(img, trans_mat, sdf_params, dev: torch.device):
    """Host or device inputs -> (img [1,H,W,C], trans [4,3] f32, sdf_params
    [6] f32) on `dev`, with nothing waiting for the card (_upload). u8
    images stay u8 (normalised by disn.encode)."""
    img = _upload(img, dev)
    if img.dim() == 3:
        img = img[None]
    trans = _upload(trans_mat, dev, torch.float32)
    sdfp = _upload(sdf_params, dev, torch.float32)
    return img, trans.contiguous(), sdfp.contiguous()


def dense_volume_sharded(params: Params, endpoints: dict, embedding,
                         trans_mat, sdf_params: torch.Tensor, cfg: Config,
                         fold: str, mesh) -> torch.Tensor:
    """dense_volume with every rank of `mesh` (both axes, row-major)
    decoding a contiguous share, gathered into the whole [R,R,R] f32 volume
    on every rank (port of make_sharded_dense_sdf_fn): through the fused
    kernel, each rank's share of the stride-4 cells and of the boundary
    planes; otherwise, as the JAX package does, each rank's slab of the flat
    grid in _stream_blocks' steps (per_dev points, a multiple of the
    step)."""
    from disn_tpu_torch import parallel
    from disn_tpu_torch.infer import fused

    r = cfg.grid_resolution
    n, k = mesh.size, mesh.index
    if fused.kernel_enabled(cfg, fold, fused.STRIDE, r):
        c = (r - 1) // fused.STRIDE
        lo, hi = parallel.share(c ** 3, n, k)
        cells = torch.arange(lo, hi, dtype=torch.int32,
                             device=sdf_params.device)
        _, flats = fused._cell_points(cells, c, r, sdf_params)
        vals = (fused.decode_cells(params, endpoints, trans_mat, sdf_params,
                                   cells, cfg, fine_r=r, coarse_c=c)
                if hi > lo else torch.zeros(0, device=sdf_params.device))
        pts, pflats = fused.plane_points(r, sdf_params)
        plo, phi = parallel.share(pts.shape[0], n, k)
        pvals = decode_points(params, endpoints, embedding, trans_mat,
                              pts[plo:phi], cfg, folded=fold,
                              block=fused.PLANE_BLOCK)
        vals = parallel.gather(torch.cat([vals.float(), pvals.float()]),
                               mesh)
        flats = parallel.gather(torch.cat([flats.long(),
                                           pflats[plo:phi].long()]), mesh)
        vol = torch.empty(r ** 3, device=sdf_params.device)
        vol[flats] = vals
        return vol.reshape(r, r, r)
    total = r ** 3
    per = -(-total // n)
    step = min(BLOCK, -(-per // 8) * 8)
    per_dev = -(-per // step) * step
    start = min(total, k * per_dev)
    vals = _stream_blocks(params, endpoints, embedding, trans_mat,
                          sdf_params, cfg, start,
                          min(total, start + per_dev) - start, step,
                          folded=fold)
    return parallel.gather(vals.float(), mesh).reshape(r, r, r)


def dense_sdf(params: Params, img, trans_mat, sdf_params, cfg: Config,
              device: str | torch.device | None = None,
              fold_local=None, mesh=None) -> torch.Tensor:
    """Image -> the exact [R,R,R] f32 volume (z,y,x indexed) on `device`
    (dense_volume: every stride-4 cell through the fused kernel when
    infer/fused.kernel_enabled allows it, else the plain decode of every
    point). fold_local: normalize_fold's modes. With a parallel.Mesh over a
    process group, every rank of it decodes a share and every rank returns
    the whole volume (dense_volume_sharded)."""
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    img, trans, sdfp = as_inputs(img, trans_mat, sdf_params, dev)
    fold = normalize_fold(fold_local, cfg)
    embedding, endpoints = _prep(params, img, cfg, fold_local=fold)
    if mesh is not None and mesh.group is not None:
        return dense_volume_sharded(params, endpoints, embedding, trans, sdfp,
                                    cfg, fold, mesh)
    return dense_volume(params, endpoints, embedding, trans, sdfp, cfg, fold)
