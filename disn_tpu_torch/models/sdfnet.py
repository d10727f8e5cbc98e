"""SDF decoder heads (port of disn_tpu/models/sdfnet.py: the two-stream
prefold form that the fold='137' decode uses, and the unfolded global and
local streams that the multi-view general arm decodes with).

Head widths: each stream is 3->64->256->512, ++ extra features, ->512->256->1
(2 logits for the binary variant). Scope names mirror the TF graph:
fold1/conv1..conv3, fold2/conv1..conv2, fold2/conv5 (or conv5_bi).
"""
from __future__ import annotations

import torch

from disn_tpu_torch.models import layers


def _init_point_mlp(gen: torch.Generator, concat_dim: int, out_dim: int,
                    device: torch.device) -> dict:
    last = "conv5_bi" if out_dim == 2 else "conv5"
    return {
        "fold1": {
            "conv1": layers.init_dense(gen, 3, 64, device),
            "conv2": layers.init_dense(gen, 64, 256, device),
            "conv3": layers.init_dense(gen, 256, 512, device),
        },
        "fold2": {
            "conv1": layers.init_dense(gen, 512 + concat_dim, 512, device),
            "conv2": layers.init_dense(gen, 512, 256, device),
            last: layers.init_dense(gen, 256, out_dim, device),
        },
    }


def init_global_head(gen: torch.Generator, device: torch.device,
                     global_dim: int = 1024, binary: bool = False) -> dict:
    return _init_point_mlp(gen, global_dim, 2 if binary else 1, device)


def init_local_head(gen: torch.Generator, device: torch.device,
                    local_dim: int = 1472, binary: bool = False) -> dict:
    return _init_point_mlp(gen, local_dim, 2 if binary else 1, device)


def last_layer(params: dict) -> str:
    return "conv5_bi" if "conv5_bi" in params["fold2"] else "conv5"


def _apply_point_mlp(params: dict, pts: torch.Tensor, concat: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """pts [B,N,3]; concat [B,N,D], the features appended after fold1.
    fold1 (3->64->256->512), concat, fold2 (512+D->512->256->out)."""
    cd = compute_dtype
    h = layers.dense(params["fold1"]["conv1"], pts, compute_dtype=cd)
    h = layers.dense(params["fold1"]["conv2"], h, compute_dtype=cd)
    h = layers.dense(params["fold1"]["conv3"], h, compute_dtype=cd)
    h = torch.cat([h, concat.to(h.dtype)], dim=-1)
    h = layers.dense(params["fold2"]["conv1"], h, compute_dtype=cd)
    h = layers.dense(params["fold2"]["conv2"], h, compute_dtype=cd)
    return layers.dense(params["fold2"][last_layer(params)], h, relu=False,
                        compute_dtype=cd)


def apply_global_head(params: dict, pts: torch.Tensor,
                      global_feat: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """get_sdf_basic2: the [B,G] embedding tiled over the points."""
    g = global_feat[:, None, :].expand(pts.shape[0], pts.shape[1], -1)
    return _apply_point_mlp(params, pts, g, compute_dtype)


def apply_local_head(params: dict, pts: torch.Tensor,
                     local_feat: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """get_sdf_basic2_imgfeat_twostream: [B,N,L] per-point local
    features."""
    return _apply_point_mlp(params, pts, local_feat, compute_dtype)


def split_local_fold2(params: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Split fold2/conv1 W [512+L, 512] into (W_point [512,512], W_local
    [L,512]). Sampling is linear, so W_local folds into the feature maps
    once per image: sample(map) @ W_l == sample(map @ W_l)."""
    w = params["fold2"]["conv1"]["weights"]
    return w[:512], w[512:]


def apply_two_stream_prefold(global_params: dict, local_params: dict,
                             pts: torch.Tensor, g_contrib: torch.Tensor,
                             local_contrib: torch.Tensor,
                             compute_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Two-stream decode with both per-image contributions precomputed.

    pts [B,N,3]; g_contrib [B,512] = embedding @ W_g[512:]; local_contrib
    [B,N,512] = the per-point sample of the folded 137-space map. Returns
    [B,N,out] in the compute type, rounded as the JAX version rounds."""
    cd = compute_dtype

    def fold1(params, h):
        h = layers.dense(params["fold1"]["conv1"], h, compute_dtype=cd)
        h = layers.dense(params["fold1"]["conv2"], h, compute_dtype=cd)
        return layers.dense(params["fold1"]["conv3"], h, compute_dtype=cd)

    def mm(x, w):
        return torch.matmul(x.to(cd), w.to(cd))

    def tail(params, pre):
        h = torch.relu(pre)
        h = layers.dense(params["fold2"]["conv2"], h, compute_dtype=cd)
        return layers.dense(params["fold2"][last_layer(params)], h,
                            relu=False, compute_dtype=cd)

    hg = fold1(global_params, pts)
    wg = global_params["fold2"]["conv1"]["weights"]
    pre_g = (mm(hg, wg[:512]) + g_contrib.to(cd)[:, None, :]
             + global_params["fold2"]["conv1"]["biases"].to(cd))
    pred_g = tail(global_params, pre_g)

    hl = fold1(local_params, pts)
    wl = local_params["fold2"]["conv1"]["weights"]
    pre_l = (mm(hl, wl[:512]) + local_contrib.to(cd)
             + local_params["fold2"]["conv1"]["biases"].to(cd))
    pred_l = tail(local_params, pre_l)
    return pred_g + pred_l
