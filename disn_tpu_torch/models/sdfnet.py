"""SDF decoder heads (port of disn_tpu/models/sdfnet.py): the point MLPs of
every variant in their unfolded, split, folded-local and prefold forms, and
the 3D-CNN volume decoder.

Head widths: each point stream is 3->64->256->512, ++ extra features,
->512->256->1 (2 logits for the binary variant); the extra features are
the 1024 embedding (global stream), the 1472 local features (local
stream), or both, 1024 ++ 448 (onestream). The 3D-CNN decoder: the 1024
embedding -> transpose convs 128,128,128,64,64,32 over 2,4,8,16,32 -> 65^3
-> a 1x1x1 head. Scope names mirror the TF graph: fold1/conv1..conv3,
fold2/conv1..conv2, fold2/conv5 (or conv5_bi); 3deconv1..6, 3conv7 (or
3conv7_binary).
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


def init_onestream_head(gen: torch.Generator, device: torch.device,
                        global_dim: int = 1024, local_dim: int = 448,
                        binary: bool = False) -> dict:
    return _init_point_mlp(gen, global_dim + local_dim, 2 if binary else 1,
                           device)


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


def _fold1(params: dict, pts: torch.Tensor, cd: torch.dtype
           ) -> torch.Tensor:
    h = layers.dense(params["fold1"]["conv1"], pts, compute_dtype=cd)
    h = layers.dense(params["fold1"]["conv2"], h, compute_dtype=cd)
    return layers.dense(params["fold1"]["conv3"], h, compute_dtype=cd)


def _mm(x: torch.Tensor, w: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return torch.matmul(x.to(cd), w.to(cd))


def _tail(params: dict, pre: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """relu, fold2/conv2, the output layer."""
    h = layers.dense(params["fold2"]["conv2"], torch.relu(pre),
                     compute_dtype=cd)
    return layers.dense(params["fold2"][last_layer(params)], h, relu=False,
                        compute_dtype=cd)


def apply_two_stream_split(global_params: dict, local_params: dict,
                           pts: torch.Tensor, global_feat: torch.Tensor,
                           local_feats: list[torch.Tensor],
                           compute_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Two-stream decode with the fold2/conv1 matmuls split per input
    block, concat(x1..xn) @ W == sum(x_i @ W_i), so the [N, 512+1472]
    concat never materialises. global_feat [B,G]; local_feats: the
    per-scale samples [B,N,C_s] in vgg.ENDPOINTS order. Equal to
    apply_global_head + apply_local_head up to summation order."""
    cd = compute_dtype
    hg = _fold1(global_params, pts, cd)
    wg = global_params["fold2"]["conv1"]["weights"]
    g_contrib = _mm(global_feat, wg[512:], cd)[:, None, :]
    pre_g = (_mm(hg, wg[:512], cd) + g_contrib
             + global_params["fold2"]["conv1"]["biases"].to(cd))
    pred_g = _tail(global_params, pre_g, cd)

    hl = _fold1(local_params, pts, cd)
    wl = local_params["fold2"]["conv1"]["weights"]
    pre_l = (_mm(hl, wl[:512], cd)
             + local_params["fold2"]["conv1"]["biases"].to(cd))
    off = 512
    for feat in local_feats:
        c = feat.shape[-1]
        pre_l = pre_l + _mm(feat, wl[off:off + c], cd)
        off += c
    return pred_g + _tail(local_params, pre_l, cd)


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
    hg = _fold1(global_params, pts, cd)
    wg = global_params["fold2"]["conv1"]["weights"]
    pre_g = (_mm(hg, wg[:512], cd) + g_contrib.to(cd)[:, None, :]
             + global_params["fold2"]["conv1"]["biases"].to(cd))
    pred_g = _tail(global_params, pre_g, cd)

    hl = _fold1(local_params, pts, cd)
    wl = local_params["fold2"]["conv1"]["weights"]
    pre_l = (_mm(hl, wl[:512], cd) + local_contrib.to(cd)
             + local_params["fold2"]["conv1"]["biases"].to(cd))
    return pred_g + _tail(local_params, pre_l, cd)


def apply_local_head_folded(params: dict, pts: torch.Tensor,
                            local_contrib: torch.Tensor,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """The local stream with its local-feature matmul folded into the maps:
    local_contrib [B,N,512] = the samples of (map @ W_local), summed over
    the scales (infer/dense._prep fold 'local')."""
    cd = compute_dtype
    w_point, _ = split_local_fold2(params)
    pre = (_mm(_fold1(params, pts, cd), w_point, cd) + local_contrib.to(cd)
           + params["fold2"]["conv1"]["biases"].to(cd))
    return _tail(params, pre, cd)


def apply_onestream_head(params: dict, pts: torch.Tensor,
                         global_feat: torch.Tensor, local_feat: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """get_sdf_basic2_imgfeat_onestream: one MLP on the tiled [B,G]
    embedding ++ the [B,N,448] local features."""
    g = global_feat[:, None, :].expand(pts.shape[0], pts.shape[1], -1)
    concat = torch.cat([g, local_feat.to(g.dtype)], dim=-1)
    return _apply_point_mlp(params, pts, concat, compute_dtype)


# The 3D-CNN volume decoder (get_sdf_3dcnn): (name, kernel, out channels,
# padding) of each stride-2 transpose conv, 1 -> 2 -> 4 -> 8 -> 16 -> 32 -> 65
_3D_STACK = [
    ("3deconv1", (2, 2, 2), 128, "SAME"),
    ("3deconv2", (3, 3, 3), 128, "SAME"),
    ("3deconv3", (3, 3, 3), 128, "SAME"),
    ("3deconv4", (3, 3, 3), 64, "SAME"),
    ("3deconv5", (3, 3, 3), 64, "SAME"),
    ("3deconv6", (3, 3, 3), 32, "VALID"),
]


def init_3dcnn_head(gen: torch.Generator, device: torch.device,
                    global_dim: int = 1024, binary: bool = False) -> dict:
    params: dict = {}
    cin = global_dim
    for name, k, cout, _ in _3D_STACK:
        params[name] = layers.init_conv3d_transpose(gen, k, cin, cout,
                                                    device)
        cin = cout
    out = 2 if binary else 1
    params["3conv7_binary" if binary else "3conv7"] = {
        "weights": layers.xavier_uniform(gen, (1, 1, 1, cin, out), device),
        "biases": torch.zeros(out, device=device)}
    return params


def apply_3dcnn_head(params: dict, global_feat: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """[B,G] -> [B, 65^3, 1|2] volume logits, x fastest in flat order. The
    1x1x1 head runs in float32 (float64 in a float64 pass) on the widened
    stack output, as the JAX code casts its kernel to float32 (in bf16 the
    JAX function stops there: lax takes no mixed-type convolution)."""
    b = global_feat.shape[0]
    x = global_feat.reshape(b, 1, 1, 1, -1)
    for name, _, _, pad in _3D_STACK:
        x = layers.conv3d_transpose(params[name], x, stride=(2, 2, 2),
                                    padding=pad, compute_dtype=compute_dtype)
    head = params["3conv7_binary" if "3conv7_binary" in params
                  else "3conv7"]
    hd = torch.float64 if compute_dtype == torch.float64 else torch.float32
    w = head["weights"].to(hd)
    y = torch.matmul(x.to(hd), w.reshape(w.shape[3], w.shape[4]))
    y = y + head["biases"].to(hd)
    return y.reshape(b, -1, y.shape[-1])
