"""The alternate image encoders, AlexNet and an 18-layer ResNet-v1 (port of
disn_tpu/models/encoders.py), as plain functions in models/vgg.py's style.
Config.encoder selects one through models/disn.init_encoder and encode.

AlexNet: conv1 (11x11 stride 4) pool conv2 (5x5) pool conv3 conv4 conv5
pool fc6 fc7 fc8, every conv SAME, every pool 3x3 stride 2 VALID; the
endpoints are the five post-ReLU convs. ResNet-18: conv1 (7x7 stride 2),
a 3x3 stride-2 SAME max pool, four stages of two basic blocks (64, 128,
256, 512 wide; the first block of stages 2-4 has stride 2), the spatial
mean and fc; the endpoints are the stages' outputs. TF's SAME padding is
asymmetric at stride 2 and 4 (models/layers.same_padding).
"""
from __future__ import annotations

import numpy as np
import torch

from disn_tpu_torch.models import layers
from disn_tpu_torch.models.vgg import scaled_width

# (name, k, stride, cout, pool after)
_ALEX = [
    ("conv1", 11, 4, 96, True),
    ("conv2", 5, 1, 256, True),
    ("conv3", 3, 1, 384, False),
    ("conv4", 3, 1, 384, False),
    ("conv5", 3, 1, 256, True),
]
ALEX_ENDPOINTS = tuple(name for name, *_ in _ALEX)

# grouped layers of the BVLC weights (groups=2); they load as one dense
# conv with block-diagonal weights, equal to the reference's split convs
_ALEX_GROUPS = {"conv2": 2, "conv4": 2, "conv5": 2}

_RESNET18 = [(64, 2), (128, 2), (256, 2), (512, 2)]  # (width, blocks)
RESNET_ENDPOINTS = tuple(f"stage{i + 1}" for i in range(len(_RESNET18)))


def init_alexnet(gen: torch.Generator, device: torch.device,
                 in_channels: int = 3, num_classes: int = 1024,
                 width_mult: float = 1.0) -> dict:
    params: dict = {}
    cin = in_channels
    for name, k, _, cout, _ in _ALEX:
        cout = scaled_width(cout, width_mult)
        params[name] = layers.init_conv(gen, k, k, cin, cout, device)
        cin = cout
    fc = scaled_width(4096, width_mult)
    params["fc6"] = layers.init_dense(gen, cin * 6 * 6, fc, device)
    params["fc7"] = layers.init_dense(gen, fc, fc, device)
    params["fc8"] = layers.init_dense(gen, fc, num_classes, device)
    return params


def apply_alexnet(params: dict, img: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """img [B,224,224,C] -> (embedding [B,num_classes], endpoints NHWC)."""
    x = img
    endpoints: dict[str, torch.Tensor] = {}
    for name, _, stride, _, pool in _ALEX:
        x = layers.conv2d(params[name], x, stride=stride,
                          compute_dtype=compute_dtype)
        endpoints[name] = x
        if pool:
            x = layers.max_pool2d(x, k=3, stride=2)
    # flattened in NHWC order (the view's, not the channels_last storage's)
    x = x.reshape(x.shape[0], -1)
    x = layers.dense(params["fc6"], x, compute_dtype=compute_dtype)
    x = layers.dense(params["fc7"], x, compute_dtype=compute_dtype)
    x = layers.dense(params["fc8"], x, relu=False,
                     compute_dtype=compute_dtype)
    return x, endpoints


def load_alexnet_npy(path: str, params: dict) -> dict:
    """BVLC `bvlc_alexnet.npy` weights (a pickled {layer: [weights,
    biases]}) loaded into an init_alexnet tree; returns a new tree on the
    params' device. Grouped conv weights [k,k,cin/g,cout] expand to
    block-diagonal dense ones. A layer whose shapes do not match the tree
    (fc8 at 1000 ImageNet classes, a width_mult'd tree) is skipped."""
    data = np.load(path, allow_pickle=True, encoding="latin1").item()
    out = {k: dict(v) for k, v in params.items()}
    for name, wb in data.items():
        if name not in out:
            continue
        w = np.asarray(wb[0], np.float32)
        b = np.asarray(wb[1], np.float32)
        g = _ALEX_GROUPS.get(name, 1)
        if w.ndim == 4 and g > 1:
            k1, k2, cpg, cout = w.shape
            opg = cout // g
            full = np.zeros((k1, k2, cpg * g, cout), np.float32)
            for i in range(g):
                full[:, :, i * cpg:(i + 1) * cpg, i * opg:(i + 1) * opg] = \
                    w[..., i * opg:(i + 1) * opg]
            w = full
        tgt = out[name]
        if (tuple(tgt["weights"].shape) == w.shape
                and tuple(tgt["biases"].shape) == b.shape):
            dev = tgt["weights"].device
            out[name] = {"weights": torch.from_numpy(w).to(dev),
                         "biases": torch.from_numpy(b).to(dev)}
    return out


def init_resnet(gen: torch.Generator, device: torch.device,
                in_channels: int = 3, num_classes: int = 1024,
                width_mult: float = 1.0) -> dict:
    cin = scaled_width(64, width_mult)
    params: dict = {"conv1": layers.init_conv(gen, 7, 7, in_channels, cin,
                                              device)}
    for si, (width, blocks) in enumerate(_RESNET18):
        width = scaled_width(width, width_mult)
        stage: dict = {}
        for b in range(blocks):
            blk = {"conv_a": layers.init_conv(gen, 3, 3, cin, width, device),
                   "conv_b": layers.init_conv(gen, 3, 3, width, width,
                                              device)}
            if cin != width:
                blk["proj"] = layers.init_conv(gen, 1, 1, cin, width, device)
            stage[f"block{b + 1}"] = blk
            cin = width
        params[f"stage{si + 1}"] = stage
    params["fc"] = layers.init_dense(gen, cin, num_classes, device)
    return params


def apply_resnet(params: dict, img: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """img [B,224,224,C] -> (embedding [B,num_classes], endpoints NHWC)."""
    cd = compute_dtype
    x = layers.conv2d(params["conv1"], img, stride=2, compute_dtype=cd)
    x = layers.max_pool2d(x, k=3, stride=2, padding="SAME")
    endpoints: dict[str, torch.Tensor] = {}
    for si in range(len(_RESNET18)):
        stage = params[f"stage{si + 1}"]
        for bi, bname in enumerate(sorted(stage)):
            blk = stage[bname]
            stride = 2 if (si > 0 and bi == 0) else 1
            h = layers.conv2d(blk["conv_a"], x, stride=stride,
                              compute_dtype=cd)
            h = layers.conv2d(blk["conv_b"], h, relu=False, compute_dtype=cd)
            sc = x
            if "proj" in blk:
                sc = layers.conv2d(blk["proj"], x, stride=stride, relu=False,
                                   compute_dtype=cd)
            elif stride != 1:
                # the reference's k=1 max pool: every stride-th pixel
                sc = layers.max_pool2d(x, k=1, stride=stride)
            x = torch.relu(h + sc)
        endpoints[f"stage{si + 1}"] = x
    x = torch.mean(x, dim=(1, 2))
    emb = layers.dense(params["fc"], x, relu=False, compute_dtype=cd)
    return emb, endpoints
