"""disn_tpu_torch's alternate encoders (AlexNet, ResNet-18), RGBA input and
the strided, TF-SAME-padded layers they need, against disn_tpu's, on the
CPU at CI width (width_mult 0.125, 32 classes) from the same params
(convert.params_from_jax) and seeded numpy inputs.

Tolerances: float32 within 1e-4 of each output's scale (XLA and torch sum
convolutions and matmuls in other orders; measured ~1e-6); bfloat16 with
tests/test_fused.py's bounds, max 2% and mean 0.3% of the scale (both
round every layer to bf16 from float32 sums, and ties fall by summation
order; measured max 1%, mean 0.06%); max pools exactly."""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.config import EncoderKind as JEncoderKind
from disn_tpu.config import Variant as JVariant
from disn_tpu.infer import dense as jdense
from disn_tpu.models import disn as jdisn
from disn_tpu.models import encoders as jencoders
from disn_tpu.models import layers as jlayers
from disn_tpu.models import posenet as jposenet
from disn_tpu.train import trainer as jtrainer
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config, EncoderKind, Variant
from disn_tpu_torch.core import camera
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import dense
from disn_tpu_torch.models import disn, encoders, layers, posenet
from disn_tpu_torch.train import checkpoint, trainer
from torch_threads import few_threads  # noqa: F401  (autouse)

SMALL = dict(num_classes=32, width_mult=0.125, batch_size=2,
             num_sample_points=64)
RTOL = 1e-4
BF16_MAX_REL, BF16_MEAN_REL = 0.02, 0.003
BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


def _cfgs(encoder, alpha=False, variant="twostream", **kw):
    kw = dict(SMALL, alpha=alpha, **kw)
    return (JConfig(encoder=JEncoderKind(encoder),
                    variant=JVariant(variant), **kw),
            Config(encoder=EncoderKind(encoder), variant=Variant(variant),
                   **kw))


@functools.lru_cache(maxsize=None)
def _jparams(encoder, alpha, variant="twostream"):
    """A JAX init whose head biases are seeded N(0, 0.1^2) instead of 0,
    so that every bias add counts."""
    jcfg, _ = _cfgs(encoder, alpha, variant)
    params = jax.device_get(jdisn.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(9)

    def biased(tree):
        return {k: (biased(v) if isinstance(v, dict) else
                    (0.1 * rng.randn(*v.shape)).astype(np.float32)
                    if k == "biases" else v) for k, v in tree.items()}

    scope = jdisn.ENCODER_SCOPE[jcfg.encoder]
    return jax.tree_util.tree_map(jnp.asarray, {
        k: (v if k == scope else biased(v)) for k, v in params.items()})


def _port(jparams):
    return convert.params_from_jax(jax.device_get(jparams))


def _close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _close_bf16(got, want, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want) / scale
    assert d.max() <= BF16_MAX_REL and d.mean() <= BF16_MEAN_REL, \
        (what, float(d.max()), float(d.mean()))


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------------
# the layers: TF's SAME split at every stride
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [23, 24])
@pytest.mark.parametrize("k", [1, 3, 7, 11])
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_matches_lax(padding, stride, k, size):
    """layers.conv2d against disn_tpu's (jax.lax.conv_general_dilated with
    TF's padding) on an odd and an even map, within RTOL: a symmetric pad
    where TF's is asymmetric would shift every output pixel by one."""
    rng = np.random.RandomState(k * 100 + stride * 10 + size)
    x = rng.randn(2, size, size + 3, 5).astype(np.float32)
    p = {"weights": rng.randn(k, k, 5, 6).astype(np.float32),
         "biases": rng.randn(6).astype(np.float32)}
    want = jlayers.conv2d(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x), stride=stride, padding=padding,
                          relu=False)
    got = layers.conv2d({k_: torch.from_numpy(v) for k_, v in p.items()},
                        torch.from_numpy(x), stride=stride, padding=padding,
                        relu=False)
    _close(got, want, what=f"{padding} s{stride} k{k} {size}")


@pytest.mark.parametrize("size", [13, 56])
@pytest.mark.parametrize("k,stride", [(1, 2), (2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_max_pool2d_matches_lax(padding, k, stride, size):
    """Exactly lax.reduce_window's max, with SAME's pad at -inf: the values
    are all negative, so a zero pad would win at the border."""
    x = -np.random.RandomState(size + k).rand(2, size, size, 3).astype(
        np.float32) - 0.5
    want = jlayers.max_pool2d(jnp.asarray(x), k=k, stride=stride,
                              padding=padding)
    got = layers.max_pool2d(torch.from_numpy(x), k=k, stride=stride,
                            padding=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_same_padding_splits_like_tf():
    """The pads the encoders meet: AlexNet's conv1 (11x11 stride 4 on 224),
    ResNet's conv1 (7x7 stride 2), its stride-2 3x3 convs and stem pool on
    even maps, and VGG's symmetric stride-1 3x3."""
    assert layers.same_padding(224, 11, 4) == (3, 4)
    assert layers.same_padding(224, 7, 2) == (2, 3)
    assert layers.same_padding(112, 3, 2) == (0, 1)
    assert layers.same_padding(56, 3, 2) == (0, 1)
    assert layers.same_padding(56, 1, 2) == (0, 0)
    assert layers.same_padding(224, 3, 1) == (1, 1)


# --------------------------------------------------------------------------
# the encoders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("encoder", ["alexnet", "resnet"])
def test_encode_matches_jax(encoder, alpha, dtype):
    """disn.encode of u8 images: the embedding and every endpoint map."""
    jcfg, cfg = _cfgs(encoder, alpha, compute_dtype=dtype)
    jparams = _jparams(encoder, alpha)
    img = np.random.RandomState(1).randint(
        0, 256, (2, 137, 137, cfg.img_channels), np.uint8)
    jemb, jeps = jax.jit(functools.partial(jdisn.encode, cfg=jcfg))(
        jparams, jnp.asarray(img))
    emb, eps = disn.encode(_port(jparams), torch.from_numpy(img), cfg)
    assert set(eps) == set(jeps)
    assert disn.endpoint_names(cfg) == jdisn.endpoint_names(jcfg)
    close = _close if dtype == "float32" else _close_bf16
    if dtype == "bfloat16":
        assert emb.dtype == torch.bfloat16
    close(_np(emb), jemb, what="embedding")
    for name in eps:
        close(_np(eps[name]), jeps[name], what=name)


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("encoder", ["alexnet", "resnet"])
def test_init_matches_jax(encoder, alpha):
    """disn.init: the same tree (the encoder under its TF scope) with the
    same shapes; the local head's fold2 takes 512 + local_feat_dim."""
    jcfg, cfg = _cfgs(encoder, alpha)
    want = dict(checkpoint.leaves(jax.device_get(
        jdisn.init(jcfg, jax.random.PRNGKey(0)))))
    got = dict(checkpoint.leaves(disn.init(cfg, device="cpu")))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    scope = disn.ENCODER_SCOPE[cfg.encoder]
    assert scope == jdisn.ENCODER_SCOPE[jcfg.encoder]
    assert any(k.startswith(scope + "$") for k in got)
    w = got["sdfprediction_imgfeat$fold2$conv1$weights"]
    assert w.shape[0] == 512 + cfg.local_feat_dim


def test_local_feat_dim_at_full_width():
    """The widths fold2's first layer takes at full width."""
    dims = {(e, v): Config(encoder=e, variant=v).local_feat_dim
            for e in EncoderKind for v in (Variant.TWOSTREAM,
                                           Variant.ONESTREAM)}
    assert dims == {
        (EncoderKind.VGG16, Variant.TWOSTREAM): 1472,
        (EncoderKind.ALEXNET, Variant.TWOSTREAM): 1376,
        (EncoderKind.RESNET, Variant.TWOSTREAM): 960,
        (EncoderKind.VGG16, Variant.ONESTREAM): 448,
        (EncoderKind.ALEXNET, Variant.ONESTREAM): 736,
        (EncoderKind.RESNET, Variant.ONESTREAM): 448}


def test_load_alexnet_npy_matches_jax(tmp_path):
    """A made-up BVLC npy (grouped conv2/4/5, an fc8 at 1000 classes):
    every leaf equals disn_tpu's load; the grouped layers are
    block-diagonal and their dense conv equals the per-group conv; the
    mismatched fc8 keeps the tree's weights."""
    params_j = jencoders.init_alexnet(jax.random.PRNGKey(0), num_classes=32,
                                      width_mult=0.125)
    params = _port(params_j)
    rng = np.random.RandomState(0)
    data = {}
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
        k, _, cin, cout = params[name]["weights"].shape
        g = encoders._ALEX_GROUPS.get(name, 1)
        data[name] = [rng.randn(k, k, cin // g, cout).astype(np.float32),
                      rng.randn(cout).astype(np.float32)]
    data["fc8"] = [rng.randn(5, 1000).astype(np.float32),
                   rng.randn(1000).astype(np.float32)]
    path = tmp_path / "bvlc_tiny.npy"
    np.save(path, np.asarray(data, dtype=object), allow_pickle=True)
    want = dict(checkpoint.leaves(jax.device_get(
        jencoders.load_alexnet_npy(str(path), params_j))))
    loaded = encoders.load_alexnet_npy(str(path), params)
    got = dict(checkpoint.leaves(loaded))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert torch.equal(loaded["fc8"]["weights"], params["fc8"]["weights"])
    w2 = loaded["conv2"]["weights"]
    cpg, opg = w2.shape[2] // 2, w2.shape[3] // 2
    assert not w2[:, :, :cpg, opg:].any() and not w2[:, :, cpg:, :opg].any()
    x = torch.from_numpy(rng.randn(1, 2 * cpg, 9, 9).astype(np.float32))
    grouped = torch.from_numpy(data["conv2"][0]).permute(3, 2, 0, 1)
    _close(F.conv2d(x, w2.permute(3, 2, 0, 1), padding=2),
           F.conv2d(x, grouped, padding=2, groups=2).numpy())


# --------------------------------------------------------------------------
# the model on the new encoders
# --------------------------------------------------------------------------

def _batch(seed, channels, b=2, n=64):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    rot = camera.obj_rot_matrix(30.0, 20.0, 0.0)
    return {
        "img": rng.rand(b, 137, 137, channels).astype(np.float32),
        "sdf_pt": pts,
        "sdf_pt_rot": (pts @ rot).astype(np.float32),
        "sdf_val": (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.5
                    + 0.05 * rng.randn(b, n, 1)).astype(np.float32),
        "trans_mat": np.stack([synthetic.demo_trans_mat()] * b),
    }


@pytest.mark.parametrize("variant", ["twostream", "onestream"])
@pytest.mark.parametrize("encoder,alpha", [("alexnet", False),
                                           ("alexnet", True),
                                           ("resnet", False),
                                           ("resnet", True)])
def test_apply_matches_jax(encoder, alpha, variant):
    """disn.apply with fold off and on (folded for twostream, the unfolded
    arm for onestream), every output the JAX dict has."""
    jcfg, cfg = _cfgs(encoder, alpha, variant)
    jparams = _jparams(encoder, alpha, variant)
    params = _port(jparams)
    mb = jtrainer.to_model_batch(_batch(1, cfg.img_channels))
    for fold in (False, True):
        want = jax.jit(functools.partial(jdisn.apply, cfg=jcfg, fold=fold))(
            jparams, mb)
        got = disn.apply(params, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in mb.items()}, cfg, fold=fold)
        assert set(got) == set(want), (fold, set(got) ^ set(want))
        for key in want:
            _close(_np(got[key]), want[key], what=f"{key} fold={fold}")
        if "point_img_feat" in got:
            assert got["point_img_feat"].shape[-1] == cfg.local_feat_dim


def _jloss(jcfg, params, batch):
    end_points = jdisn.apply(params, jtrainer.to_model_batch(batch), jcfg,
                             fold=True)
    return jdisn.get_loss(end_points, batch["sdf_val"] - jcfg.iso_offset,
                          params, jcfg)


@pytest.mark.parametrize("encoder,alpha", [("alexnet", True),
                                           ("resnet", False)])
def test_gradients_match_jax(encoder, alpha):
    """The trainer's loss terms and every gradient leaf (the encoder's
    included) against jax.grad of the JAX loss, within RTOL of each leaf's
    scale. The gradient is piecewise: where a ReLU's input lies within
    rounding of 0, the packages may take different sides (batch 4 has such
    a unit in the AlexNet net's global stream, fold2/conv1, which moves
    that layer by 1% and every leaf upstream of it by 0.1%). Batch 5 has
    none in either net."""
    jcfg, cfg = _cfgs(encoder, alpha)
    jparams = _jparams(encoder, alpha)
    batch = _batch(5, cfg.img_channels)
    (_, jlosses), jg = jax.jit(jax.value_and_grad(
        functools.partial(_jloss, jcfg), has_aux=True))(jparams, batch)
    state = trainer.create_state(cfg, params=_port(jparams), device="cpu")
    losses = trainer.compute_gradients(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("overall_loss", "sdf_loss", "regularization"):
        _close(float(losses[k]), float(jlosses[k]), what=k)
    flat_j = dict(checkpoint.leaves(jax.device_get(jg)))
    n = 0
    for path, p in checkpoint.leaves(state.params):
        _close(p.grad, flat_j[path], what=path)
        n += 1
    assert n == len(flat_j) > 20


def test_dense_sdf_alexnet_matches_jax():
    """The 33^3 volume of an AlexNet net on an RGBA image, by the fused
    kernel's plain version (fold 137), against the JAX volume."""
    jcfg, cfg = _cfgs("alexnet", True, sdf_res=32)
    jparams = _jparams("alexnet", True)
    img = np.random.RandomState(2).randint(0, 256, (1, 137, 137, 4),
                                           np.uint8)
    trans = synthetic.demo_trans_mat()
    want = jdense.dense_sdf(jparams, img, trans, BOX, jcfg)
    got = dense.dense_sdf(_port(jparams), img, trans, BOX, cfg,
                          device="cpu")
    assert tuple(got.shape) == (33, 33, 33)
    _close(_np(got), want)


def test_posenet_encodes_rgb_under_an_alpha_config():
    """The camera net on an RGBA image with cfg.alpha set: its VGG-16 reads
    the RGB channels, preprocessed as RGB (the JAX package encodes with
    cfg.replace(alpha=False)), equal to the JAX net on the RGB image."""
    jcfg, cfg = _cfgs("vgg16", True)
    jparams = jposenet.init(jcfg, jax.random.PRNGKey(0))
    params = _port(jparams)
    img = np.random.RandomState(5).rand(2, 137, 137, 4).astype(np.float32)
    want = jax.jit(functools.partial(jposenet.apply, cfg=jcfg))(
        jparams, jnp.asarray(img[..., :3]))
    got = posenet.apply(params, torch.from_numpy(img), cfg)
    for key in ("embedding", "pred_trans_mat"):
        _close(_np(got[key]), want[key], what=key)
