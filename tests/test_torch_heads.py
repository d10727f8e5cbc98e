"""disn_tpu_torch's 3-D layers, batch norm, dropout and the other SDF heads
(onestream, the split and folded-local two-stream forms, the 3D-CNN volume
decoder) against disn_tpu's, float32 on the CPU from the same seeded numpy
inputs and params (convert.params_from_jax), and the converters on the new
param trees. Tolerance: 1e-4 of the output's scale unless a test says
otherwise (XLA and torch sum matmuls and convolutions in other orders)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.config import Variant as JVariant
from disn_tpu.models import disn as jdisn
from disn_tpu.models import layers as jlayers
from disn_tpu.models import sdfnet as jsdfnet
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu.train import trainer as jtrainer
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.models import disn, layers, sdfnet
from disn_tpu_torch.train import checkpoint, trainer
from torch_threads import few_threads  # noqa: F401  (autouse)

RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(tree):
    return convert.params_from_jax(jax.device_get(tree))


@pytest.mark.parametrize("k,padding,n", [(2, "SAME", 1), (2, "SAME", 3),
                                         (3, "SAME", 2), (3, "SAME", 5),
                                         (3, "VALID", 4), (3, "VALID", 32)])
def test_conv3d_transpose_matches_jax(k, padding, n):
    """Stride 2: k2 SAME and k3 SAME double n, k3 VALID gives 2n + 1, as
    jax.lax.conv_transpose (no kernel flip) pads and correlates."""
    rng = np.random.RandomState(n + 10 * k)
    x = rng.randn(2, n, n, n, 5).astype(np.float32)
    p = {"weights": rng.randn(k, k, k, 5, 3).astype(np.float32),
         "biases": rng.randn(3).astype(np.float32)}
    want = jlayers.conv3d_transpose(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x), (2, 2, 2), padding)
    got = layers.conv3d_transpose(convert.params_from_jax(p),
                                  torch.from_numpy(x), (2, 2, 2), padding)
    assert got.shape == want.shape == (
        2, 2 * n + (padding == "VALID"), 2 * n + (padding == "VALID"),
        2 * n + (padding == "VALID"), 3)
    _close(got, want)


@pytest.mark.parametrize("binary", [False, True])
def test_3dcnn_head_matches_jax(binary):
    """The whole stack 1 -> 2 -> 4 -> 8 -> 16 -> 32 -> 65 and the 1x1x1 head
    (narrow: an embedding of 16)."""
    jp = jsdfnet.init_3dcnn_head(jax.random.PRNGKey(3), global_dim=16,
                                 binary=binary)
    feat = np.random.RandomState(4).randn(2, 16).astype(np.float32)
    want = jax.jit(jsdfnet.apply_3dcnn_head)(jp, jnp.asarray(feat))
    got = sdfnet.apply_3dcnn_head(_t(jp), torch.from_numpy(feat))
    assert got.shape == (2, 65 ** 3, 2 if binary else 1)
    _close(got, want)


def test_3dcnn_init_builds_the_jax_tree():
    jp = jsdfnet.init_3dcnn_head(jax.random.PRNGKey(0), global_dim=16,
                                 binary=True)
    p = sdfnet.init_3dcnn_head(torch.Generator(), torch.device("cpu"),
                               global_dim=16, binary=True)
    flat_j = dict(checkpoint.leaves(jax.device_get(jp)))
    flat = dict(checkpoint.leaves(p))
    assert set(flat) == set(flat_j)
    for k, v in flat_j.items():
        assert tuple(flat[k].shape) == v.shape, k


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("shape", [(6, 4), (2, 5, 3, 4), (2, 3, 3, 3, 4)])
def test_batch_norm_matches_jax(training, shape):
    """BC / BHWC / BDHWC: the population variance, eps 1e-3, and in
    training the EMA of the moving moments at decay 0.9 (rtol 1e-5: the
    same f32 reductions in another order)."""
    rng = np.random.RandomState(len(shape))
    x = (3.0 * rng.randn(*shape) + 1.0).astype(np.float32)
    c = shape[-1]
    p = {"gamma": rng.rand(c).astype(np.float32) + 0.5,
         "beta": rng.randn(c).astype(np.float32),
         "moving_mean": rng.randn(c).astype(np.float32),
         "moving_variance": rng.rand(c).astype(np.float32) + 0.5}
    want, jnew = jlayers.batch_norm(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x), is_training=training)
    got, new = layers.batch_norm(convert.params_from_jax(p),
                                 torch.from_numpy(x), is_training=training)
    _close(got, want, rtol=1e-5)
    for k in p:
        _close(new[k], jnew[k], rtol=1e-5)
    init = layers.init_batch_norm(c, torch.device("cpu"))
    for k, v in jlayers.init_batch_norm(c).items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v))


def test_dropout_keeps_and_scales_as_jax():
    """Not training (or rate 0): the identity in both packages. Training:
    kept values are x / keep, dropped ones 0, and over 200,000 draws the
    kept share is within 4 standard deviations (0.0044) of keep = 0.7 in
    both packages (their generators differ, so the masks do too)."""
    x = np.random.RandomState(0).rand(200_000).astype(np.float32) + 1.0
    gen = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x)
    assert layers.dropout(gen, xt, 0.3, is_training=False) is xt
    assert layers.dropout(gen, xt, 0.0) is xt
    np.testing.assert_array_equal(np.asarray(jlayers.dropout(
        jax.random.PRNGKey(0), jnp.asarray(x), 0.3, is_training=False)), x)
    keep = 0.7
    sd = np.sqrt(keep * (1 - keep) / x.size)
    for y in (layers.dropout(gen, xt, 0.3).numpy(),
              np.asarray(jlayers.dropout(jax.random.PRNGKey(1),
                                         jnp.asarray(x), 0.3))):
        kept = y != 0
        assert abs(kept.mean() - keep) <= 4 * sd
        np.testing.assert_allclose(y[kept], x[kept] / keep, rtol=1e-6)
    a = layers.dropout(torch.Generator().manual_seed(5), xt, 0.3)
    b = layers.dropout(torch.Generator().manual_seed(5), xt, 0.3)
    assert torch.equal(a, b)
    m = layers.dropout(gen, torch.ones(4, 3), 0.5, noise_shape=(4, 1))
    assert bool(((m == 0) | (m == 2)).all()) and bool(
        (m == m[:, :1]).all())


@functools.lru_cache(maxsize=None)
def _streams(binary):
    """Narrow seeded heads: global (G 16), local (L 24), onestream
    (16 + 12)."""
    k = jax.random.split(jax.random.PRNGKey(7), 3)
    return (jsdfnet.init_global_head(k[0], 16, binary),
            jsdfnet.init_local_head(k[1], 24, binary),
            jsdfnet.init_onestream_head(k[2], 16, 12, binary))


def _inputs(n=50, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (2, n, 3)).astype(np.float32),
            rng.randn(2, 16).astype(np.float32),
            [rng.randn(2, n, c).astype(np.float32) for c in (8, 16)],
            rng.randn(2, n, 512).astype(np.float32),
            rng.randn(2, n, 12).astype(np.float32))


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("fn", ["onestream", "split", "folded_local"])
def test_heads_match_jax(fn, binary):
    jg, jl, jo = _streams(binary)
    pts, emb, feats, contrib, loc3 = _inputs(seed=int(binary))
    J = jnp.asarray
    T = torch.from_numpy
    if fn == "onestream":
        want = jsdfnet.apply_onestream_head(jo, J(pts), J(emb), J(loc3))
        got = sdfnet.apply_onestream_head(_t(jo), T(pts), T(emb), T(loc3))
    elif fn == "split":
        want = jsdfnet.apply_two_stream_split(jg, jl, J(pts), J(emb),
                                              [J(f) for f in feats])
        got = sdfnet.apply_two_stream_split(_t(jg), _t(jl), T(pts), T(emb),
                                            [T(f) for f in feats])
        # and the split form is the concatenated form's value
        cat = torch.cat([T(f) for f in feats], dim=-1)
        _close(got, sdfnet.apply_global_head(_t(jg), T(pts), T(emb))
               + sdfnet.apply_local_head(_t(jl), T(pts), cat))
    else:
        want = jsdfnet.apply_local_head_folded(jl, J(pts), J(contrib))
        got = sdfnet.apply_local_head_folded(_t(jl), T(pts), T(contrib))
    assert got.shape == (2, pts.shape[1], 2 if binary else 1)
    _close(got, want)


@pytest.mark.parametrize("variant", ["onestream", "global", "threedcnn"])
def test_params_and_optimizer_state_convert_for_every_variant(variant,
                                                              tmp_path):
    """params_from_jax carries a JAX init of the variant (sdfimgfeat,
    sdfprediction alone, sdf3dcnn with 5-D DHWIO kernels and 3conv7) leaf
    for leaf, disn.init builds the same tree with the same shapes, and the
    optimizer-state converters round-trip through a JAX TrainState's
    checkpoint tree."""
    kw = dict(num_classes=16, width_mult=0.125, variant=variant)
    jcfg = JConfig(**dict(kw, variant=JVariant(variant)))
    cfg = Config(**dict(kw, variant=Variant(variant)))
    jparams = jdisn.init(jcfg, jax.random.PRNGKey(0))
    params = _t(jparams)
    flat_j = dict(checkpoint.leaves(jax.device_get(jparams)))
    flat = dict(checkpoint.leaves(params))
    own = dict(checkpoint.leaves(disn.init(cfg, device="cpu")))
    assert set(flat) == set(flat_j) == set(own)
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat[k].numpy(), np.asarray(v))
        assert tuple(own[k].shape) == v.shape, k
    if variant == "threedcnn":
        assert flat["sdf3dcnn$3deconv6$weights"].dim() == 5
        assert "sdf3dcnn$3conv7$weights" in flat
    jstate = jtrainer.create_state(jcfg, None, params=jparams)
    state = trainer.create_state(cfg, params=params, device="cpu")
    rng = np.random.RandomState(1)
    for _, p in checkpoint.leaves(state.params):
        p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
    state.apply_gradients()
    path = str(tmp_path / "latest.npz")
    checkpoint.save(path, state.state_tree())
    restored = jcheckpoint.restore(path, {
        "params": jstate.params, "opt_state": jstate.opt_state,
        "step": jstate.step})
    mine = checkpoint._flatten(state.state_tree())
    theirs = jcheckpoint._flatten(restored)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
    back = trainer.create_state(cfg, params=params, device="cpu")
    back.load_state_tree(checkpoint.restore(path, back.state_tree()))
    for k, v in checkpoint._flatten(back.state_tree()).items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)
