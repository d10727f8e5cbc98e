"""disn_tpu_torch's forward pass, loss and train step for every variant
(twostream, onestream, global, 3D-CNN), head (regression, binary, tanh),
sampling (tf1, native) and fold against disn_tpu's, float32 on the CPU at
CI width (width_mult 0.125, 32 classes, B = 2, N = 64), from the same
params (convert.params_from_jax) and seeded numpy batches. Tolerance: 1e-4
of each output's scale (XLA and torch sum convolutions and matmuls in other
orders)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.config import Variant as JVariant
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.models import disn as jdisn
from disn_tpu.train import trainer as jtrainer
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import camera
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.models import disn
from disn_tpu_torch.train import checkpoint, trainer
from torch_threads import few_threads  # noqa: F401  (autouse)

SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
             batch_size=2, num_sample_points=64)
RTOL = 1e-4
BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)

# (variant, binary, sampling, tanh): every variant with both heads, both
# samplings where the variant samples the image, tanh on half of them
CASES = [(v, b, s, b != (s == "native"))
         for v in ("twostream", "onestream") for b in (False, True)
         for s in ("tf1", "native")]
CASES += [("global", False, "tf1", True), ("global", True, "tf1", False),
          ("threedcnn", False, "tf1", False),
          ("threedcnn", True, "tf1", True)]


def _cfgs(variant="twostream", **kw):
    kw = dict(SMALL, **kw)
    return (JConfig(**dict(kw, variant=JVariant(variant))),
            Config(**dict(kw, variant=Variant(variant))))


@functools.lru_cache(maxsize=None)
def _jparams(variant, binary):
    """A JAX init whose head biases are seeded N(0, 0.1^2) instead of 0, so
    that every bias add counts and the 3D-CNN head's logits are O(0.1), not
    the ~1e-7 of its zero-bias init."""
    jcfg, _ = _cfgs(variant, binary=binary)
    params = jax.device_get(jdisn.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(9)

    def biased(tree):
        return {k: (biased(v) if isinstance(v, dict) else
                    (0.1 * rng.randn(*v.shape)).astype(np.float32)
                    if k == "biases" else v) for k, v in tree.items()}

    return jax.tree_util.tree_map(jnp.asarray, {
        k: (v if k == "vgg_16" else biased(v)) for k, v in params.items()})


def _batch(seed=0, b=2, n=64):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    rot = camera.obj_rot_matrix(30.0, 20.0, 0.0)
    return {
        "img": rng.rand(b, 137, 137, 3).astype(np.float32),
        "sdf_pt": pts,
        "sdf_pt_rot": (pts @ rot).astype(np.float32),
        "sdf_val": (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.5
                    + 0.05 * rng.randn(b, n, 1)).astype(np.float32),
        "trans_mat": np.stack([synthetic.demo_trans_mat()] * b),
    }


def _close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("variant,binary,sampling,tanh", CASES)
def test_apply_matches_jax(variant, binary, sampling, tanh):
    """Both arms of apply: fold=False (the unfolded forward pass, every
    intermediate the JAX dict has) and fold=True (folded for twostream +
    tf1, the unfolded arm otherwise), each against the JAX call with the
    same fold."""
    jcfg, cfg = _cfgs(variant, binary=binary, sampling=sampling, tanh=tanh)
    jparams = _jparams(variant, binary)
    params = convert.params_from_jax(jax.device_get(jparams))
    mb = jtrainer.to_model_batch(_batch(1))
    for fold in (False, True):
        want = jax.jit(functools.partial(jdisn.apply, cfg=jcfg, fold=fold))(
            jparams, mb)
        got = disn.apply(params, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in mb.items()}, cfg, fold=fold)
        assert set(got) == set(want), (fold, set(got) ^ set(want))
        for key in want:
            _close(got[key].detach(), want[key], what=f"{key} fold={fold}")
        out = 2 if binary else 1
        n = 65 ** 3 if variant == "threedcnn" else 64
        assert got["pred_sdf"].shape == (2, n, out)
        if tanh:
            assert float(got["pred_sdf"].abs().max()) <= 1.0


@pytest.mark.parametrize("binary", [False, True])
def test_threedcnn_volume_matches_jax(binary):
    """predict_volume of the 3D-CNN variant: one forward to the fixed 65^3
    grid, scaled as the point heads are, whatever sdf_res says."""
    jcfg, cfg = _cfgs("threedcnn", binary=binary, sdf_res=32)
    jparams = _jparams("threedcnn", binary)
    img = np.random.RandomState(2).randint(0, 256, (137, 137, 3), np.uint8)
    trans = synthetic.demo_trans_mat()
    want = jpipeline.predict_volume(jparams, img, trans, BOX, jcfg)
    got = pipeline.predict_volume(convert.params_from_jax(
        jax.device_get(jparams)), img, trans, BOX, cfg, device="cpu")
    assert got.shape == (65, 65, 65)
    _close(got, want)


def _jloss(jcfg, params, batch):
    end_points = jdisn.apply(params, jtrainer.to_model_batch(batch), jcfg,
                             fold=True)
    loss, losses = jdisn.get_loss(end_points, batch["sdf_val"]
                                  - jcfg.iso_offset, params, jcfg)
    return loss, losses


@pytest.mark.parametrize("variant", ["onestream", "global"])
def test_train_step_matches_jax(variant):
    """One train step through apply's fallthrough (the trainer's
    fold=True): the loss terms, every gradient leaf against jax.grad, and
    the Adam update of those gradients against the JAX update's params
    (atol 1e-7; updates are ~lr = 1e-4). The gradient is
    piecewise (a ReLU input or L1 residual within rounding of 0 may take
    the other side in the other package); this batch has no such unit."""
    jcfg, cfg = _cfgs(variant)
    jparams = _jparams(variant, False)
    batch = _batch(4)
    (jl, jlosses), jg = jax.jit(jax.value_and_grad(
        functools.partial(_jloss, jcfg), has_aux=True))(jparams, batch)
    state = trainer.create_state(cfg, params=convert.params_from_jax(
        jax.device_get(jparams)), device="cpu")
    losses = trainer.compute_gradients(state, _torch(batch))
    for k in ("overall_loss", "sdf_loss", "regularization"):
        _close(float(losses[k]), float(jlosses[k]), what=k)
    flat_j = dict(checkpoint.leaves(jax.device_get(jg)))
    for path, p in checkpoint.leaves(state.params):
        _close(p.grad, flat_j[path], what=path)
    assert len(flat_j) == len(list(checkpoint.leaves(state.params))) > 20
    # the update from the same (JAX's) gradients: Adam's g / sqrt(v) turns
    # a 1e-4 gradient difference into a whole step where g is near 0
    for path, p in checkpoint.leaves(state.params):
        p.grad = torch.from_numpy(np.array(flat_j[path]))
    state.apply_gradients()
    jstate = jtrainer.create_state(jcfg, None, params=jparams)
    jstate = jax.jit(lambda s, g: s.apply_gradients(g))(jstate, jg)
    want = dict(checkpoint.leaves(jax.device_get(jstate.params)))
    for path, p in checkpoint.leaves(state.params):
        np.testing.assert_allclose(p.detach().numpy(), want[path], rtol=0,
                                   atol=1e-7, err_msg=path)


def test_threedcnn_train_step_refuses_like_jax():
    """The 3D-CNN head predicts its fixed 65^3 grid, [B, 274625, 1], which
    the loss cannot pair with the batch's [B, N, 1] sample values: the JAX
    step fails on the broadcast, the port's step raises a ValueError that
    says so."""
    jcfg, cfg = _cfgs("threedcnn")
    jparams = _jparams("threedcnn", False)
    batch = _batch(5)
    jstate = jtrainer.create_state(jcfg, None, params=jparams)
    with pytest.raises(TypeError, match="broadcast"):
        jtrainer.make_train_step(jcfg, donate=False)(jstate, batch)
    state = trainer.create_state(cfg, params=convert.params_from_jax(
        jax.device_get(jparams)), device="cpu")
    step = trainer.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="sample points"):
        step(state, batch)
