"""disn_tpu_torch's training against disn_tpu's, float32 on the CPU, from the
same params and batches: the folded forward pass, the losses, the L2 term,
every gradient leaf, Adam and momentum against optax, the schedule, a
5-step trajectory, and checkpoints that each package resumes from the
other's (width_mult 0.125, num_classes 32, B = 2, N = 64)."""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.models import disn as jdisn
from disn_tpu.models import layers as jlayers
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu.train import trainer as jtrainer
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import camera
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.models import disn, layers
from disn_tpu_torch.train import checkpoint, trainer
from torch_threads import few_threads  # noqa: F401  (autouse)

SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
             batch_size=2, num_sample_points=64)
# f32 on the CPU: XLA and torch sum convolutions and matmuls in different
# orders, so values agree to a few ulp of their scale per layer
RTOL = 1e-4


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


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jloss(jcfg, params, batch):
    end_points = jdisn.apply(params, jtrainer.to_model_batch(batch), jcfg,
                             fold=True)
    loss, losses = jdisn.get_loss(end_points, batch["sdf_val"]
                                  - jcfg.iso_offset, params, jcfg)
    return loss, (losses, end_points["pred_sdf"])


@functools.lru_cache(maxsize=None)
def _ref(kind):
    """(JAX config, port config, JAX params, jitted JAX value_and_grad of the
    train loss) for the regression or the binary head."""
    kw = dict(SMALL, binary=(kind == "binary"))
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jparams = jdisn.init(jcfg, jax.random.PRNGKey(0))
    grad = jax.jit(jax.value_and_grad(functools.partial(_jloss, jcfg),
                                      has_aux=True))
    return jcfg, cfg, jparams, grad


def _port_params(jparams):
    return convert.params_from_jax(jax.device_get(jparams))


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("kind", ["regress", "binary"])
def test_apply_and_loss_match_jax(kind):
    """pred_sdf of apply(fold=True), and every entry of get_loss."""
    jcfg, cfg, jparams, grad = _ref(kind)
    batch = _batch(1)
    (_, (jlosses, jpred)), _ = grad(jparams, batch)
    params = _port_params(jparams)
    tb = _torch(batch)
    ep = disn.apply(params, trainer.to_model_batch(tb), cfg, fold=True)
    _close(ep["pred_sdf"].detach(), jpred, what="pred_sdf")
    _, losses = disn.get_loss(ep, tb["sdf_val"] - cfg.iso_offset, params,
                              cfg)
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        if k == "accuracy":
            # a point whose prediction sits within rounding of 0 may flip
            assert abs(float(losses[k]) - float(v)) <= 1.0 / 128, k
        else:
            _close(float(losses[k]), float(v), what=k)


def test_unfolded_apply_matches_jax():
    """apply(fold=False) is the unfolded forward pass of the JAX package's
    apply(fold=False): pred_sdf and both streams' outputs, at RTOL."""
    jcfg, cfg, jparams, _ = _ref("regress")
    batch = _batch(2)
    want = jax.jit(functools.partial(jdisn.apply, cfg=jcfg, fold=False))(
        jparams, jtrainer.to_model_batch(batch))
    got = disn.apply(_port_params(jparams),
                     trainer.to_model_batch(_torch(batch)), cfg, fold=False)
    for key in ("pred_sdf", "pred_sdf_value_global",
                "pred_sdf_value_local"):
        _close(got[key].detach(), want[key], what=key)


def test_l2_regularizer_and_param_count_match_jax():
    _, _, jparams, _ = _ref("regress")
    params = _port_params(jparams)
    want = float(jlayers.l2_regularizer(jparams, 1e-5))
    # float32 sums over ~50 leaves in another order
    assert float(layers.l2_regularizer(params, 1e-5)) == pytest.approx(
        want, rel=1e-6)
    assert layers.param_count(params) == jlayers.param_count(jparams)


def test_gradients_match_jax():
    """Every gradient leaf against jax.grad of the JAX loss: max |diff| <=
    1e-4 x the leaf's max |grad| (f32 summation order, as above). The
    gradient is piecewise: where a ReLU's input or an L1 residual lies
    within rounding of 0, the two packages may take different sides, and
    one point's term flips, moving a head leaf by far more (batches 2 and
    3 have such a unit). This batch has none."""
    jcfg, cfg, jparams, grad = _ref("regress")
    batch = _batch(4)
    (jl, _), jg = grad(jparams, batch)
    state = trainer.create_state(cfg, params=_port_params(jparams),
                                 device="cpu")
    losses = trainer.compute_gradients(state, _torch(batch))
    _close(float(losses["overall_loss"]), float(jl), what="loss")
    flat_j = dict(checkpoint.leaves(jax.device_get(jg)))
    n = 0
    for path, p in checkpoint.leaves(state.params):
        _close(p.grad, flat_j[path], what=path)
        n += 1
    assert n == len(flat_j) > 30


def _random_grads(params, seed):
    rng = np.random.RandomState(seed)
    return {path: (rng.randn(*p.shape) * 10.0 ** rng.randint(-6, 1)
                   ).astype(np.float32)
            for path, p in checkpoint.leaves(params)}


@pytest.mark.parametrize("optimizer,steps", [("adam", 1), ("adam", 3),
                                             ("momentum", 1),
                                             ("momentum", 3)])
def test_optimizer_matches_optax(optimizer, steps):
    """Identical numpy gradients into the port's optimizer and optax's
    chain, with a schedule that decays between steps 1 and 2. optax scales
    mu_hat / (sqrt(nu_hat) + eps) by -lr, torch divides lr by the bias
    correction first: the same formula in another order, so the params
    agree to 1e-7 absolute (updates are ~lr = 1e-3); the moments are the
    same sums and agree to f32 rounding."""
    kw = dict(SMALL, optimizer=optimizer, learning_rate=1e-3,
              lr_decay_step=4)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    _, _, jparams, _ = _ref("regress")
    jstate = jtrainer.create_state(jcfg, None, params=jparams)
    state = trainer.create_state(cfg, params=_port_params(jparams),
                                 device="cpu")
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for i in range(steps):
        g = _random_grads(jparams, seed=10 + i)
        jstate = apply(jstate, checkpoint.unflatten(g))
        for path, p in checkpoint.leaves(state.params):
            p.grad = torch.from_numpy(g[path])
        state.apply_gradients()
    got = state.state_tree()
    want = jax.device_get({"params": jstate.params,
                           "opt_state": jstate.opt_state,
                           "step": jstate.step})
    flat_w = jcheckpoint._flatten(want)
    flat_g = checkpoint._flatten(got)
    assert set(flat_g) == set(flat_w)
    for k, w in flat_w.items():
        if k.startswith("params"):
            np.testing.assert_allclose(flat_g[k], w, rtol=0, atol=1e-7,
                                       err_msg=k)
        elif w.dtype == np.int32:
            assert int(flat_g[k]) == int(w) == steps, k
        else:
            _close(flat_g[k], w, rtol=1e-6, what=k)


def test_lr_schedule_matches_jax():
    """The JAX test's boundaries (batch 20, decay every 200k samples) and
    the floor."""
    cfg = Config(learning_rate=1e-4, batch_size=20, lr_decay_step=200_000,
                 lr_decay_rate=0.9, lr_floor=1e-6)
    jsched = jtrainer.lr_schedule(JConfig(**{
        k: getattr(cfg, k) for k in ("learning_rate", "batch_size",
                                     "lr_decay_step", "lr_decay_rate",
                                     "lr_floor")}))
    sched = trainer.lr_schedule(cfg)
    for step, want in ((0, 1e-4), (9_999, 1e-4), (10_000, 9e-5),
                       (20_000, 8.1e-5), (100_000_000, 1e-6)):
        assert sched(step) == pytest.approx(want, rel=1e-12)
        # JAX computes it in float32
        assert sched(step) == pytest.approx(float(jsched(jnp.int32(step))),
                                            rel=1e-6)


def _jax_steps(jcfg, jstate, grad, batches):
    """JAX train steps through the jitted gradient; returns the state and
    the losses."""
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    out = []
    for b in batches:
        (loss, _), g = grad(jstate.params, b)
        out.append(float(loss))
        jstate = apply(jstate, g)
    return jstate, out


def test_trajectory_matches_jax():
    """5 train steps on 5 batches: each step's loss against the JAX step's.
    Adam turns a rounding-level gradient difference into an update of up
    to 2 lr where a gradient is near 0, so the losses drift apart by more
    than one forward pass's rounding: 1e-4 relative."""
    jcfg, cfg, jparams, grad = _ref("regress")
    batches = [_batch(20 + i) for i in range(5)]
    _, jlosses = _jax_steps(jcfg, jtrainer.create_state(
        jcfg, None, params=jparams), grad, batches)
    state = trainer.create_state(cfg, params=_port_params(jparams),
                                 device="cpu")
    step = trainer.make_train_step(cfg, device="cpu")
    losses = []
    for b in batches:
        state, out = step(state, b)
        losses.append(float(out["overall_loss"]))
        assert out["lr"] == 1e-4
    assert state.step == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def _jax_target(jstate):
    return {"params": jstate.params, "opt_state": jstate.opt_state,
            "step": jstate.step}


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_port_checkpoint_resumes_in_jax(tmp_path, optimizer):
    """A port-written latest.npz after 2 steps reads into a JAX TrainState's
    tree (disn_tpu.train.checkpoint.restore) leaf for leaf, and the JAX
    loss of the next batch from it is the port's."""
    jcfg, cfg, jparams, grad = _ref("regress")
    cfg = cfg.replace(optimizer=optimizer)
    state = trainer.create_state(cfg, params=_port_params(jparams),
                                 device="cpu")
    step = trainer.make_train_step(cfg, device="cpu")
    for i in range(2):
        state, _ = step(state, _batch(30 + i))
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save_latest(state.state_tree(), state.step)
    path = mgr.latest_path()
    assert checkpoint.load_metadata(path)["step"] == 2

    jstate = jtrainer.create_state(jcfg.replace(optimizer=optimizer), None,
                                   params=jparams)
    restored = jcheckpoint.restore(path, _jax_target(jstate))
    want = checkpoint._flatten(state.state_tree())
    flat = jcheckpoint._flatten(restored)
    assert set(flat) == set(want)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    nxt = _batch(32)
    (jl, _), _ = grad(restored["params"], nxt)
    _, out = step(state, nxt)
    assert float(out["overall_loss"]) == pytest.approx(float(jl), rel=1e-5)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX latest.npz after 2 JAX steps, written as `python -m disn_tpu
    train` writes it, resumes in the port: the next loss is JAX's, the
    moments and counts are JAX's, and one more update from the same
    gradients lands where optax's does."""
    jcfg, cfg, jparams, grad = _ref("regress")
    jstate, _ = _jax_steps(jcfg, jtrainer.create_state(
        jcfg, None, params=jparams), grad, [_batch(40), _batch(41)])
    path = str(tmp_path / "latest.npz")
    jcheckpoint.save(path, jax.device_get(_jax_target(jstate)),
                     {"step": 2})

    state = trainer.create_state(cfg, seed=3, device="cpu")
    state.load_state_tree(checkpoint.restore(path, state.state_tree()))
    assert state.step == 2
    flat = checkpoint._flatten(state.state_tree())
    for k, v in jcheckpoint._flatten(jax.device_get(_jax_target(jstate))
                                     ).items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)

    nxt = _batch(42)
    (jl, _), jg = grad(jstate.params, nxt)
    losses = trainer.compute_gradients(state, _torch(nxt))
    assert float(losses["overall_loss"]) == pytest.approx(float(jl),
                                                          rel=1e-5)
    flat_g = dict(checkpoint.leaves(jax.device_get(jg)))
    for path_, p in checkpoint.leaves(state.params):
        p.grad = torch.from_numpy(np.array(flat_g[path_]))
    state.apply_gradients()
    jstate = jax.jit(lambda s, g: s.apply_gradients(g))(jstate, jg)
    want = dict(checkpoint.leaves(jax.device_get(jstate.params)))
    for path_, p in checkpoint.leaves(state.params):
        np.testing.assert_allclose(p.detach().numpy(), want[path_], rtol=0,
                                   atol=1e-7, err_msg=path_)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"vgg_16": {"conv1": {"conv1_1": {
                "weights": rng.randn(3, 3, 3, 8).astype(np.float32),
                "biases": rng.randn(8).astype(np.float32)}},
            "fc8": {"weights": rng.randn(1, 1, 16, 4).astype(np.float32),
                    "biases": rng.randn(4).astype(np.float32)}},
            "sdfprediction": {"fold1": {"conv1": {
                "weights": rng.randn(3, 64).astype(np.float32)}}}}


def test_checkpoint_roundtrip_and_jax_names(tmp_path):
    """save / load_metadata / restore, and the file reads in JAX."""
    tree = {"params": _tree(0), "step": np.asarray(7, np.int32)}
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, tree, metadata={"epoch": 7})
    assert checkpoint.load_metadata(path)["epoch"] == 7
    assert jcheckpoint.load_metadata(path)["epoch"] == 7
    target = {"params": _tree(1), "step": np.zeros((), np.int64)}
    restored = checkpoint.restore(path, target)
    assert restored["step"].dtype == np.int64 and int(restored["step"]) == 7
    for (k, a), (_, b) in zip(checkpoint.leaves(tree["params"]),
                              checkpoint.leaves(restored["params"])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    with np.load(path) as z:
        assert set(z.files) == set(jcheckpoint._flatten(tree)) | {
            "__metadata__"}
    bad = {"params": _tree(0), "step": np.zeros(3, np.int32)}
    with pytest.raises(ValueError):
        checkpoint.restore(path, bad)


def test_restore_params_and_merge(tmp_path):
    """As tests/test_train.py: scopes, shape-mismatch skips and the
    --restore-cnn exclusion of fc8."""
    p1, p2 = _tree(0), _tree(9)
    path = str(tmp_path / "donor.npz")
    checkpoint.save(path, p2)
    donor = checkpoint.restore_params(path)
    merged, _ = checkpoint.merge_scopes(p1, donor, scopes=("vgg_16",))
    np.testing.assert_array_equal(
        merged["vgg_16"]["conv1"]["conv1_1"]["weights"],
        p2["vgg_16"]["conv1"]["conv1_1"]["weights"])
    np.testing.assert_array_equal(
        merged["sdfprediction"]["fold1"]["conv1"]["weights"],
        p1["sdfprediction"]["fold1"]["conv1"]["weights"])
    assert merged["vgg_16"] is not p1["vgg_16"]  # p1 is left as it was
    donor["vgg_16"]["fc8"]["weights"] = np.zeros((1, 1, 16, 99), np.float32)
    merged2, skipped2 = checkpoint.merge_scopes(p1, donor,
                                                scopes=("vgg_16",))
    assert "vgg_16/fc8/weights" in skipped2
    np.testing.assert_array_equal(merged2["vgg_16"]["fc8"]["weights"],
                                  p1["vgg_16"]["fc8"]["weights"])
    _, skipped3 = checkpoint.merge_scopes(p1, donor, scopes=("vgg_16",),
                                          skip_substr=("fc8",))
    assert skipped3 == ["vgg_16/fc8"]
    # the same merge in JAX skips the same leaves
    _, jskipped = jcheckpoint.merge_scopes(p1, donor, scopes=("vgg_16",),
                                           skip_substr=("fc8",))
    assert jskipped == skipped3


def test_checkpoint_manager(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), period=2)
    tree = {"w": np.arange(4, dtype=np.float32)}
    mgr.save_latest(tree, step=5)
    mgr.save_epoch(tree, epoch=2, metric=0.5)
    mgr.save_epoch({"w": np.ones(4, np.float32)}, epoch=3, metric=0.9)
    mgr.save_epoch({"w": np.zeros(4, np.float32)}, epoch=4, metric=0.1)
    assert mgr.latest_path() and mgr.best_path()
    best = jcheckpoint.restore_params(mgr.best_path())
    np.testing.assert_array_equal(best["w"], np.ones(4, np.float32))
    assert jcheckpoint.load_metadata(mgr.best_path())["epoch"] == 3
    assert sorted(os.listdir(tmp_path)) == [
        "best.npz", "epoch_002.npz", "epoch_004.npz", "latest.npz"]
