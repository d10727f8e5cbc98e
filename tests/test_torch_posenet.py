"""disn_tpu_torch's camera net against disn_tpu's, float32 on the CPU from
the same params (converted from a disn_tpu.models.posenet.init tree) and
seeded numpy batches: apply_heads and apply with and without the shift
head, get_loss in its four modes with shifts and the L2 term, every
gradient leaf against jax.grad, three camera train steps against
disn_tpu.train.make_cam_train_step, the truncated-normal init, and the
bundled float16 checkpoint (width_mult 0.125, num_classes 32, B = 2,
N = 64 unless said)."""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.models import posenet as jposenet
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu.train import trainer as jtrainer
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import camera
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.models import layers, posenet
from disn_tpu_torch.train import checkpoint, trainer
from torch_threads import few_threads  # noqa: F401  (autouse)

SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
             batch_size=2, num_sample_points=64, learning_rate=1e-3)
MODES = ("3D", "2D", "3DM", "all")
# f32 on the CPU: XLA and torch sum convolutions and matmuls in different
# orders, so values agree to a few ulp of their scale per layer
RTOL = 1e-4
BUNDLED = os.path.join(os.path.dirname(os.path.dirname(__file__)), "demo",
                       "tiny_posenet.npz")


def _batch(seed=0, b=2, n=64, shift=False):
    """Images, sample points, and each view's regress_mat and trans_mat
    from the synthetic renderer's camera at seeded angles."""
    rng = np.random.RandomState(seed)
    mats = [camera.view_params_to_trans_mat(
        rng.uniform(0, 360), rng.uniform(-10, 40), rng.uniform(0.8, 1.2),
        np.zeros(3), 1.0)[:2] for _ in range(b)]
    out = {"img": rng.rand(b, 137, 137, 3).astype(np.float32),
           "sample_pc": rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32),
           "RT": np.stack([m[1] for m in mats]),
           "trans_mat": np.stack([m[0] for m in mats])}
    if shift:
        out["shifts"] = rng.uniform(-0.2, 0.2, (b, 2)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jloss(jcfg, params, batch):
    ep = jposenet.apply(params, batch["img"], jcfg)
    loss, losses = jposenet.get_loss(ep, batch, params, jcfg)
    return loss, (losses, ep)


@functools.lru_cache(maxsize=None)
def _ref(shift: bool, mode: str = "3DM"):
    """(JAX config, port config, JAX params, jitted JAX value_and_grad of
    the camera loss)."""
    kw = dict(SMALL, cam_shift=shift, cam_loss_mode=mode)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jparams = jposenet.init(jcfg, jax.random.PRNGKey(0))
    grad = jax.jit(jax.value_and_grad(functools.partial(_jloss, jcfg),
                                      has_aux=True))
    return jcfg, cfg, jparams, grad


def _port(jparams):
    return convert.params_from_jax(jax.device_get(jparams))


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("shift", [False, True])
def test_init_matches_jax_tree(shift):
    """The same leaf paths, shapes and dtypes as the JAX package's init;
    biases zero."""
    jcfg, cfg, jparams, _ = _ref(shift)
    params = posenet.init(cfg, seed=0, device="cpu")
    flat_j = {p: np.asarray(v) for p, v in checkpoint.leaves(jparams)}
    flat = dict(checkpoint.leaves(params))
    assert set(flat) == set(flat_j)
    assert ("cameraprediction$xyshift$fc3$weights" in flat) == shift
    for p, v in flat.items():
        assert tuple(v.shape) == flat_j[p].shape and v.dtype == torch.float32
        if p.endswith("biases"):
            assert not v.any(), p
    assert layers.param_count(params) == sum(v.size for v in flat_j.values())


def test_truncated_normal_range_and_spread():
    """Cut at +-2 sigma: every draw within 2 x stddev; the spread is the
    cut normal's (sigma x 0.8796) and its mean 0, at 1e5 draws (standard
    errors ~0.002 and ~0.003 of sigma); seeded draws repeat; the
    translation head's last kernel is such a draw."""
    gen = torch.Generator().manual_seed(0)
    x = layers.truncated_normal(gen, (100_000,), 0.05, torch.device("cpu"))
    assert float(x.abs().max()) <= 0.1
    assert float(x.abs().max()) > 0.099
    assert abs(float(x.std()) / 0.05 - 0.8796) < 0.01
    assert abs(float(x.mean())) / 0.05 < 0.01
    again = layers.truncated_normal(torch.Generator().manual_seed(0),
                                    (100_000,), 0.05, torch.device("cpu"))
    assert torch.equal(x, again)
    w = posenet.init(Config(**SMALL), device="cpu")[
        "cameraprediction"]["translation"]["fc3"]["weights"]
    assert tuple(w.shape) == (64, 3) and float(w.abs().max()) <= 0.1


@pytest.mark.parametrize("shift", [False, True])
def test_apply_matches_jax(shift):
    """apply: embedding, rotation, translation, pred_RT, pred_trans_mat
    (and pred_xyshift); apply_heads alone on the JAX embedding."""
    jcfg, cfg, jparams, _ = _ref(shift)
    batch = _batch(1)
    want = jposenet.apply(jparams, jnp.asarray(batch["img"]), jcfg)
    params = _port(jparams)
    got = posenet.apply(params, torch.from_numpy(batch["img"]), cfg)
    keys = {"embedding", "pred_rotation", "pred_translation", "pred_RT",
            "pred_trans_mat"} | ({"pred_xyshift"} if shift else set())
    assert set(got) == set(want) == keys
    for k in keys:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k].detach(), want[k], what=k)
    heads = posenet.apply_heads(params["cameraprediction"],
                                torch.from_numpy(np.array(
                                    want["embedding"])))
    jheads = jposenet.apply_heads(jparams["cameraprediction"],
                                  want["embedding"])
    assert set(heads) == set(jheads)
    for k in jheads:
        _close(heads[k].detach(), jheads[k], what="heads " + k)


def test_apply_takes_uint8_and_rgba():
    """A uint8 image is divided by 255 on its device; an alpha channel is
    dropped (the net is RGB)."""
    _, cfg, jparams, _ = _ref(False)
    params = _port(jparams)
    img8 = np.random.RandomState(2).randint(0, 256, (1, 137, 137, 4),
                                            dtype=np.uint8)
    a = posenet.apply(params, torch.from_numpy(img8), cfg)["pred_trans_mat"]
    b = posenet.apply(params, torch.from_numpy(img8[..., :3]).float() / 255.0,
                      cfg)["pred_trans_mat"]
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shift", [False, True])
def test_get_loss_matches_jax(mode, shift):
    """Every entry of get_loss in each mode, with the batch's shifts when
    the shift head is on and the L2 term (regularization defaults on)."""
    jcfg, cfg, jparams, grad = _ref(shift, mode)
    assert cfg.regularization
    batch = _batch(2, shift=shift)
    (jl, (jlosses, _)), _ = grad(jparams, batch)
    params = _port(jparams)
    tb = _torch(batch)
    ep = posenet.apply(params, tb["img"], cfg)
    loss, losses = posenet.get_loss(ep, tb, params, cfg)
    assert set(losses) == set(jlosses)
    assert ("shiftxy_loss" in losses) == shift
    for k, v in jlosses.items():
        _close(float(losses[k]), float(v), what=k)
    _close(float(loss), float(jl), what="loss")


@pytest.mark.parametrize("shift", [False, True])
def test_gradients_match_jax(shift):
    """Every gradient leaf against jax.grad of the JAX loss ("all" mode,
    so every term has a gradient): max |diff| <= 1e-4 x the leaf's max
    |grad| (f32 summation order). The gradient is piecewise: where a
    ReLU's input lies within rounding of 0 the two packages may take
    different sides and move an encoder leaf by up to 1% (batch 3 has such
    a unit). This batch has none."""
    jcfg, cfg, jparams, grad = _ref(shift, "all")
    batch = _batch(4, shift=shift)
    (jl, _), jg = grad(jparams, batch)
    state = trainer.create_state(cfg, params=_port(jparams), device="cpu")
    losses = trainer.compute_gradients(state, _torch(batch),
                                       trainer.cam_loss_fn)
    _close(float(losses["overall_loss"]), float(jl), what="loss")
    flat_j = dict(checkpoint.leaves(jax.device_get(jg)))
    n = 0
    for path, p in checkpoint.leaves(state.params):
        assert p.grad is not None, path
        _close(p.grad, flat_j[path], what=path)
        n += 1
    assert n == len(flat_j) == 32 + 6 * (3 + shift)


def test_three_cam_train_steps_match_jax():
    """Three make_cam_train_step steps from the same state on three
    batches (shift head on) against the JAX jitted step: each step's
    losses, and every parameter after them. Adam turns rounding-level
    gradient differences into updates of up to 2 lr where a gradient is
    near 0, so the parameters are held to 3 steps x 2 lr + 1e-4 of their
    scale, the losses to 1e-4 relative."""
    jcfg, cfg, jparams, _ = _ref(True)
    batches = [_batch(10 + i, shift=True) for i in range(3)]
    jstate = jtrainer.create_state(jcfg, None, params=jparams)
    jstep = jtrainer.make_cam_train_step(jcfg, donate=False)
    state = trainer.create_state(cfg, params=_port(jparams), device="cpu")
    step = trainer.make_cam_train_step(cfg, device="cpu")
    for i, b in enumerate(batches):
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, losses = step(state, b)
        assert losses["lr"] == pytest.approx(float(jl["lr"]), rel=1e-6)
        for k in jl:
            if k != "lr":
                _close(float(losses[k]), float(jl[k]), what=f"{i} {k}")
    assert state.step == int(jstate.step) == 3
    flat_j = dict(checkpoint.leaves(jax.device_get(jstate.params)))
    for path, p in checkpoint.leaves(state.params):
        w = np.asarray(flat_j[path])
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=0,
            atol=6 * cfg.learning_rate + RTOL * float(np.abs(w).max()),
            err_msg=path)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A port-written camera checkpoint (the $-joined npz) restores into
    the JAX net, which then predicts the port's cameras."""
    jcfg, cfg, jparams, _ = _ref(True)
    params = posenet.init(cfg, seed=3, device="cpu")
    path = str(tmp_path / "cam.npz")
    checkpoint.save(path, {"params": params})
    donor = jcheckpoint.restore_params(path)["params"]
    img = _batch(4)["img"]
    want = jposenet.apply(jax.tree_util.tree_map(jnp.asarray, donor),
                          jnp.asarray(img), jcfg)["pred_trans_mat"]
    got = posenet.apply(params, torch.from_numpy(img), cfg)["pred_trans_mat"]
    _close(got.detach(), want, what="pred_trans_mat")


def test_bundled_float16_checkpoint_computes_in_float32():
    """demo/tiny_posenet.npz stores float16 leaves. JAX promotes f16 x f32
    to f32, so the JAX net computes in f32 with exactly those values; the
    port's layers cast to the compute type, so its f16 tree gives the bits
    of the same tree cast to f32 first, and the JAX package's cameras."""
    cfg = Config(width_mult=0.25, num_classes=128)
    donor = convert.load_npz(BUNDLED)["params"]
    assert {v.dtype for _, v in checkpoint.leaves(donor)} == {torch.float16}
    as32 = {p: v.float() for p, v in checkpoint.leaves(donor)}
    img = torch.from_numpy(synthetic.render_view(
        synthetic.sdf_torus, 30.0, 25.0, 0.85)[0][None, :, :, :3].copy())
    got = posenet.predict_trans_mat(donor, img, cfg, device="cpu")
    same = posenet.predict_trans_mat(checkpoint.unflatten(as32), img, cfg,
                                     device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, same)
    jdonor = jcheckpoint.restore_params(BUNDLED)["params"]
    want = jposenet.apply(jax.tree_util.tree_map(jnp.asarray, jdonor),
                          jnp.asarray(img.numpy()),
                          JConfig(width_mult=0.25, num_classes=128)
                          )["pred_trans_mat"]
    assert want.dtype == jnp.float32
    _close(got, want, what="pred_trans_mat")


def test_estimate_cameras_batches_in_order():
    """pipeline.estimate_cameras over 5 records at batch 2: the records in
    order, each with the camera one forward of its image alone predicts
    (other batch sizes sum in other orders: 1e-5 of the scale) and every
    other field the record's own."""
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.infer import pipeline
    _, cfg, jparams, _ = _ref(False)
    params = _port(jparams)
    rng = np.random.RandomState(6)
    recs = [(("c", f"o{i}", i), codecs.ViewRecord(
        img_arr=rng.randint(0, 256, (137, 137, 4), dtype=np.uint8),
        trans_mat=np.zeros((4, 3), np.float32),
        K=np.eye(3, dtype=np.float32), RT=np.ones((3, 4), np.float32),
        obj_rot_mat=np.eye(3, dtype=np.float32),
        regress_mat=np.full((4, 3), 2.0, np.float32))) for i in range(5)]
    out = list(pipeline.estimate_cameras(params, iter(recs), cfg, batch=2,
                                         device="cpu"))
    assert [k for k, _ in out] == [k for k, _ in recs]
    for (_, got), (_, rec) in zip(out, recs):
        want = posenet.predict_trans_mat(
            params, torch.from_numpy(rec.img_arr[None, :, :, :3]), cfg,
            device="cpu")[0].numpy()
        _close(got.trans_mat, want, rtol=1e-5)
        assert got.img_arr is rec.img_arr and got.RT is rec.RT
        assert got.regress_mat is rec.regress_mat
