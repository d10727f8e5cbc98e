"""The alternate encoders and RGBA input through the port's entry points
on the CPU: pipeline.image_to_mesh, `train` and `demo` with --set
encoder=alexnet|resnet and --set alpha=true, against disn_tpu's on the same
params (the analytic octahedron head over each encoder, so the mesh is
known) and the same synthetic dataset.

Tolerance: meshes as vertex and triangle sets within 2e-5 (the JAX path
ships u16 fixed-point vertices, a step of 3.05e-5 over the box; the port's
plain path interpolates in f32), with equal vertex and face counts."""
import os

import jax
import numpy as np
import pytest

from disn_tpu import cli as jcli
from disn_tpu.config import Config as JConfig
from disn_tpu.config import EncoderKind as JEncoderKind
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.models import disn as jdisn
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu_torch import cli, convert
from disn_tpu_torch.config import Config, EncoderKind
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.train import checkpoint
from torch_threads import few_threads  # noqa: F401  (autouse)

KW = dict(num_classes=32, width_mult=0.125, sdf_res=32, cell_cap_frac=0.9)
SET = [x for k, v in KW.items() for x in ("--set", f"{k}={v}")]
MESH_ATOL = 2e-5
CASES = [("alexnet", True), ("resnet", True), ("resnet", False)]


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def _same_mesh(got, want, what=""):
    (v, f), (jv, jf) = got, want
    assert len(f) > 1000 and v.shape == jv.shape and f.shape == jf.shape, \
        (what, v.shape, jv.shape)
    for x, y in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
        np.testing.assert_allclose(x, y, rtol=0, atol=MESH_ATOL,
                                   err_msg=what)


def _cfgs(encoder, alpha, **kw):
    kw = dict(KW, alpha=alpha, **kw)
    return (JConfig(encoder=JEncoderKind(encoder), **kw),
            Config(encoder=EncoderKind(encoder), **kw))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("encoders_cli"))
    synthetic.build_dataset(os.path.join(root, "data"), views=2,
                            num_samples=512, grid_res=16)
    return root


@pytest.mark.parametrize("encoder,alpha", CASES)
def test_image_to_mesh_matches_jax(encoder, alpha):
    """image_to_mesh (the sparse flow, K1's plain version in both passes)
    on a u8 image with cfg.img_channels channels, the octahedron head over
    the encoder: the JAX mesh."""
    jcfg, cfg = _cfgs(encoder, alpha)
    jp = jsynthetic.analytic_octahedron_params(jcfg, r=0.6)
    img = np.random.RandomState(3).randint(0, 256, (137, 137,
                                                    cfg.img_channels),
                                           np.uint8)
    trans = synthetic.demo_trans_mat()
    stats: dict = {}
    got = pipeline.image_to_mesh(convert.params_from_jax(
        jax.device_get(jp)), img, trans, cfg, device="cpu", stats=stats)
    assert not stats["dense_fallback"]
    _same_mesh(got, jpipeline.image_to_mesh(jp, img, trans, jcfg),
               f"{encoder} alpha={alpha}")


def _ckpt(data, encoder, alpha):
    """The JAX package's octahedron net over the encoder, saved by it."""
    jcfg, _ = _cfgs(encoder, alpha)
    path = os.path.join(data, f"{encoder}_{alpha}.npz")
    jcheckpoint.save(path, {"params": jax.device_get(
        jsynthetic.analytic_octahedron_params(jcfg, r=0.6))})
    return path


@pytest.mark.parametrize("encoder,alpha", CASES[:2])
def test_demo_matches_jax(data, tmp_path, encoder, alpha):
    """`demo` on a view h5 of the synthetic tree (RGBA u8) and on the same
    view as a PNG with a 4x3 text matrix: the JAX CLI's mesh."""
    from PIL import Image
    sets = SET + ["--set", f"encoder={encoder}", "--set", f"alpha={alpha}"]
    view = os.path.join(data, "data", "renders", synthetic.SYNTH_CAT,
                        sorted(synthetic.SHAPES)[0], "00.h5")
    rec = codecs.read_view_h5(view)
    png = str(tmp_path / "view.png")
    Image.fromarray(rec.img_arr, "RGBA").save(png)
    mat = str(tmp_path / "trans.txt")
    np.savetxt(mat, rec.trans_mat)
    ckpt = _ckpt(data, encoder, alpha)
    for inputs in (["--image", view], ["--image", png, "--trans-mat", mat]):
        args = inputs + ["--restore", ckpt] + sets
        jcli.main(["demo", "--platform", "cpu", "--out",
                   str(tmp_path / "jax.obj")] + args)
        cli.main(["demo", "--device", "cpu", "--out",
                  str(tmp_path / "port.obj")] + args)
        _same_mesh(codecs.read_obj(str(tmp_path / "port.obj")),
                   codecs.read_obj(str(tmp_path / "jax.obj")),
                   " ".join(inputs[:2]))


@pytest.mark.parametrize("encoder,alpha", CASES[:2])
def test_train_cli_takes_the_encoder(data, encoder, alpha):
    """`train --set encoder=... --set alpha=...` on the CPU: the run's
    latest.npz holds the encoder under its scope with the JAX init's
    shapes, and the JAX package restores it into that tree."""
    log = os.path.join(data, f"run_{encoder}_{alpha}")
    cli.main(["train", "--device", "cpu", "--data-root",
              os.path.join(data, "data"), "--log-dir", log, *SET,
              "--set", f"encoder={encoder}", "--set", f"alpha={alpha}",
              "--set", "batch_size=2", "--set", "num_sample_points=64",
              "--set", "view_num=2", "--epochs", "1", "--workers", "1",
              "--dump-every", "0", "--log-every", "1"])
    saved = Config.load(os.path.join(log, "config.json"))
    assert (saved.encoder, saved.alpha) == (EncoderKind(encoder), alpha)
    jcfg, _ = _cfgs(encoder, alpha)
    want = {k: tuple(v.shape) for k, v in checkpoint.leaves(
        jax.device_get(jdisn.init(jcfg, jax.random.PRNGKey(0))))}
    path = os.path.join(log, "latest.npz")
    got = {k: tuple(v.shape) for k, v in checkpoint.leaves(
        convert.load_npz(path)["params"])}
    assert got == want
    assert jdisn.ENCODER_SCOPE[jcfg.encoder] in convert.load_npz(
        path)["params"]
    restored = jcheckpoint.restore_params(path)["params"]
    assert {k: tuple(np.shape(v)) for k, v in
            checkpoint.leaves(restored)} == want
