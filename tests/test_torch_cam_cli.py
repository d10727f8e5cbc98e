"""The port's estimated-camera path against the JAX package's, through both
CLIs with --device cpu / --platform cpu: `train-cam --mode create` (the
renders_camest/ tree), `--mode test` (its log), `create-sdf --cam-est`
(the camest_ tree of meshes) and `demo` on a view h5, on a PNG with a
4x3 matrix and on a PNG with the estimated camera. The checkpoints are
the bundled float16 ones (demo/tiny_posenet.npz, demo/tiny_synth.npz:
width 0.25, 128 classes, RGB), the data a synthetic tree of 3 shapes x 2
views, the grid sdf_res 32."""
import os
import re

import numpy as np
import pytest

from disn_tpu import cli as jcli
from disn_tpu_torch import cli
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import synthetic
from torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(__file__))
CAM_CKPT = os.path.join(ROOT, "demo", "tiny_posenet.npz")
SDF_CKPT = os.path.join(ROOT, "demo", "tiny_synth.npz")
KW = dict(num_classes=128, width_mult=0.25, sdf_res=32, view_num=2,
          batch_size=2, num_sample_points=64)
SET = [x for k, v in KW.items() for x in ("--set", f"{k}={v}")]
CAT = synthetic.SYNTH_CAT
# the JAX farm and demo ship u16 fixed-point vertices (step 3.05e-5 over
# the box) and write their record route's vertex order, the port its own:
# meshes are compared as vertex and triangle sets
MESH_ATOL = 2e-5


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def _same_mesh(a, b, what=""):
    (v, f), (jv, jf) = codecs.read_obj(a), codecs.read_obj(b)
    assert len(f) > 1000 and v.shape == jv.shape and f.shape == jf.shape, \
        (what, v.shape, jv.shape)
    for x, y in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
        np.testing.assert_allclose(x, y, rtol=0, atol=MESH_ATOL,
                                   err_msg=what)


def _views(data):
    """{(obj, view): ViewRecord} of the estimated-camera tree."""
    return {(o, v): codecs.read_view_h5(os.path.join(
        data, "renders_camest", CAT, o, f"{v:02d}.h5"))
        for o in synthetic.SHAPES for v in range(2)}


@pytest.fixture(scope="module")
def camest(tmp_path_factory):
    """The dataset tree; `train-cam --mode create` of the JAX package, its
    records read back, then the port's over the same tree (it stays)."""
    root = str(tmp_path_factory.mktemp("cam_cli"))
    data = os.path.join(root, "data")
    synthetic.build_dataset(data, views=2, num_samples=1024, grid_res=16)
    args = ["train-cam", "--data-root", data, "--mode", "create",
            "--split", "test", "--restore", CAM_CKPT] + SET
    jcli.main(args + ["--platform", "cpu", "--log-dir",
                      os.path.join(root, "jax")])
    jviews = _views(data)
    cli.main(args + ["--device", "cpu", "--log-dir",
                     os.path.join(root, "port")])
    return root, data, jviews, _views(data)


def test_train_cam_create_matches_jax(camest):
    """Every view of the split rewritten with the JAX package's predicted
    trans_mat (f32 through the encoder in another summation order: 1e-4
    of the matrix's scale), everything else copied bit for bit."""
    _, data, jviews, views = camest
    assert set(views) == set(jviews) and len(views) == 6
    for key, rec in views.items():
        want = jviews[key]
        gt = codecs.read_view_h5(os.path.join(
            data, "renders", CAT, key[0], f"{key[1]:02d}.h5"))
        assert rec.trans_mat.shape == (4, 3)
        scale = float(np.abs(want.trans_mat).max())
        np.testing.assert_allclose(rec.trans_mat, want.trans_mat, rtol=0,
                                   atol=1e-4 * scale, err_msg=str(key))
        assert not np.allclose(rec.trans_mat, gt.trans_mat)
        for name in ("img_arr", "K", "RT", "obj_rot_mat", "regress_mat"):
            np.testing.assert_array_equal(getattr(rec, name),
                                          getattr(gt, name), err_msg=name)


def _log_numbers(path):
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("cam eval", "avg "))]
    return lines, [float(x) for ln in lines
                   for x in re.findall(r"-?\d+\.\d+", ln)]


def test_train_cam_test_mode_matches_jax(camest, monkeypatch):
    """--mode test logs the JAX command's lines and values: every loss
    averaged over the split's batches and the avg/max/min 2D and 3D point
    distances. Both loaders draw a batch's points from the RandomState of
    the worker thread that takes it, so both commands run one worker, and
    the draws are the same in batch order. f32 in another order: 1e-4
    relative (the values are printed with 6 decimals)."""
    from disn_tpu.data import pipeline as jpipe
    from disn_tpu_torch.data import pipeline as tpipe
    for mod in (jpipe, tpipe):
        def one_worker(*a, _make=mod.make_loader, **kw):
            return _make(*a, **dict(kw, workers=1))
        monkeypatch.setattr(mod, "make_loader", one_worker)
    root, data, _, _ = camest
    args = ["train-cam", "--data-root", data, "--mode", "test",
            "--split", "test", "--restore", CAM_CKPT] + SET
    jcli.main(args + ["--platform", "cpu", "--log-dir",
                      os.path.join(root, "jtest")])
    cli.main(args + ["--device", "cpu", "--log-dir",
                     os.path.join(root, "ptest")])
    got_lines, got = _log_numbers(os.path.join(root, "ptest", "log_cam.txt"))
    want_lines, want = _log_numbers(os.path.join(root, "jtest",
                                                 "log_cam.txt"))
    strip = [re.sub(r"-?\d+\.\d+", "#", ln) for ln in got_lines]
    assert strip == [re.sub(r"-?\d+\.\d+", "#", ln) for ln in want_lines]
    assert any("avg 3d dist" in ln for ln in got_lines)
    assert any("cam eval rot2d_dist" in ln for ln in got_lines)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-6)


def test_create_sdf_cam_est_matches_jax(camest):
    """create-sdf --cam-est on the estimated-camera tree: the JAX
    package's files under test_objs/camest_33_0.0/, and its meshes."""
    root, data, _, _ = camest
    args = ["create-sdf", "--data-root", data, "--restore", SDF_CKPT,
            "--cam-est"] + SET
    jcli.main(args + ["--platform", "cpu", "--log-dir",
                      os.path.join(root, "jsdf")])
    cli.main(args + ["--device", "cpu", "--log-dir",
                     os.path.join(root, "psdf")])
    names = sorted(f"{CAT}_{o}_{v:02d}.obj" for o in synthetic.SHAPES
                   for v in range(2))
    sub = os.path.join("test_objs", "camest_33_0.0", CAT)
    assert sorted(os.listdir(os.path.join(root, "psdf", sub))) == names
    assert sorted(os.listdir(os.path.join(root, "jsdf", sub))) == names
    for n in names:
        _same_mesh(os.path.join(root, "psdf", sub, n),
                   os.path.join(root, "jsdf", sub, n), n)


@pytest.mark.parametrize("inputs", [
    ["--image", "demo/torus.h5"],
    ["--image", "demo/chair.png", "--trans-mat", "demo/chair_trans_mat.txt"],
    ["--image", "demo/torus.png", "--cam-est"]],
    ids=["h5", "png_trans_mat", "png_cam_est"])
def test_demo_matches_jax(inputs, tmp_path, monkeypatch):
    """demo's mesh is the JAX package's, from a view h5 (its trans_mat), a
    PNG with a 4x3 text matrix, and a PNG whose camera the bundled camera
    net estimates (no --cam-restore: the bundled net at its own width)."""
    monkeypatch.chdir(ROOT)
    args = inputs + ["--restore", SDF_CKPT] + SET
    jcli.main(["demo", "--platform", "cpu", "--out",
               str(tmp_path / "jax.obj")] + args)
    cli.main(["demo", "--device", "cpu", "--out",
              str(tmp_path / "port.obj")] + args)
    _same_mesh(str(tmp_path / "port.obj"), str(tmp_path / "jax.obj"))
