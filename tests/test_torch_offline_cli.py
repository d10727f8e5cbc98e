"""The port's offline subcommands (preprocess-sdf, preprocess-img, clean,
convert-ckpt, synth) through disn_tpu_torch.cli.main against disn_tpu's
CLI on the same inputs, on the CPU (preprocess-sdf with --device cpu; the
other four use no device).

Equal means: every h5 array and every other file's bytes, except the
ground-truth OBJ of preprocess-sdf, whose faces are equal and vertices
within 1e-5 (the JAX extraction is jitted XLA, the port's PyTorch ops);
and the printed lines, with the two output roots swapped."""
import os

import numpy as np
import pytest
import torch

from disn_tpu import cli as jcli
from disn_tpu.core import codecs as jcodecs
from disn_tpu_torch import cli
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.ops import marching
from disn_tpu_torch.train import checkpoint
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


def _mesh(fn, R=33):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = fn(np.stack([xx, yy, zz], -1)).astype(np.float32)
    return marching.extract_mesh(torch.from_numpy(vol), BOX)


def _h5_arrays(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(a, b, obj_atol=None):
    """Every file of two trees equal (h5 by arrays, OBJ by faces and
    vertices within obj_atol when given, the rest by bytes)."""
    assert _files(a) == _files(b) and _files(a)
    for rel in _files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".h5"):
            xa, xb = _h5_arrays(pa), _h5_arrays(pb)
            assert set(xa) == set(xb), rel
            for k in xb:
                np.testing.assert_array_equal(xa[k], xb[k], err_msg=rel + k)
        elif rel.endswith(".obj") and obj_atol is not None:
            va, fa = codecs.read_obj(pa)
            vb, fb = jcodecs.read_obj(pb)
            np.testing.assert_array_equal(fa, fb, err_msg=rel)
            np.testing.assert_allclose(va, vb, atol=obj_atol, err_msg=rel)
        else:
            with open(pa, "rb") as fa_, open(pb, "rb") as fb_:
                assert fa_.read() == fb_.read(), rel


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    codecs.write_obj(str(d / "sph.obj"), *_mesh(synthetic.sdf_sphere))
    codecs.write_obj(str(d / "tor.obj"), *_mesh(synthetic.sdf_torus))
    codecs.write_obj(str(d / "box.obj"), *_mesh(synthetic.sdf_box))
    return d


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def test_preprocess_sdf_matches_jax(meshes, tmp_path, capsys):
    """Three meshes at res 32: the port's trees (--jobs 1) equal the JAX
    CLI's, and a second run skips every object, as the JAX CLI does."""
    args = ["preprocess-sdf", "--pattern", str(meshes / "*.obj"),
            "--cat-id", "02958343", "--res", "32", "--num-sample", "512"]
    jout = _run(jcli.main, args + ["--out-dir", str(tmp_path / "j")],
                capsys)
    tout = _run(cli.main, args + ["--out-dir", str(tmp_path / "t"),
                                  "--device", "cpu"], capsys)
    assert tout.replace(str(tmp_path / "t"), "ROOT") == \
        jout.replace(str(tmp_path / "j"), "ROOT")
    assert tout.count("'skipped': False") == 3
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"), obj_atol=1e-5)
    again = _run(cli.main, args + ["--out-dir", str(tmp_path / "t"),
                                   "--device", "cpu"], capsys)
    assert again.count("'skipped': True") == 3


def test_preprocess_sdf_jobs_equal(meshes, tmp_path, capsys):
    """--jobs 2 (distance fields in two threads, the rest in input order
    on the calling thread) writes and prints exactly what --jobs 1 does;
    --jobs 3 over an object already done skips it in its place."""
    args = ["preprocess-sdf", "--pattern", str(meshes / "*.obj"),
            "--res", "32", "--num-sample", "512", "--device", "cpu"]
    outs = {}
    for jobs in ("1", "2"):
        outs[jobs] = _run(cli.main, args + [
            "--jobs", jobs, "--out-dir", str(tmp_path / jobs)], capsys)
    assert outs["2"].replace(str(tmp_path / "2"), "ROOT") == \
        outs["1"].replace(str(tmp_path / "1"), "ROOT")
    _same_tree(str(tmp_path / "2"), str(tmp_path / "1"))
    os.remove(tmp_path / "2" / "sph" / "ori_sample.h5")
    out = _run(cli.main, args + ["--jobs", "3", "--out-dir",
                                 str(tmp_path / "2")], capsys)
    assert [("'skipped': True" in line) for line in out.splitlines()] == \
        [True, False, True]       # box, sph, tor in sorted order
    _same_tree(str(tmp_path / "2"), str(tmp_path / "1"))


def test_preprocess_img_matches_jax(tmp_path, capsys):
    """Two rendered PNG views and their metadata -> the same view h5s."""
    from PIL import Image
    png_dir = tmp_path / "renders"
    png_dir.mkdir()
    metas = [(30.0, 20.0, 0.0, 0.85), (120.0, 10.0, 0.0, 0.9)]
    for i, (az, el, _, d) in enumerate(metas):
        img8, _ = synthetic.render_view(synthetic.sdf_sphere, az, el, d)
        Image.fromarray(img8, "RGBA").save(str(png_dir / f"{i:02d}.png"))
    meta = tmp_path / "rendering_metadata.txt"
    meta.write_text("".join(f"{a} {e} {n} {d} 35\n" for a, e, n, d in metas))
    sdf_h5 = str(tmp_path / "ori_sample.h5")
    codecs.write_sdf_h5(sdf_h5, np.zeros((4, 4), np.float32),
                        norm_params=np.array([0.1, 0, -0.1, 1.2], np.float32),
                        sdf_params=BOX, ori_pt=np.zeros((4, 3), np.float32))
    outs = []
    for main, name in ((jcli.main, "j"), (cli.main, "t")):
        outs.append(_run(main, [
            "preprocess-img", "--pattern", str(png_dir / "*.png"),
            "--metadata", str(meta), "--sdf-h5", sdf_h5,
            "--out-dir", str(tmp_path / name)], capsys))
    assert outs[0] == outs[1] == "wrote 2 view h5s\n"
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))


@pytest.mark.parametrize("in_place", [False, True])
def test_clean_matches_jax(tmp_path, capsys, in_place):
    """Meshes with a stray part far off the centre -> the same files."""
    big = _mesh(lambda p: synthetic.sdf_sphere(p, r=0.6), R=25)
    small = _mesh(lambda p: synthetic.sdf_sphere(p, r=0.3), R=9)
    verts = np.concatenate([big[0], small[0] * 0.5 + np.float32([2, 0, 0])])
    faces = np.concatenate([big[1], small[1] + len(big[0])])
    for name in ("j", "t"):
        for obj in ("a", "b"):
            codecs.write_obj(str(tmp_path / name / f"{obj}.obj"), verts,
                             faces)
    flag = ["--in-place"] if in_place else []
    outs = [_run(main, ["clean", "--pattern", str(tmp_path / name / "*.obj"),
                        *flag], capsys).replace(str(tmp_path / name), "ROOT")
            for main, name in ((jcli.main, "j"), (cli.main, "t"))]
    assert outs[0] == outs[1] and outs[1].count("cleaned") == 2
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    v, _ = codecs.read_obj(str(tmp_path / "t" / (
        "a.obj" if in_place else "a_clean.obj")))
    assert len(v) == len(big[0])


def test_convert_ckpt_matches_jax(tmp_path, capsys):
    """A TF1 bundle written by TensorFlow -> the same npz leaves and the
    same message; the port's npz restores in disn_tpu."""
    tf = pytest.importorskip("tensorflow")
    import tensorflow.compat.v1 as tf1
    from disn_tpu.train import checkpoint as jcheckpoint
    rng = np.random.RandomState(0)
    tensors = {
        "alexnet/conv1/weights": rng.randn(11, 11, 4, 8).astype(np.float32),
        "sdfprediction/fold1/conv1/weights":
            rng.randn(1, 1, 3, 64).astype(np.float32),
        "sdfprediction/fold1/conv1/biases": rng.randn(64).astype(np.float32),
        "sdfprediction/fold1/conv1/weights/Adam":
            rng.randn(1, 1, 3, 64).astype(np.float32),
        "global_step": np.int64(7),
    }
    prefix = str(tmp_path / "model.ckpt")
    g = tf1.Graph()
    with g.as_default():
        tvars = {k: tf1.get_variable(k, initializer=v)
                 for k, v in tensors.items()}
        saver = tf1.train.Saver(var_list=tvars)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False,
                       write_state=False)
    assert tf is not None
    outs = [_run(main, ["convert-ckpt", "--tf-prefix", prefix, "--out",
                        str(tmp_path / f"{name}.npz")], capsys)
            .replace(str(tmp_path / f"{name}.npz"), "OUT")
            for main, name in ((jcli.main, "j"), (cli.main, "t"))]
    assert outs[0] == outs[1] and "converted 3 tensors" in outs[1]
    want = dict(checkpoint.leaves(jcheckpoint.restore_params(
        str(tmp_path / "j.npz"))))
    got = dict(checkpoint.leaves(jcheckpoint.restore_params(
        str(tmp_path / "t.npz"))))
    assert set(got) == set(want) and len(got) == 3
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_synth_matches_jax(tmp_path, capsys):
    """The synthetic dataset tree: every file equal, the same summary."""
    outs = [_run(main, ["synth", "--out-dir", str(tmp_path / name),
                        "--views", "2", "--num-samples", "256",
                        "--grid-res", "8"], capsys)
            .replace(str(tmp_path / name), "ROOT")
            for main, name in ((jcli.main, "j"), (cli.main, "t"))]
    assert outs[0] == outs[1] and '"views": 2' in outs[1]
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
