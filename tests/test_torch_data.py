"""disn_tpu_torch's data path against disn_tpu's on the CPU: the synthetic
dataset tree, the h5 codecs, the epoch sampler, batches (bit for bit for the
same RandomState), the prefetch loader, and `python -m disn_tpu_torch train`
end to end on the tree."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from disn_tpu.core import codecs as jcodecs
from disn_tpu.data import listing as jlisting
from disn_tpu.data import pipeline as jpipeline
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu_torch.core import camera, codecs
from disn_tpu_torch.data import listing, pipeline, synthetic
from torch_threads import few_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = dict(views=2, num_samples=1024, grid_res=8)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same seed through both packages' build_dataset."""
    root = tmp_path_factory.mktemp("synth")
    jinfo = jsynthetic.build_dataset(str(root / "jax"), **TREE)
    info = synthetic.build_dataset(str(root / "port"), **TREE)
    return jinfo, info


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_build_dataset_matches_jax(trees):
    """Every file of the tree, array for array: lists, SDF samples, renders
    and cameras, dense grids."""
    jinfo, info = trees
    files = _files(info["root"])
    assert files == _files(jinfo["root"]) and len(files) == 2 + 3 * (2 + 2)
    for f in files:
        a = os.path.join(info["root"], f)
        b = os.path.join(jinfo["root"], f)
        if f.endswith("ori_sample.h5"):
            x, y = codecs.read_sdf_h5(a), jcodecs.read_sdf_h5(b)
            names = ("ori_pt", "sample_pt", "sample_sdf", "norm_params",
                     "sdf_params")
        elif f.endswith(".h5"):
            x, y = codecs.read_view_h5(a), jcodecs.read_view_h5(b)
            names = ("img_arr", "trans_mat", "K", "RT", "obj_rot_mat",
                     "regress_mat")
        else:  # filelists and .dist grids
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
            continue
        for n in names:
            np.testing.assert_array_equal(getattr(x, n), getattr(y, n),
                                          err_msg=f"{f}:{n}")
    assert info["cats"] == jinfo["cats"] and info["views"] == jinfo["views"]


def test_codecs_and_rotation_match_jax(tmp_path):
    """A view record written by one package reads the same in the other;
    obj_rot_matrix is the JAX one."""
    from disn_tpu.core import camera as jcamera

    _, rec = synthetic.render_view(synthetic.sdf_torus, 40.0, 25.0, 0.85,
                                   img_h=32, img_w=32)
    path = str(tmp_path / "v.h5")
    codecs.write_view_h5(path, rec)
    back = jcodecs.read_view_h5(path)
    for n in ("img_arr", "trans_mat", "K", "RT", "obj_rot_mat",
              "regress_mat"):
        np.testing.assert_array_equal(getattr(back, n), getattr(rec, n))
    for angles in ((0.0, 0.0, 0.0), (123.0, -17.5, 9.0)):
        np.testing.assert_array_equal(camera.obj_rot_matrix(*angles),
                                      jcamera.obj_rot_matrix(*angles))


def _split(info, split="train"):
    return listing.load_split(info["lst_dir"], info["cats"], split,
                              view_num=info["views"])


def test_listing_matches_jax(trees):
    jinfo, info = trees
    for split in ("train", "test"):
        assert _split(info, split) == jlisting.load_split(
            jinfo["lst_dir"], jinfo["cats"], split, view_num=2)
    li, _ = _split(info)
    assert listing.cat_counts(li) == jlisting.cat_counts(li)
    # the bundled ShapeNet lists are the JAX package's
    cats = {"chair": "03001627", "car": "02958343"}
    assert listing.load_split("", cats, "test", view_num=1) == \
        jlisting.load_split("", cats, "test", view_num=1)


@pytest.mark.parametrize("cat_limit", [4, 64])
def test_epoch_sampler_matches_jax(trees, cat_limit):
    _, info = trees
    li, limit = _split(info)
    s = pipeline.EpochSampler(li, limit, cat_limit=cat_limit, seed=5)
    js = jpipeline.EpochSampler(li, limit, cat_limit=cat_limit, seed=5)
    assert s.epoch_amount == js.epoch_amount
    for _ in range(3):
        np.testing.assert_array_equal(s.epoch_order(), js.epoch_order())


def _datasets(info, **kw):
    cfg_kw = {"num_sample_points": 64, **kw}
    cfg = synthetic.tiny_config(**cfg_kw)
    jcfg = jsynthetic.tiny_config(**cfg_kw)
    li, _ = _split(info)
    paths = listing.SplitPaths(info["sdf_dir"], info["rendered_dir"])
    jpaths = jlisting.SplitPaths(info["sdf_dir"], info["rendered_dir"])
    return (pipeline.SdfImageDataset(cfg, paths, li, seed=0),
            jpipeline.SdfImageDataset(jcfg, jpaths, li, seed=0))


@pytest.mark.parametrize("kw", [{}, {"rot": True},
                                {"augcolorfore": True, "augcolorback": True},
                                {"backcolorwhite": True},
                                {"cam_shift": True, "num_sample_points": 2048}],
                         ids=["plain", "rot", "augcolor", "white", "shift"])
def test_get_batch_matches_jax(trees, kw):
    """The same RandomState gives bit-identical batches: the augmentation,
    the surface point and the sample choice are drawn in the JAX order
    (2048 > 1024 samples draws with replacement)."""
    _, info = trees
    ds, jds = _datasets(info, **kw)
    idx = np.array([0, 3, 5, 3])
    for seed in (0, 1):
        (b, ids), (jb, jids) = (d.get_batch(idx, np.random.RandomState(seed))
                                for d in (ds, jds))
        assert ids == jids and set(b) == set(jb)
        for k in jb:
            assert b[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    if kw.get("rot"):
        rec = codecs.read_view_h5(ds.paths.img_path(*ds.listinfo[0]))
        np.testing.assert_allclose(b["sdf_pt_rot"][0],
                                   b["sdf_pt"][0] @ rec.obj_rot_mat,
                                   atol=1e-6)


def test_loader_matches_jax_order_and_count(trees):
    """One worker each: the port's batches, as CPU tensors, are the JAX
    loader's, in order, over 2 epochs."""
    _, info = trees
    li, limit = _split(info)
    cfg = synthetic.tiny_config(num_sample_points=64)
    jcfg = jsynthetic.tiny_config(num_sample_points=64)
    paths = listing.SplitPaths(info["sdf_dir"], info["rendered_dir"])
    loader = pipeline.make_loader(cfg, paths, li, limit, epochs=2,
                                  workers=1, seed=3, device="cpu").start()
    jloader = jpipeline.make_loader(jcfg, jlisting.SplitPaths(paths.sdf_dir, paths.img_dir), li,
                                    limit, epochs=2, workers=1,
                                    seed=3).start()
    try:
        got, want = list(loader), list(jloader)
    finally:
        loader.shutdown()
        jloader.shutdown()
    assert len(got) == len(want) == len(loader) == 2 * (6 // 2)
    for b, jb in zip(got, want):
        assert set(b) == set(jb)
        for k in jb:
            assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert loader.wait_s >= 0.0
    assert not any(t.is_alive() for t in loader._threads)


def test_loader_needs_a_device_without_cuda(trees):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, info = trees
    li, limit = _split(info)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_loader(synthetic.tiny_config(),
                             listing.SplitPaths(info["sdf_dir"],
                                                info["rendered_dir"]),
                             li, limit)


def test_loader_error_propagation(trees):
    """A worker's exception reaches the consumer instead of hanging it."""
    _, info = trees
    li, _ = _split(info)
    bad = li + [(synthetic.SYNTH_CAT, "missing0", 0)] * 4
    loader = pipeline.make_loader(
        synthetic.tiny_config(), listing.SplitPaths(info["sdf_dir"],
                                                    info["rendered_dir"]),
        bad, {synthetic.SYNTH_CAT: len(bad)}, epochs=1, workers=2,
        shuffle=False, device="cpu").start()
    with pytest.raises(OSError):
        for _ in loader:
            pass
    loader.shutdown()
    assert not any(t.is_alive() for t in loader._threads)


def test_view_cache_not_mutated_by_augmentation(trees):
    _, info = trees
    ds, _ = _datasets(info, backcolorwhite=True, augcolorfore=True)
    a = ds.get_example(0, np.random.RandomState(0))["img"].copy()
    rec = ds._read_view(*ds.listinfo[0])
    raw = rec.img_arr.copy()
    b = ds.get_example(0, np.random.RandomState(0))["img"]
    np.testing.assert_array_equal(rec.img_arr, raw)
    np.testing.assert_array_equal(a, b)


def test_train_cli_end_to_end(trees, tmp_path):
    """`python -m disn_tpu_torch train --device cpu` on the tree for 2
    epochs writes latest.npz (params, optimizer state, step) and best.npz,
    which the JAX package reads."""
    _, info = trees
    log = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "disn_tpu_torch", "train", "--device",
           "cpu", "--data-root", info["root"], "--log-dir", log,
           "--epochs", "2", "--workers", "2", "--log-every", "1",
           "--set", "num_classes=32", "--set", "width_mult=0.125",
           "--set", "batch_size=2", "--set", "num_sample_points=64",
           "--set", "view_num=2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "epoch 2 done" in out.stdout
    latest = jcheckpoint.restore_params(os.path.join(log, "latest.npz"))
    best = jcheckpoint.restore_params(os.path.join(log, "best.npz"))
    assert int(latest["step"]) == 6
    assert set(latest) == {"params", "opt_state", "step"}
    assert set(latest["opt_state"]) == {"0", "1"}
    w = "vgg_16", "conv1", "conv1_1", "weights"
    np.testing.assert_array_equal(best["params"][w[0]][w[1]][w[2]][w[3]]
                                  .shape, (3, 3, 3, 8))
    assert jcheckpoint.load_metadata(os.path.join(log, "latest.npz")) == {
        "step": 6}
