"""disn_tpu_torch's evaluation harness against disn_tpu's on the same
prediction trees (per-category and overall results, the weighted F-score
aggregate, the per-object cache), and the port's OBJ codecs against the
JAX package's bytes on both sides of the native thresholds."""
import json
import os

import numpy as np
import pytest

from disn_tpu.core import codecs as jcodecs
from disn_tpu.eval import runner as jrunner
from disn_tpu_torch import native
from disn_tpu_torch.core import codecs
from disn_tpu_torch.eval import runner


def _tet(center, scale=0.1):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    return v * scale + np.asarray(center, np.float32), f


def _make_tree(root, cats, views=1):
    """cats: {cat: [(obj, pred_offset), ...]}; each view's mesh translated
    by pred_offset (and a little more each view), written by the port."""
    lst_dir = os.path.join(root, "filelists")
    gt_dir = os.path.join(root, "gt")
    pred_dir = os.path.join(root, "pred")
    os.makedirs(lst_dir, exist_ok=True)
    for cat, objs in cats.items():
        with open(os.path.join(lst_dir, f"{cat}_test.lst"), "w") as f:
            f.write("\n".join(o for o, _ in objs))
        for obj, off in objs:
            codecs.write_obj(os.path.join(gt_dir, cat, obj, "isosurf.obj"),
                             *_tet((0, 0, 0)))
            for v in range(views):
                codecs.write_obj(os.path.join(
                    pred_dir, cat, f"{cat}_{obj}_{v:02d}.obj"),
                    *_tet((off + 0.01 * v, 0, 0)))
    return pred_dir, gt_dir, lst_dir


CATS = {"cata": [("o1", 0.0), ("o2", 0.05)], "catb": [("o3", 0.3)]}
# the same tree with offsets off the F-score thresholds (0.0125, 0.025,
# 0.05, ...): at a distance equal to a threshold the f32 rounding decides
# `d < th`, and the two packages round the distance differently
CATS_OFF = {"cata": [("o1", 0.0), ("o2", 0.045)], "catb": [("o3", 0.3)]}


def _close(got, want):
    """Equal keys; floats and float lists to f32 summation order, strings
    (the best view's path) equal."""
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _close(got[k], w)
        elif isinstance(w, str) or isinstance(w, int):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("which,views,protocol", [
    (["cd", "emd", "fscore", "iou"], 1, "vertices"),
    (["cd", "emd", "fscore", "iou"], 3, "surface"),
    (["fscore"], 2, "vertices")])
def test_evaluate_tree_matches_jax(tmp_path, which, views, protocol):
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), CATS_OFF, views)
    kw = dict(view_num=views, metrics=which, num_points=64, workers=2,
              protocol=protocol, dim=32)
    want = jrunner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    got = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, device="cpu", **kw)
    _close(got, want)


def test_device_iou_matches_jax_within_sampling(tmp_path):
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), CATS_OFF)
    kw = dict(view_num=1, metrics=["iou"], num_points=64, workers=1,
              dim=32, device_iou=True)
    want = jrunner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    got = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, device="cpu", **kw)
    np.testing.assert_allclose(got["overall"]["iou_avg"],
                               want["overall"]["iou_avg"], atol=0.05)


def test_overall_fscore_weighted_aggregate(tmp_path):
    """The reference's aggregate (test_f_score.py:176-181): count-weighted
    category precision and recall, then the harmonic mean."""
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), CATS)
    res = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, view_num=1,
                               metrics=["fscore"], num_points=64, workers=2,
                               device="cpu")
    assert res["total_objects"] == 3
    ca, cb = res["categories"]["cata"], res["categories"]["catb"]
    pre = (np.asarray(ca["f_precision"]) * 2
           + np.asarray(cb["f_precision"])) / 3
    rec = (np.asarray(ca["f_recall"]) * 2 + np.asarray(cb["f_recall"])) / 3
    f1 = 2 * pre * rec / np.maximum(pre + rec, 1e-9)
    np.testing.assert_allclose(res["overall"]["f_precision"], pre, rtol=1e-6)
    np.testing.assert_allclose(res["overall"]["f_recall"], rec, rtol=1e-6)
    np.testing.assert_allclose(res["overall"]["f1"], f1, rtol=1e-6)
    assert res["overall"]["f1"][0] < 1.0
    assert ca["f1"][-1] == pytest.approx(1.0)
    naive = (np.asarray(ca["f1"]) * 2 + np.asarray(cb["f1"])) / 3
    assert not np.allclose(res["overall"]["f1"], naive)


def test_cache_resume_skips_finished_objects(tmp_path, monkeypatch):
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), CATS)
    cache = str(tmp_path / "cache")
    calls = []
    real = runner._object_host

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(runner, "_object_host", counting)
    kw = dict(view_num=1, metrics=["cd", "fscore"], num_points=64,
              workers=1, cache_dir=cache, device="cpu")
    res1 = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    assert len(calls) == 3
    with open(os.path.join(cache, "cata", "o1.json")) as f:
        assert json.load(f)["key"] == runner._cache_key(
            64, {"cd", "fscore"}, 110, "vertices", 1)
    calls.clear()
    res2 = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    assert len(calls) == 0
    assert json.dumps(res1, sort_keys=True) == json.dumps(res2,
                                                          sort_keys=True)
    os.remove(os.path.join(cache, "catb", "o3.json"))
    calls.clear()
    res3 = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    assert len(calls) == 1
    assert json.dumps(res1["overall"], sort_keys=True) == \
        json.dumps(res3["overall"], sort_keys=True)
    calls.clear()
    runner.evaluate_tree(pred_dir, gt_dir, lst_dir, **dict(kw, num_points=32))
    assert len(calls) == 3


def test_cache_torn_file_recomputes(tmp_path):
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), CATS)
    cache = str(tmp_path / "cache")
    kw = dict(view_num=1, metrics=["cd"], num_points=64, workers=1,
              cache_dir=cache, device="cpu")
    res1 = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    with open(os.path.join(cache, "cata", "o1.json"), "w") as f:
        f.write("{not json")
    res2 = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    assert res1["overall"]["cd_avg"] == pytest.approx(
        res2["overall"]["cd_avg"])
    assert not os.path.exists(os.path.join(cache, "cata", "o1.json.tmp"))


def test_missing_views_and_empty_meshes(tmp_path):
    """An object without a GT mesh, or whose views are all missing or
    empty, drops out in both packages alike."""
    cats = {"cata": [("o1", 0.0), ("o2", 0.045), ("o3", 0.1)]}
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), cats, views=2)
    os.remove(os.path.join(gt_dir, "cata", "o2", "isosurf.obj"))
    os.remove(os.path.join(pred_dir, "cata", "cata_o3_00.obj"))
    codecs.write_obj(os.path.join(pred_dir, "cata", "cata_o3_01.obj"),
                     np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    os.remove(os.path.join(pred_dir, "cata", "cata_o1_01.obj"))
    kw = dict(view_num=2, num_points=32, workers=2, dim=32)
    want = jrunner.evaluate_tree(pred_dir, gt_dir, lst_dir, **kw)
    got = runner.evaluate_tree(pred_dir, gt_dir, lst_dir, device="cpu", **kw)
    assert got["total_objects"] == 1
    _close(got, want)


def test_evaluate_tree_needs_a_device_unless_asked(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    pred_dir, gt_dir, lst_dir = _make_tree(str(tmp_path), CATS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.evaluate_tree(pred_dir, gt_dir, lst_dir, view_num=1)


def _grid_mesh(nv, seed=0):
    rng = np.random.RandomState(seed)
    v = (rng.randn(nv, 3) * 100).astype(np.float32)
    v[:5] = [[0, 0, 0], [-0.0, 1e-7, -1e-7], [123456.7, -0.5, 0.5],
             [1e-3, -1e-6, 9.9999995], [-2.5e-7, 3.0, -4.0]]
    f = rng.randint(0, nv, (2 * nv, 3)).astype(np.int32)
    return v, f


@pytest.mark.parametrize("nv", [5, 4096, 4097, 20000])
@pytest.mark.parametrize("with_faces", [True, False])
def test_write_obj_bytes_equal_jax(tmp_path, nv, with_faces):
    """The Python formatter up to 4096 vertices, the C one above: both
    packages write the same bytes."""
    v, f = _grid_mesh(nv)
    f = f if with_faces else None
    codecs.write_obj(str(tmp_path / "port.obj"), v, f)
    jcodecs.write_obj(str(tmp_path / "jax.obj"), v, f)
    port = (tmp_path / "port.obj").read_bytes()
    assert port == (tmp_path / "jax.obj").read_bytes()
    # the C formatter and the Python one may round a last digit apart:
    # both files read back to the same values within that digit
    c_path = tmp_path / "c.obj"
    c_path.write_bytes(bytes(native.format_obj(v, f)))
    for a, b in zip(codecs.read_obj(str(c_path)),
                    codecs.read_obj(str(tmp_path / "port.obj"))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1.5e-6)


@pytest.mark.parametrize("nv", [5, 500, 20000])
def test_read_obj_equal_jax(tmp_path, nv):
    """Below 64 KB the Python parser, above it the C one; polygons fan-
    triangulated and v/vt/vn face tokens read by their vertex index."""
    v, f = _grid_mesh(nv, seed=1)
    path = tmp_path / "m.obj"
    codecs.write_obj(str(path), v, f)
    with open(path, "a") as fh:
        fh.write("vn 0 0 1\nvt 0.5 0.5\nf 1/1/1 2/1/1 3/1/1 4/1/1\n"
                 "# comment\no name\nf 2//1 3//1 4//1\n")
    got, want = codecs.read_obj(str(path)), jcodecs.read_obj(str(path))
    assert (os.path.getsize(path) > codecs.NATIVE_OBJ_BYTES) == (nv > 500)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[1]) == len(f) + 3
    np.testing.assert_array_equal(native.parse_obj(path.read_bytes())[1],
                                  got[1])


def test_obj_codecs_raise_when_the_build_fails(monkeypatch, tmp_path):
    """No quiet switch to the Python loops above the thresholds."""
    v, f = _grid_mesh(5000)
    native._eval_lib.cache_clear()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nowhere")
    monkeypatch.setenv("CXX", "false")
    big = tmp_path / "big.obj"
    big.write_bytes(b"v 0 0 0\n" * 20000)
    try:
        with pytest.raises(RuntimeError, match="objwriter.cpp"):
            codecs.write_obj(str(tmp_path / "x.obj"), v, f)
        with pytest.raises(RuntimeError, match="objreader.cpp"):
            codecs.read_obj(str(big))
    finally:
        native._eval_lib.cache_clear()
