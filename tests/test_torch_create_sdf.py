"""The port's reconstruction farm and its CLIs (`create-sdf`, `evaluate`,
`evaluate-acc`) against the JAX package's, with device='cpu', on a
synthetic dataset tree and the bundled tiny checkpoint
(demo/tiny_synth.npz: width 0.25, 128 classes) at sdf_res 32 (16 where the
path's control flow is the point)."""
import json
import os

import numpy as np
import pytest

import jax

from disn_tpu import cli as jcli
from disn_tpu.config import Config as JConfig
from disn_tpu.core import codecs as jcodecs
from disn_tpu.data import listing as jlisting
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu_torch import cli, convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import listing, synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.ops import marching
from torch_threads import few_threads  # noqa: F401  (autouse)

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "demo",
                    "tiny_synth.npz")
KW = dict(num_classes=128, width_mult=0.25, sdf_res=32, view_num=2)
SET = [x for k, v in KW.items() for x in ("--set", f"{k}={v}")]
CAT = synthetic.SYNTH_CAT


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def _objs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".obj"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The dataset tree (2 views of 3 shapes) and GT meshes extracted from
    its analytic grids."""
    root = str(tmp_path_factory.mktemp("create_sdf"))
    data = os.path.join(root, "data")
    synthetic.build_dataset(data, views=2, num_samples=1024, grid_res=16)
    gt = os.path.join(root, "gt")
    for obj in synthetic.SHAPES:
        df = jcodecs.read_dist(os.path.join(data, "sdf_grids", CAT, obj,
                                            "grid.dist"))
        import torch
        v, f = marching.extract_mesh(torch.from_numpy(
            np.ascontiguousarray(df.values, np.float32)), df.params)
        codecs.write_obj(os.path.join(gt, CAT, obj, "isosurf.obj"), v, f)
    return root, data, gt


def test_reconstruct_split_matches_jax(data):
    """The same files; each mesh the reference's as vertex and triangle
    sets: the JAX farm ships u16 fixed-point vertices (step 3.05e-5 over
    the box), hence atol 2e-5, and writes its record route's vertex order,
    the port its owned route's."""
    root, data_dir, _ = data
    listinfo, _ = listing.load_split(os.path.join(data_dir, "filelists"),
                                     {"s": CAT}, "test", view_num=1)
    jp = jcheckpoint.restore_params(CKPT)
    jw = jpipeline.reconstruct_split(
        jp.get("params", jp), JConfig(**KW),
        jlisting.SplitPaths(os.path.join(data_dir, "sdf"),
                            os.path.join(data_dir, "renders")),
        listinfo, os.path.join(root, "jax"))
    tp = convert.load_npz(CKPT)
    tw = pipeline.reconstruct_split(
        tp.get("params", tp), Config(**KW),
        listing.SplitPaths(os.path.join(data_dir, "sdf"),
                           os.path.join(data_dir, "renders")),
        listinfo, os.path.join(root, "port"), device="cpu")
    assert len(tw) == 3
    assert [os.path.relpath(p, os.path.join(root, "port")) for p in tw] == \
        [os.path.relpath(p, os.path.join(root, "jax")) for p in jw]
    assert tw[0].endswith(os.path.join("test_objs", "33_0.0", CAT,
                                       f"{CAT}_sphere0_00.obj"))
    for a, b in zip(tw, jw):
        (v, f), (jv, jf) = codecs.read_obj(a), codecs.read_obj(b)
        assert len(f) > 1000 and v.shape == jv.shape and f.shape == jf.shape
        for x, y in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-5)


def test_reconstruct_split_shards_and_readers(data, tmp_path):
    """Shard stripes cover the split once; readers from memory (the
    keyword arguments) give the files the h5 readers give."""
    _, data_dir, _ = data
    paths = listing.SplitPaths(os.path.join(data_dir, "sdf"),
                               os.path.join(data_dir, "renders"))
    listinfo, _ = listing.load_split(os.path.join(data_dir, "filelists"),
                                     {"s": CAT}, "test", view_num=2)
    tp = convert.load_npz(CKPT)
    params = tp.get("params", tp)
    cfg = Config(**dict(KW, sdf_res=16))
    views = {paths.img_path(c, o, v): codecs.read_view_h5(
        paths.img_path(c, o, v)) for c, o, v in listinfo}
    reads = []

    def read_sdf(path):
        reads.append(path)
        return codecs.read_sdf_params(path)

    shards = [pipeline.reconstruct_split(
        params, cfg, paths, listinfo, str(tmp_path / f"s{i}"),
        shard_index=i, shard_count=2, device="cpu", sparse=False,
        read_view=views.__getitem__, read_sdf_params=read_sdf)
        for i in range(2)]
    assert len(reads) == 6  # once per object and shard (views alternate)
    names = sorted(os.path.basename(p) for s in shards for p in s)
    assert names == sorted(f"{c}_{o}_{v:02d}.obj" for c, o, v in listinfo)
    for i, s in enumerate(shards):
        assert [os.path.basename(p) for p in s] == [
            f"{c}_{o}_{v:02d}.obj" for c, o, v in listinfo[i::2]]
    full = pipeline.reconstruct_split(params, cfg, paths, listinfo,
                                      str(tmp_path / "h5"), device="cpu",
                                      sparse=False)
    got = {os.path.basename(p): p for s in shards for p in s}
    for p in full:
        with open(p, "rb") as a, open(got[os.path.basename(p)], "rb") as b:
            assert a.read() == b.read()


def test_reconstruct_split_reader_error_reaches_the_caller(data, tmp_path):
    _, data_dir, _ = data
    paths = listing.SplitPaths(os.path.join(data_dir, "sdf"),
                               str(tmp_path / "no_renders"))
    with pytest.raises(OSError):
        pipeline.reconstruct_split({}, Config(**KW), paths,
                                   [(CAT, "sphere0", 0)], str(tmp_path),
                                   device="cpu")


def test_cli_create_sdf_then_evaluate_match_jax(data, capsys):
    """The port's create-sdf writes the tree; the port's evaluate and the
    JAX package's score it alike (f32 summation order)."""
    root, data_dir, gt = data
    run = os.path.join(root, "cli_run")
    cli.main(["create-sdf", "--device", "cpu", "--data-root", data_dir,
              "--log-dir", run, "--restore", CKPT] + SET)
    pred = os.path.join(run, "test_objs", "33_0.0")
    assert _objs(pred) == sorted(
        os.path.join(CAT, f"{CAT}_{o}_{v:02d}.obj")
        for o in synthetic.SHAPES for v in range(2))
    common = ["--data-root", data_dir, "--pred-dir", pred, "--gt-dir", gt,
              "--view-num", "2", "--num-points", "256", "--dim", "32"]
    capsys.readouterr()
    cli.main(["evaluate", "--device", "cpu", "--out",
              os.path.join(root, "port.json")] + common)
    printed = json.loads(capsys.readouterr().out)
    jcli.main(["evaluate", "--platform", "cpu", "--out",
               os.path.join(root, "jax.json")] + common)
    with open(os.path.join(root, "port.json")) as f:
        got = json.load(f)
    with open(os.path.join(root, "jax.json")) as f:
        want = json.load(f)
    assert printed == got and got["total_objects"] == 3
    for scope in ("overall", *want["categories"]):
        g = got["overall"] if scope == "overall" else got["categories"][scope]
        w = want["overall"] if scope == "overall" else \
            want["categories"][scope]
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert 0.0 < got["overall"]["iou_avg"] <= 1.0


def test_cli_evaluate_acc_matches_jax(data, monkeypatch):
    """SDF accuracy and losses over the test split: the port's eval step
    and loader against the JAX command's averages (f32 summation order).
    Both loaders draw a batch's points from the RandomState of the worker
    thread that happens to take it, so the commands' four workers are cut
    to one in both packages: the draws are then the same, in batch order."""
    from disn_tpu.data import pipeline as jpipe
    from disn_tpu_torch.data import pipeline as tpipe
    for mod in (jpipe, tpipe):
        def one_worker(*a, _make=mod.make_loader, **kw):
            return _make(*a, **dict(kw, workers=1))
        monkeypatch.setattr(mod, "make_loader", one_worker)
    root, data_dir, _ = data
    small = SET + ["--set", "batch_size=2", "--set", "num_sample_points=64"]
    cli.main(["evaluate-acc", "--device", "cpu", "--data-root", data_dir,
              "--log-dir", os.path.join(root, "acc_port"), "--restore",
              CKPT] + small)
    jcli.main(["evaluate-acc", "--platform", "cpu", "--data-root", data_dir,
               "--log-dir", os.path.join(root, "acc_jax"), "--restore",
               CKPT] + small)
    res = []
    for d in ("acc_port", "acc_jax"):
        with open(os.path.join(root, d, "log_acc.txt")) as f:
            res.append(json.loads(f.read()))
    got, want = res
    assert set(got) == set(want) and "accuracy" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_cli_create_sdf_multi_view_matches_jax(data):
    """create-sdf --multi-view through both CLIs on the same tree and
    checkpoint: one {cat}_{obj}_fused.obj per object (2 views fused) under
    test_objs/33_0.0_mv/, each the reference's mesh as vertex and triangle
    sets (both extract on their device from the fused volume; atol 2e-5 as
    above, f32 summation order moves a vertex by ~1e-6)."""
    root, data_dir, _ = data
    runs = {}
    for name, main, dev in (("port", cli.main, ["--device", "cpu"]),
                            ("jax", jcli.main, ["--platform", "cpu"])):
        runs[name] = os.path.join(root, f"mv_{name}")
        main(["create-sdf", "--multi-view", "--data-root", data_dir,
              "--log-dir", runs[name], "--restore", CKPT] + dev + SET)
    trees = {k: os.path.join(v, "test_objs", "33_0.0_mv")
             for k, v in runs.items()}
    names = [os.path.join(CAT, f"{CAT}_{o}_fused.obj")
             for o in sorted(synthetic.SHAPES)]
    assert _objs(trees["port"]) == _objs(trees["jax"]) == sorted(names)
    for name in names:
        v, f = codecs.read_obj(os.path.join(trees["port"], name))
        jv, jf = codecs.read_obj(os.path.join(trees["jax"], name))
        assert len(f) > 1000 and v.shape == jv.shape and f.shape == jf.shape
        for x, y in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-5)


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
