"""The farm's deferred, depth-deep pipeline of disn_tpu_torch (the
deferred extractors, pipeline._fused_dispatch / _fused_collect and
reconstruct_split's writers, prefetch and depth) against the immediate
calls and the JAX package's reconstruct_split, with device='cpu'. The JAX
farm runs on the bundled tiny checkpoint (demo/tiny_synth.npz: width 0.25,
128 classes) at sdf_res 16; the sparse-words flow, whose host assembly is
the part the pool takes over, on the analytic octahedron head at width
0.125 and sdf_res 64 (48 where its guard must trip)."""
import os
import threading

import numpy as np
import pytest
import torch

import jax

from disn_tpu.config import Config as JConfig
from disn_tpu.data import listing as jlisting
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu_torch import convert, native
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import listing, synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.ops import marching

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "demo",
                    "tiny_synth.npz")
KW = dict(num_classes=128, width_mult=0.25, sdf_res=16, view_num=1)
CAT = synthetic.SYNTH_CAT
# the words flow's configuration of tests/test_torch_sparse_words.py: at
# r = 0.15 every active cell stays off the + boundary at sdf_res 64 (the
# guard trips at 48)
SMALL64 = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
               sdf_res=64, cell_cap_frac=0.9)
BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
WORDS_VIEWS = 2
PASSES = ("derive_recs", "mesh_faces_blocks", "mesh_verts_blocks",
          "mesh_assemble")
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Torch's intra-op threads at THREADS for this module: beside the
    suite's other workers, 8 threads each oversubscribe the cores, and
    the many small ops of these paths then slow down tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_pins(monkeypatch):
    """Each test starts with no (cfg, iso) pinned to the volume flow."""
    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A dataset tree of 3 shapes x 1 view, the JAX farm's tree of it (its
    default depth 2) and the port's, written image by image on the calling
    thread (image_to_mesh + write_obj)."""
    root = str(tmp_path_factory.mktemp("farm"))
    data = os.path.join(root, "data")
    synthetic.build_dataset(data, views=1, num_samples=1024, grid_res=16)
    listinfo, _ = listing.load_split(os.path.join(data, "filelists"),
                                     {"s": CAT}, "test", view_num=1)
    jp = jcheckpoint.restore_params(CKPT)
    jw = jpipeline.reconstruct_split(
        jp.get("params", jp), JConfig(**KW),
        jlisting.SplitPaths(os.path.join(data, "sdf"),
                            os.path.join(data, "renders")),
        listinfo, os.path.join(root, "jax"))
    tp = convert.load_npz(CKPT)
    params, cfg = tp.get("params", tp), Config(**KW)
    paths = listing.SplitPaths(os.path.join(data, "sdf"),
                               os.path.join(data, "renders"))
    ref = {}
    for c, o, v in listinfo:
        rec = codecs.read_view_h5(paths.img_path(c, o, v))
        mesh = pipeline.image_to_mesh(
            params, rec.img_arr[:, :, :3], rec.trans_mat, cfg,
            sdf_params=codecs.read_sdf_params(paths.sdf_path(c, o)),
            device="cpu")
        out = os.path.join(pipeline.result_dir(root, cfg), c,
                           f"{c}_{o}_{v:02d}.obj")
        codecs.write_obj(out, *mesh)
        ref[os.path.relpath(out, root)] = _read(out)
    return dict(root=root, listinfo=listinfo, jw=jw, params=params,
                cfg=cfg, paths=paths, ref=ref)


@pytest.mark.parametrize("writers", [1, 4])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_every_depth_and_pool_writes_one_tree(tiny, depth, writers,
                                              tmp_path):
    """The same bytes as image_to_mesh + write_obj on the calling thread,
    in the JAX farm's order, and each mesh the JAX farm's as vertex and
    triangle sets (its u16 vertices: test_reconstruct_split_matches_jax's
    2e-5)."""
    tw = pipeline.reconstruct_split(
        tiny["params"], tiny["cfg"], tiny["paths"], tiny["listinfo"],
        str(tmp_path), writers=writers, depth=depth, device="cpu")
    assert _rel(tw, str(tmp_path)) == _rel(tiny["jw"],
                                           os.path.join(tiny["root"], "jax"))
    assert {os.path.relpath(p, str(tmp_path)): _read(p)
            for p in tw} == tiny["ref"]
    for a, b in zip(tw, tiny["jw"]):
        (v, f), (jv, jf) = codecs.read_obj(a), codecs.read_obj(b)
        assert len(f) > 100 and v.shape == jv.shape and f.shape == jf.shape
        for x, y in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def words(tmp_path_factory):
    """One object's WORDS_VIEWS seeded u8 views (demo camera) in memory,
    the analytic head at SMALL64, and its tree written image by image on
    the calling thread; every image takes the words flow."""
    root = str(tmp_path_factory.mktemp("words"))
    cfg = Config(**SMALL64)
    params = synthetic.analytic_octahedron_params(cfg, r=0.15, device="cpu")
    paths = listing.SplitPaths(os.path.join(root, "sdf"),
                               os.path.join(root, "renders"))
    rng = np.random.RandomState(4)
    views = {paths.img_path(CAT, "obj0", v): codecs.ViewRecord(
        img_arr=rng.randint(0, 256, (137, 137, 4), dtype=np.uint8),
        trans_mat=synthetic.demo_trans_mat(), K=np.eye(3, dtype=np.float32),
        RT=np.zeros((3, 4), np.float32), obj_rot_mat=np.eye(3,
                                                            dtype=np.float32),
        regress_mat=np.zeros((4, 3), np.float32)) for v in range(WORDS_VIEWS)}
    sdf = {paths.sdf_path(CAT, "obj0"): BOX}
    listinfo = [(CAT, "obj0", v) for v in range(WORDS_VIEWS)]
    ref, meshes = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "_SWORDS_SKIP", set())
        for c, o, v in listinfo:
            stats = {}
            mesh = pipeline.image_to_mesh(
                params, views[paths.img_path(c, o, v)].img_arr[:, :, :3],
                synthetic.demo_trans_mat(), cfg, sdf_params=BOX,
                device="cpu", stats=stats)
            assert stats["route"] == "records_sparse" and len(mesh[1]) > 1000
            out = os.path.join(pipeline.result_dir(root, cfg), c,
                               f"{c}_{o}_{v:02d}.obj")
            codecs.write_obj(out, *mesh)
            ref[os.path.relpath(out, root)] = _read(out)
            meshes.append(mesh)
    return dict(cfg=cfg, params=params, paths=paths, listinfo=listinfo,
                kw=dict(read_view=views.__getitem__,
                        read_sdf_params=sdf.__getitem__),
                ref=ref, meshes=meshes,
                img=views[paths.img_path(CAT, "obj0", 0)].img_arr[:, :, :3])


def _spy_passes(monkeypatch) -> list:
    """Record the thread of every call of the C++ assembly passes."""
    calls = []
    for name in PASSES:
        fn = getattr(native, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, threading.get_ident()))
            return _fn(*a, **k)
        monkeypatch.setattr(native, name, spy)
    return calls


def test_the_pool_runs_the_host_assembly(words, tmp_path, monkeypatch):
    """On the words flow the C++ passes run on the writer pool only,
    never on the calling thread, and the tree is the calling thread's."""
    calls = _spy_passes(monkeypatch)
    tw = pipeline.reconstruct_split(
        words["params"], words["cfg"], words["paths"], words["listinfo"],
        str(tmp_path), device="cpu", **words["kw"])
    assert {os.path.relpath(p, str(tmp_path)): _read(p)
            for p in tw} == words["ref"]
    names = [n for n, _ in calls]
    assert names.count("mesh_faces_blocks") == WORDS_VIEWS
    assert all(t != threading.get_ident() for _, t in calls)


def test_a_failing_closure_fails_the_split(words, tmp_path, monkeypatch):
    """The second image's assembly raises on the pool: reconstruct_split
    raises it, its reader and pool threads are gone, the files of the
    other images are whole and that image's file was never written."""
    real = native.mesh_faces_blocks
    n = [0]

    def flaky(*a, **k):
        n[0] += 1
        if n[0] == 2:
            raise RuntimeError("injected assembly failure")
        return real(*a, **k)

    monkeypatch.setattr(native, "mesh_faces_blocks", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        pipeline.reconstruct_split(
            words["params"], words["cfg"], words["paths"],
            words["listinfo"], str(tmp_path), writers=1, depth=1,
            device="cpu", **words["kw"])
    assert not [t for t in threading.enumerate()
                if t.name.startswith("reconstruct_split")]
    got = {os.path.relpath(os.path.join(d, f), str(tmp_path)):
           _read(os.path.join(d, f))
           for d, _, fs in os.walk(str(tmp_path)) for f in fs}
    failed = sorted(words["ref"])[1]
    assert failed not in got and got
    assert all(words["ref"][k] == b for k, b in got.items())


def _deferred(params, img, cfg, stats):
    ctx = pipeline._fused_dispatch(params, img, synthetic.demo_trans_mat(),
                                   BOX, cfg, cfg.iso, device="cpu",
                                   stats=stats, join=False)
    return pipeline._fused_collect(ctx, defer=True)


@pytest.mark.parametrize("case", ["words", "volume", "guard", "zero cells"])
def test_collect_later_equals_image_to_mesh(words, case, monkeypatch):
    """_fused_collect's closure, run after the dispatch returned, gives
    image_to_mesh's mesh bit for bit, and the same route and stats keys:
    on the words flow, the volume flow, a words-flow guard trip (sdf_res
    48, which pins the config: each call starts unpinned) and an image
    with no sign-change cell."""
    img, cfg, params = words["img"], words["cfg"], words["params"]
    if case == "volume":
        cfg = cfg.replace(sparse_words=False)
    elif case == "guard":
        cfg = cfg.replace(sdf_res=48)
    elif case == "zero cells":
        params = synthetic.analytic_octahedron_params(cfg, r=-0.5,
                                                      device="cpu")
    if case == "words":
        want, want_stats = words["meshes"][0], None
    else:
        want_stats = {}
        want = pipeline.image_to_mesh(params, img, synthetic.demo_trans_mat(),
                                      cfg, sdf_params=BOX, device="cpu",
                                      stats=want_stats)
        monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())
    stats = {}
    fin = _deferred(params, img, cfg, stats)
    assert "extraction_ms" not in stats
    got = fin()
    assert stats["extraction_ms"] > 0
    route = {"words": "records_sparse", "volume": "owned_ids",
             "guard": "owned_ids", "zero cells": "records_sparse"}[case]
    assert stats["route"] == route
    if case == "guard":
        assert stats["swords_guard"] > 0
    if want_stats is not None:
        assert set(stats) == set(want_stats)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert (len(got[1]) == 0) == (case == "zero cells")


def _scan(R):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = torch.from_numpy(np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6)
    c = (R - 1) // 4
    ids_c = torch.arange(c ** 3, dtype=torch.int32)
    return vol, marching._active_cells_from_coarse(vol, ids_c, 0.0)


@pytest.mark.parametrize("join", [True, False])
def test_deferred_extractors_equal_the_immediate_ones(join, monkeypatch):
    """The record route's deferred forms (block rows and id list) equal
    extract_mesh_records and the numpy assembler, the owned route's equal
    extract_mesh_from_ids / extract_mesh_owned, bit for bit; the C++
    passes run only inside the closures; no cells give the empty mesh."""
    vol, (ids, n, guard, blk) = _scan(33)
    assert guard == 0 and n > 100
    calls = _spy_passes(monkeypatch)
    fins = {"blocks": marching.extract_mesh_records_deferred(
                vol, BOX, ids, n, blk=blk, device="cpu", join=join),
            "ids": marching.extract_mesh_records_deferred(
                vol, BOX, ids, n, device="cpu", join=join),
            "owned_ids": marching.extract_mesh_from_ids_deferred(
                vol, BOX, ids, device="cpu"),
            "owned": marching.extract_mesh_owned_deferred(vol, BOX,
                                                          device="cpu")}
    assert not calls
    rec, tq = marching._records_to_host(*marching._extract_records(vol, ids,
                                                                   0.0))
    np_v, np_f = marching.assemble_mesh_np(ids.numpy(), rec, tq, n, 33, BOX)
    want = {"blocks": marching.extract_mesh_records(vol, BOX, ids, n,
                                                    blk=blk, device="cpu"),
            "ids": marching.extract_mesh_records(vol, BOX, ids, n,
                                                 device="cpu"),
            "owned_ids": marching.extract_mesh_from_ids(vol, BOX, ids,
                                                        device="cpu"),
            "owned": marching.extract_mesh_owned(vol, BOX, device="cpu")}
    for k, fin in fins.items():
        v, f = fin()
        np.testing.assert_array_equal(f, want[k][1])
        np.testing.assert_array_equal(v, want[k][0])
        np.testing.assert_array_equal(f, np_f)
        if k in ("blocks", "ids"):
            np.testing.assert_allclose(v, np_v, atol=2e-7, rtol=0)
    empty = marching.extract_mesh_records_deferred(
        vol, BOX, ids[:0], 0, device="cpu", join=join)()
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
