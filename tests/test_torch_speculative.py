"""The speculative bucket dispatch of disn_tpu_torch's pipeline (the
prediction and its bucket helpers, the fixed-size cull, the capped
compaction, K5 with the count on the device, and image_to_mesh on every
route it can take) against disn_tpu's functions and against the port's
own synchronous flow (_SPEC_CACHE cleared), float32 on the CPU. K1 and K5
run as their plain versions; the words flow's configuration is
tests/test_torch_sparse_words.py's (analytic octahedron head, width
0.125, sdf_res 64)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.infer import sparse as jsparse
from disn_tpu.ops import marching as jmarching
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline, sparse
from disn_tpu_torch.ops import marching, sparse_words

SMALL64 = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
               sdf_res=64, cell_cap_frac=0.9)
TRANS = jsynthetic.demo_trans_mat()
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Torch's intra-op threads at THREADS, as in tests/test_torch_farm.py:
    beside the suite's other workers more threads slow these paths down."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each test starts with no prediction and no pinned (cfg, iso)."""
    monkeypatch.setattr(pipeline, "_SPEC_CACHE", {})
    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())


@functools.lru_cache(maxsize=None)
def _params(r):
    return synthetic.analytic_octahedron_params(Config(**SMALL64), r=r,
                                                device="cpu")


def _img(seed=1):
    return np.random.RandomState(seed).rand(137, 137, 3).astype(np.float32)


def _jsizes(cfg):
    return jsparse._sparse_parts(cfg, 4, pipeline.SPEC_BLOCK,
                                 cfg.cell_cap_frac, cfg.band_factor)[0]


# -- the prediction and its bucket helpers ---------------------------------

def _ratchet_steps():
    """tests/test_infer.py::test_spec_cache_hysteresis's sequence: up at
    once, a streak of smaller images, the shrink, and nv unknown."""
    steps = [(8, 4, 100), (16, 8, 200)]
    steps += [(8, 4, 100)] * pipeline._SHRINK_STREAK
    steps += [(8, 4, 100), (9, 3, 50), (8, 4, None), (20, 2, 7), (8, 4, 100)]
    return steps


@pytest.mark.parametrize("helper", ["_update_pred", "_exact_blocks",
                                    "_needed_blocks", "_fused_bcap",
                                    "_ebucket", "_qbucket", "records_n_iter",
                                    "sizes"])
def test_bucket_helpers_match_jax(helper, monkeypatch):
    """Each helper against the JAX package's on the same integers: the
    prediction after every step of the ratchet/streak sequence; the block
    helpers on the main path's sizes and the test configuration's over
    every cell count up to the cap; the buckets and records_n_iter over
    their ranges; the sizes of both configurations."""
    configs = [(Config(**SMALL64), JConfig(**SMALL64)),
               (Config(sdf_res=256), JConfig(sdf_res=256))]
    if helper == "_update_pred":
        jcache: dict = {}
        monkeypatch.setattr(jpipeline, "_SPEC_CACHE", jcache)
        for step in _ratchet_steps():
            pipeline._update_pred("k", *step)
            jpipeline._update_pred("k", *step)
            assert pipeline._SPEC_CACHE["k"] == jcache["k"]
        assert pipeline._SHRINK_STREAK == jpipeline._SHRINK_STREAK == 12
        return
    if helper == "sizes":
        for cfg, jcfg in configs:
            js = _jsizes(jcfg)
            got = pipeline._spec_sizes(cfg)
            assert got == {k: js[k] for k in got}
            assert got["cell_cap"] == sparse.cell_cap(cfg)
        return
    if helper in ("_ebucket", "_qbucket"):
        for n in range(0, 5000):
            assert getattr(marching, helper)(n) == getattr(jmarching,
                                                           helper)(n)
        return
    if helper == "records_n_iter":
        for ids_len in (16384, 32768, 638976, 3 * 4096, 1000):
            for n in range(0, 3 * ids_len, max(1, ids_len // 97)):
                for batch in (4096, 8192):
                    assert (marching.records_n_iter(ids_len, n, batch)
                            == jmarching.records_n_iter(ids_len, n, batch))
        return
    for cfg, jcfg in configs:
        sizes, js = pipeline._spec_sizes(cfg), _jsizes(jcfg)
        if helper == "_fused_bcap":
            for nb in range(1, sizes["max_blocks"] + 1):
                assert (pipeline._fused_bcap(nb, sizes)
                        == jpipeline._fused_bcap(nb, js))
            continue
        for c in range(0, sizes["cell_cap"] + 1, 7):
            assert (getattr(pipeline, helper)(c, sizes)
                    == getattr(jpipeline, helper)(c, js))


# -- the fixed-size cull, the capped compaction, K5's count ---------------

@pytest.mark.parametrize("mode,max_cells", [("band", 4096), ("band", 100),
                                            ("sign", 4096)])
def test_fixed_active_cells_match_jax(mode, max_cells):
    """_active_cells(max_cells=) against disn_tpu's on one seeded coarse
    grid: the ids with their padding and the count, bit for bit, also
    where the cap drops ids; the exact form is its first count ids."""
    rng = np.random.RandomState(3)
    vol_c = (0.3 * rng.randn(17, 17, 17)).astype(np.float32)
    tau = np.float32(0.2)
    ids, count = sparse._active_cells(torch.from_numpy(vol_c),
                                      torch.tensor(tau), mode, max_cells)
    jids, jcount = jsparse._active_cells(jnp.asarray(vol_c),
                                         jnp.asarray(tau), max_cells, mode)
    assert ids.dtype == torch.int32 and count.dtype == torch.int32
    assert count.dim() == 0 and int(count) == int(jcount) > 100
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    exact, n = sparse._active_cells(torch.from_numpy(vol_c),
                                    torch.tensor(tau), mode)
    assert n == int(count)
    k = min(n, max_cells)
    np.testing.assert_array_equal(exact.numpy()[:k], ids.numpy()[:k])


def _words_inputs(R=65, nk=300, count=300, seed=5):
    """tests/test_torch_sparse_words.py's seeded K5 inputs."""
    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(c ** 3, nk, replace=False)).astype(np.int32)
    ids[count:] = 0
    rows = (0.3 * rng.randn(nk * 64)).astype(np.float32)
    rows[rng.rand(nk * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    return (torch.from_numpy(rows), torch.from_numpy(ids), count,
            torch.from_numpy(vol_c))


@pytest.mark.parametrize("sparse_ids", [False, True])
@pytest.mark.parametrize("bcap", [4096, 1024])
def test_capped_compaction_matches_jax(sparse_ids, bcap):
    """_compact_block_bits at a fixed bcap against disn_tpu's: ids, n,
    g_over and the block rows bit for bit, with and without the own-slot
    table; at bcap 4096 nothing overflows and the result is the uncapped
    compaction's, at 1024 (512 rows for the 567 blocks with a change)
    g_over counts the blocks past the rows."""
    R = 65
    rows, ids, count, vol_c = _words_inputs()
    _, bits, cand, own, _ = marching._sparse_cell_words(rows, ids, count,
                                                        vol_c, R, 0.0)
    srow = own if sparse_ids else None
    guard = torch.tensor(3, dtype=torch.int32)
    got, n, g_over, blk = marching._compact_block_bits(
        bits, cand, R, srow_tbl=srow, bcap=bcap, guard=guard)
    b3 = (R - 1) // 4 + 1
    want, jn, jg, jblk = jmarching._compact_block_bits(
        jnp.asarray(bits.numpy()), jnp.asarray(cand.numpy()), bcap=bcap,
        E=R, S=4, B3=b3, guard=jnp.int32(3),
        srow_tbl=None if srow is None else jnp.asarray(own.numpy()))
    assert int(n) == int(jn) > 1000 and int(g_over) == int(jg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    full_ids, full_n, full_blk = marching._compact_block_bits(
        bits, cand, R, srow_tbl=srow)
    b_count = len(full_blk)
    assert int(g_over) == 3 + max(0, b_count - marching._b2cap(bcap))
    if int(g_over) == 3:
        assert int(n) == full_n
        np.testing.assert_array_equal(got.numpy()[:full_n], full_ids.numpy())
        np.testing.assert_array_equal(blk.numpy()[:b_count],
                                      full_blk.numpy())
        assert not blk.numpy()[b_count:].any()


@pytest.mark.parametrize("count", [300, 251, 0, 400])
def test_plain_k5_takes_a_count_tensor(count):
    """The plain K5 with the count as a 0-d int32 tensor equals it with the
    int (clamped to the cells given: 400 of 300 is all of them), on full,
    padded and empty counts, every output bit for bit."""
    rows, ids, _, vol_c = _words_inputs(count=min(count, 300))
    t = torch.tensor(count, dtype=torch.int32)
    got = sparse_words.sparse_cell_words(rows, ids, t, vol_c, R=65, iso=0.0)
    want = sparse_words.sparse_cell_words(rows, ids, min(count, 300), vol_c,
                                          R=65, iso=0.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError, match="0-d int32"):
        sparse_words.sparse_cell_words(rows, ids, t.long(), vol_c, R=65,
                                       iso=0.0)


# -- image_to_mesh on every route ------------------------------------------

@functools.lru_cache(maxsize=None)
def _seed_run(r, kw_items=()):
    """The synchronous flow (no prediction) on _img() with the head of
    radius r: (mesh, stats, the prediction it seeded)."""
    cfg = Config(**dict(SMALL64, **dict(kw_items)))
    saved, pinned = pipeline._SPEC_CACHE, pipeline._SWORDS_SKIP
    pipeline._SPEC_CACHE, pipeline._SWORDS_SKIP = {}, set()
    try:
        stats: dict = {}
        mesh = pipeline.image_to_mesh(_params(r), _img(), TRANS, cfg,
                                      device="cpu", stats=stats)
        return mesh, stats, dict(pipeline._SPEC_CACHE)
    finally:
        pipeline._SPEC_CACHE, pipeline._SWORDS_SKIP = saved, pinned


ROUTES = {  # kind: (radius, config changes, route of the mesh)
    "hit": (0.25, (), "records_sparse"),
    "records": (0.25, (), "records_sparse"),
    "blocks": (0.25, (), "records_sparse"),
    "overflow": (0.25, (), "records_sparse"),
    "guard": (0.25, (("sdf_res", 48),), "owned_ids"),
    "cap": (0.25, (("sdf_res", 48), ("cell_cap_frac", 0.05)), "tets"),
}


@pytest.mark.parametrize("kind", list(ROUTES))
def test_speculative_route_equals_the_seed_path(kind, monkeypatch):
    """image_to_mesh with a prediction in _SPEC_CACHE ends in `kind` and
    gives the synchronous flow's verts and faces bit for bit and the same
    stats keys: the seed's own prediction (hit); a record bucket of 1
    batch of 256 slots, under the 680 cells with a change (records: the
    batch is cut from 4096 so that this grid's cells overflow it); a block
    bucket of 1, under the 2 the 672 active cells need (blocks); a compaction of 16 rows under the blocks with a change
    (overflow: gov 0 but for the overflow, the exact words flow again);
    sdf_res 48, where the band's active cells reach the + boundary (guard:
    the volume flow, (cfg, iso) pinned); there, a cell cap of 256 under the
    648 active cells (cap: the dense route). _SPEC_CACHE afterwards is what the JAX
    package's _update_pred gives for the counts of the run, and the counts
    are the image's: its block bucket and, where the records covered it,
    its record bucket and vertex count."""
    r, changes, route = ROUTES[kind]
    cfg = Config(**dict(SMALL64, **dict(changes)))
    key = (cfg, 0.0)
    (want_v, want_f), want_stats, _ = _seed_run(r, changes)
    sizes, jsizes = pipeline._spec_sizes(cfg), _jsizes(JConfig(
        **dict(SMALL64, **dict(changes))))
    nb, ni = _seed_run(0.25)[2][(Config(**SMALL64), 0.0)][:2]
    pred = {"hit": (nb, ni, None, 0, None),
            "records": (nb, 1, None, 0, None),
            "blocks": (1, ni, None, 0, None),
            "overflow": (nb, ni, None, 0, None),
            "guard": (sizes["max_blocks"], ni, None, 0, None),
            "cap": (sizes["max_blocks"], 1, None, 0, None)}[kind]
    assert kind != "blocks" or nb == 2
    pipeline._SPEC_CACHE[key] = pred
    if kind == "overflow":
        monkeypatch.setattr(marching, "_b2cap", lambda bcap: 16)
    if kind == "records":
        monkeypatch.setattr(pipeline, "SPEC_BATCH", 256)
    calls = []
    real = pipeline._update_pred
    monkeypatch.setattr(pipeline, "_update_pred",
                        lambda *a: (calls.append(a[1:]), real(*a))[1])
    stats: dict = {}
    v, f = pipeline.image_to_mesh(_params(r), _img(), TRANS, cfg,
                                  device="cpu", stats=stats)
    assert stats["spec"] == kind and want_stats["spec"] == "seed"
    assert stats["route"] == want_stats["route"] == route
    assert set(stats) == set(want_stats)
    assert len(f) > 1000
    np.testing.assert_array_equal(f, want_f)
    np.testing.assert_array_equal(v, want_v)
    assert (key in pipeline._SWORDS_SKIP) == (kind == "guard")
    # the JAX _update_pred on the same counts from the same prediction
    jcache = {key: pred}
    monkeypatch.setattr(jpipeline, "_SPEC_CACHE", jcache)
    for args in calls:
        jpipeline._update_pred(key, *args)
    assert pipeline._SPEC_CACHE[key] == jcache[key]
    c = want_stats["active_cells"]
    assert len(calls) == {"cap": 0, "blocks": 2}.get(kind, 1)
    assert all(a[0] == jpipeline._needed_blocks(c, jsizes) for a in calls)
    if kind in ("hit", "records", "blocks"):
        nc = want_stats["fine_cells"]
        bcap = jpipeline._fused_bcap(2, jsizes)
        ids_len = max(512, -(-(bcap // 2) // 256) * 256) * 64
        assert calls[-1][1] == jmarching.records_n_iter(
            ids_len, nc, pipeline.SPEC_BATCH)[0]
        assert calls[-1][2] == (len(want_v) if kind == "hit" else None)


def test_hit_matches_jax_image_to_mesh():
    """A hit against disn_tpu's image_to_mesh on the same params (its
    _sparse_fused_mesh, K1 interpreted; its second image, a hit too): the
    faces in order and the vertices within
    tests/test_torch_pipeline.py::test_image_to_mesh_matches_jax's 2e-5
    (the JAX record route ships u16 vertices)."""
    jp = jsynthetic.analytic_octahedron_params(JConfig(**SMALL64), r=0.25)
    p = convert.params_from_jax(jax.device_get(jp))
    cfg, jcfg = Config(**SMALL64), JConfig(**SMALL64)
    jpipeline._SWORDS_SKIP.clear()
    jpipeline._SPEC_CACHE.clear()
    for _ in range(2):
        jv, jf = jpipeline.image_to_mesh(jp, _img(), TRANS, jcfg)
    kinds = []
    for _ in range(2):
        stats: dict = {}
        v, f = pipeline.image_to_mesh(p, _img(), TRANS, cfg, device="cpu",
                                      stats=stats)
        kinds.append(stats["spec"])
    assert kinds == ["seed", "hit"] and stats["route"] == "records_sparse"
    assert len(f) > 1000 and len(v) == len(jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2e-5, rtol=0)
    assert pipeline._SPEC_CACHE[(cfg, 0.0)][:4] == \
        jpipeline._SPEC_CACHE[(jcfg, 0.0, pipeline.SPEC_BLOCK)][:4]
