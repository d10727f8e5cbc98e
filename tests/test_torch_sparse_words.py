"""The sparse-words flow (K5 and the record route over its words) and the
owned-edge volume_to_mesh of disn_tpu_torch against disn_tpu's, float32
on the CPU. K5 runs as its plain version here; tests/
test_torch_sparse_words_cuda.py holds the kernel against it on a card."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.ops import marching as jmarching
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import dense, pipeline, sparse
from disn_tpu_torch.ops import marching, sparse_words
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
# the JAX test_sparse_words_exact_twin's configuration: at sdf_res 64 the
# autocal band reaches r + ~0.56, so r = 0.25 keeps every active cell off
# the + boundary and the words flow runs; r = 0.6 touches it
SMALL64 = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
               sdf_res=64, cell_cap_frac=0.9)
TRANS = jsynthetic.demo_trans_mat()


@pytest.fixture(autouse=True)
def fresh_pins(monkeypatch):
    """Each test starts with no (cfg, iso) pinned to the volume flow."""
    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())


@functools.lru_cache(maxsize=None)
def _params(r):
    jp = jsynthetic.analytic_octahedron_params(JConfig(**SMALL64), r=r)
    return jp, convert.params_from_jax(jax.device_get(jp))


def _img(seed=0):
    return np.random.RandomState(seed).rand(137, 137, 3).astype(np.float32)


def _random_inputs(R, nk, count, seed):
    """Seeded K5 inputs: nk distinct random coarse cells (so that most
    "+1" neighbours are absent), rows and a coarse grid around the iso,
    with 5% of the rows exactly at it. Past `count` the ids are 0, as the
    JAX package pads them."""
    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(c ** 3, nk, replace=False)).astype(np.int32)
    ids[count:] = 0
    rows = (0.3 * rng.randn(nk * 64)).astype(np.float32)
    rows[rng.rand(nk * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    return rows, ids, count, vol_c


def _jax_words(rows, ids, count, vol_c, R, jit):
    fn = functools.partial(jmarching._sparse_cell_words, stride=4, R=R,
                           iso=0.0)
    args = (jnp.asarray(rows), jnp.asarray(ids), jnp.int32(count),
            jnp.asarray(vol_c))
    if jit:
        out = jax.jit(fn)(*args)
    else:
        with jax.disable_jit():
            out = fn(*args)
    words, bits, cand, own, guard = out
    return (np.stack([np.asarray(w) for w in words]), np.asarray(bits),
            np.asarray(cand), np.asarray(own), int(guard))


def _tq_fields(words, R):
    """[nw, n] int32 words -> ([n, 7] edge parameters, [n] inside masks)."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    if R - 1 >= 128:
        f = [(w[i] >> s) & 0xFF for i in (0, 1) for s in (0, 8, 16, 24)]
    else:
        f = [(w[i] >> s) & 0xFFFF for i in range(4) for s in (0, 16)]
    return np.stack(f[:7], -1), f[7]


# (R, nk, count): u16 and u8 grids, full and padded (count < nk)
K5_CASES = [(65, 300, 300), (65, 300, 251), (257, 2000, 2000),
            (257, 2000, 1637)]


@pytest.mark.parametrize("R,nk,count", K5_CASES)
def test_sparse_cell_words_matches_jax(R, nk, count):
    """The plain K5 against disn_tpu's _sparse_cell_words on the same
    inputs: words, bits, cand, own_tbl and guard equal bit for bit to the
    reference run op by op (jax.disable_jit). Jitted, XLA's CPU fusion
    rounds a few lanes' edge parameters apart: 4 and 8 of the 19,200 lanes
    at R = 65 (full, padded), 1 and 0 of the 128,000 at 257. There the
    inside masks are equal and the parameters within one quantisation
    step (held: at most 1 lane in 1,000); bits, cand, own_tbl and guard
    stay equal."""
    rows, ids, count, vol_c = _random_inputs(R, nk, count, seed=R + count)
    got = sparse_words.sparse_cell_words(
        torch.from_numpy(rows), torch.from_numpy(ids), count,
        torch.from_numpy(vol_c), R=R, iso=0.0)
    words, bits, cand, own, guard = (x.numpy() for x in got)
    assert words.shape == (2 if R - 1 >= 128 else 4, nk * 64)
    assert int(guard) > 0 and cand.sum() == count
    want = _jax_words(rows, ids, count, vol_c, R, jit=False)
    for a, b in zip((words, bits, cand, own, int(guard)), want):
        np.testing.assert_array_equal(a, b)
    jw, jbits, jcand, jown, jguard = _jax_words(rows, ids, count, vol_c, R,
                                                jit=True)
    for a, b in ((bits, jbits), (cand, jcand), (own, jown),
                 (int(guard), jguard)):
        np.testing.assert_array_equal(a, b)
    (tq, im), (jtq, jim) = _tq_fields(words, R), _tq_fields(jw, R)
    np.testing.assert_array_equal(im, jim)
    assert np.abs(tq - jtq).max() <= 1
    assert (tq != jtq).any(1).sum() <= nk * 64 // 1000


@pytest.mark.parametrize("sparse_ids", [False, True])
def test_compact_block_bits_matches_jax(sparse_ids):
    """The compaction both flows share, against the reference's, without
    and with the own-slot table: the same ids in the same order and the
    same block rows (the reference pads its rows with zero masks past the
    count; the port emits exactly the count)."""
    R = 65
    rows, ids, count, vol_c = _random_inputs(R, 300, 300, seed=5)
    _, bits, cand, own, _ = marching._sparse_cell_words(
        torch.from_numpy(rows), torch.from_numpy(ids), count,
        torch.from_numpy(vol_c), R, 0.0)
    srow = own if sparse_ids else None
    got, n, blk = marching._compact_block_bits(bits, cand, R, srow_tbl=srow)
    b3 = (R - 1) // 4 + 1
    want, jn, _, jblk = jmarching._compact_block_bits(
        jnp.asarray(bits.numpy()), jnp.asarray(cand.numpy()),
        bcap=2 * b3 ** 3, E=R, S=4, B3=b3, guard=jnp.int32(0),
        srow_tbl=None if srow is None else jnp.asarray(own.numpy()))
    jblk = np.asarray(jblk)
    assert n == int(jn) > 1000
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])
    np.testing.assert_array_equal(
        blk.numpy(), jblk[(jblk[:, 1] != 0) | (jblk[:, 2] != 0)])


def _phase_a(p, cfg, seed=0):
    img, trans, sdfp = dense.as_inputs(_img(seed), TRANS, BOX,
                                       torch.device("cpu"))
    _, eps, vol_c, cell_ids, count = sparse.phase_a(p, img, trans, sdfp, cfg)
    return eps, vol_c, cell_ids, trans, sdfp


def test_words_flow_is_the_volume_flows_exact_twin():
    """phase_b_mesh_sparse against phase_b_mesh on the same phase_a
    outputs: guard 0 in both, the same cell count and block rows, and the
    records gathered from the words equal _extract_records on the volume
    byte for byte on every slot (the JAX test_sparse_words_exact_twin)."""
    _, p = _params(0.25)
    cfg = Config(**SMALL64)
    eps, vol_c, cell_ids, trans, sdfp = _phase_a(p, cfg)
    stats = {}
    words, sids, n, guard, blk = sparse.phase_b_mesh_sparse(
        p, eps, vol_c, cell_ids, trans, sdfp, cfg, 0.0, stats)
    vol, ids, n_d, guard_d, blk_d = sparse.phase_b_mesh(
        p, eps, vol_c, cell_ids, trans, sdfp, cfg, 0.0)
    assert guard == 0 and guard_d == 0 and n == n_d > 100
    assert stats["phase_b_ms"] > 0 and stats["scan_ms"] > 0
    assert torch.equal(blk, blk_d)
    rec, tq = marching._records_from_words_sparse(words, sids, 65)
    rec_d, tq_d = marching._extract_records(vol, ids, 0.0)
    assert rec.dtype == rec_d.dtype and tq.dtype == tq_d.dtype
    assert torch.equal(rec, rec_d) and torch.equal(tq, tq_d)


def test_image_to_mesh_records_sparse_matches_jax():
    """image_to_mesh with sparse_words=True (the default) takes the words
    flow with guard 0, and gives the faces of disn_tpu's image_to_mesh,
    which takes the same flow (its Pallas kernel interpreted), in order,
    and its vertices within test_image_to_mesh_matches_jax's 2e-5; against
    the port's own volume flow the faces are equal too and the vertices
    within the u16 record step, cell / 131070."""
    jp, p = _params(0.25)
    cfg = Config(**SMALL64)
    img = _img(1)
    jpipeline._SWORDS_SKIP.clear()
    jv, jf = jpipeline.image_to_mesh(jp, img, TRANS, JConfig(**SMALL64))
    stats = {}
    v, f = pipeline.image_to_mesh(p, img, TRANS, cfg, device="cpu",
                                  stats=stats)
    assert stats["route"] == "records_sparse"
    assert stats["guard"] == 0 and stats["swords_guard"] == 0
    assert {"phase_b_ms", "scan_ms", "extract_ms", "fetch_ms",
            "assemble_ms", "extraction_ms"} <= set(stats)
    assert len(f) > 1000 and stats["fine_cells"] > 0
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2e-5, rtol=0)
    vv, vf = pipeline.image_to_mesh(p, img, TRANS,
                                    cfg.replace(sparse_words=False),
                                    device="cpu")
    np.testing.assert_array_equal(f, vf)
    np.testing.assert_allclose(v, vv, atol=2 / 64 / 131070 + 1e-7, rtol=0)
    assert not pipeline._SWORDS_SKIP


def test_guard_falls_back_to_the_volume_flow_and_pins_the_config():
    """r = 0.6 at sdf_res 64: active cells on the + boundary trip the words
    flow's guard. The image goes through the volume flow from the same
    coarse pass and returns the sparse_words=False mesh exactly; (cfg, iso)
    is pinned, so the next image takes the volume flow directly."""
    _, p = _params(0.6)
    cfg = Config(**SMALL64)
    want = pipeline.image_to_mesh(p, _img(2), TRANS,
                                  cfg.replace(sparse_words=False),
                                  device="cpu")
    assert not pipeline._SWORDS_SKIP
    stats = {}
    v, f = pipeline.image_to_mesh(p, _img(2), TRANS, cfg, device="cpu",
                                  stats=stats)
    assert stats["swords_guard"] > 0
    assert stats["route"] == "owned_ids" and stats["guard"] == 0
    np.testing.assert_array_equal(f, want[1])
    np.testing.assert_array_equal(v, want[0])
    assert (cfg, 0.0) in pipeline._SWORDS_SKIP
    stats = {}
    v, f = pipeline.image_to_mesh(p, _img(3), TRANS, cfg, device="cpu",
                                  stats=stats)
    assert "swords_guard" not in stats and stats["route"] == "owned_ids"
    want = pipeline.image_to_mesh(p, _img(3), TRANS,
                                  cfg.replace(sparse_words=False),
                                  device="cpu")
    np.testing.assert_array_equal(f, want[1])


def test_ineligible_grids_keep_the_volume_flow():
    """sdf_res 32 (R - 1 < 48): the JAX package's kernel_enabled refuses
    the grid, and the words flow does not run."""
    _, p = _params(0.25)
    cfg = Config(**dict(SMALL64, sdf_res=32))
    assert not sparse.words_eligible(cfg)
    assert sparse.words_eligible(Config(**SMALL64))
    stats = {}
    pipeline.image_to_mesh(p, _img(), TRANS, cfg, device="cpu", stats=stats)
    assert stats["route"] == "owned_ids" and "swords_guard" not in stats


def _sphere(R, r):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - r).astype(np.float32)


def _octahedron(R, r):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    return (np.abs(x) + np.abs(y) + np.abs(z) - r).astype(np.float32)


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


@pytest.mark.parametrize("shape", ["sphere", "octahedron"])
def test_volume_to_mesh_matches_jax(shape, monkeypatch):
    """volume_to_mesh on one 33^3 volume: the faces of disn_tpu's (its
    device extractor) in order, the vertices within its u16 step (span /
    65535: it ships u16 fixed-point vertices), and the same vertex and
    triangle sets as the mesh oracle (marching_tets + weld); neither
    marching_tets nor weld runs."""
    vol = _sphere(33, 0.6) if shape == "sphere" else _octahedron(33, 0.55)
    jv, jf = jpipeline.volume_to_mesh(vol, BOX)
    ov, of_ = marching.extract_mesh(torch.from_numpy(vol), BOX)

    def refuse(*a, **k):
        raise AssertionError("volume_to_mesh ran the mesh oracle")

    monkeypatch.setattr(marching, "marching_tets", refuse)
    monkeypatch.setattr(marching, "weld", refuse)
    v, f = pipeline.volume_to_mesh(torch.from_numpy(vol), BOX)
    assert len(f) > 1000
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2 / 65535, rtol=0)
    assert len(v) == len(ov) and len(f) == len(of_)
    for a, b in zip(_mesh_sets(v, f), _mesh_sets(ov, of_)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
