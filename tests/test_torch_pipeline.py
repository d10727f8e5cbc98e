"""disn_tpu_torch's sparse volume, mesh extraction and image_to_mesh against
disn_tpu's, float32 on the CPU, from the same params."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.infer import sparse as jsparse
from disn_tpu.models import disn as jdisn
from disn_tpu.ops import marching as jmarching
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import dense, pipeline, sparse
from disn_tpu_torch.ops import marching
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32")


def _params(kind, jcfg):
    if kind == "octahedron":
        jp = jsynthetic.analytic_octahedron_params(jcfg, r=0.6)
    else:
        jp = jdisn.init(jcfg, jax.random.PRNGKey(5))
    return jp, convert.params_from_jax(jax.device_get(jp))


def _img(seed=0):
    return np.random.RandomState(seed).rand(1, 137, 137, 3).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["octahedron", "random"])
def test_sparse_dense_sdf_matches_jax(kind):
    """sdf_res=48: the JAX fine pass runs its Pallas kernel (interpret
    mode), the port its plain K1. The octahedron takes the sparse path under
    a roomy cap; random params (no distance-like field) overflow the default
    cap and both packages take the dense fallback. Volumes agree to f32
    summation order."""
    frac = 0.9 if kind == "octahedron" else 0.25
    kw = dict(SMALL, sdf_res=48, cell_cap_frac=frac)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jp, p = _params(kind, jcfg)
    img, trans = _img(), jsynthetic.demo_trans_mat()
    want = jsparse.sparse_dense_sdf(jp, img, trans, BOX, jcfg,
                                    cell_cap_frac=frac, dynamic=True)
    stats = {}
    got = sparse.sparse_dense_sdf(p, img, trans, BOX, cfg, device="cpu",
                                  stats=stats).numpy()
    assert stats["dense_fallback"] == (kind == "random")
    assert got.shape == (49, 49, 49) and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_overflow_falls_back_to_dense():
    """A cap below the active count takes the exact dense path, which must
    equal dense_sdf, and agrees with the sparse volume near the surface."""
    kw = dict(SMALL, sdf_res=32)
    cfg = Config(**kw)
    _, p = _params("octahedron", JConfig(**kw))
    img, trans = _img(), jsynthetic.demo_trans_mat()
    stats = {}
    vol = sparse.sparse_dense_sdf(p, img, trans, BOX,
                                  cfg.replace(cell_cap_frac=0.01),
                                  device="cpu", stats=stats)
    assert stats["dense_fallback"] and "phase_b_ms" not in stats
    want = dense.dense_sdf(p, img, trans, BOX, cfg, device="cpu")
    np.testing.assert_array_equal(vol.numpy(), want.numpy())
    roomy = sparse.sparse_dense_sdf(p, img, trans, BOX,
                                    cfg.replace(cell_cap_frac=0.9),
                                    device="cpu")
    near = np.abs(want.numpy()) < 0.05
    np.testing.assert_allclose(roomy.numpy()[near], want.numpy()[near],
                               rtol=1e-5, atol=1e-6)


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def test_image_to_mesh_matches_jax():
    """sdf_res=32 octahedron: the same welded mesh as the JAX production
    path (records + native assembly), as vertex and triangle sets. The JAX
    path ships u16 fixed-point vertices (step 3.05e-5 over the box), hence
    atol 2e-5."""
    kw = dict(SMALL, sdf_res=32, cell_cap_frac=0.9)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jp, p = _params("octahedron", jcfg)
    img, trans = _img()[0], jsynthetic.demo_trans_mat()
    jv, jf = jpipeline.image_to_mesh(jp, img, trans, jcfg)
    stats = {}
    v, f = pipeline.image_to_mesh(p, img, trans, cfg, device="cpu",
                                  stats=stats)
    assert not stats["dense_fallback"]
    assert len(f) > 1000 and len(v) == len(jv) and len(f) == len(jf)
    for a, b in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_image_to_mesh_u8_on_surface():
    """u8 input, sdf_res=32: every vertex lies on |x|+|y|+|z| = 0.6 (the
    field is exactly linear along each tet edge inside a face's cell)."""
    kw = dict(SMALL, sdf_res=32, cell_cap_frac=0.9)
    cfg = Config(**kw)
    _, p = _params("octahedron", JConfig(**kw))
    img = np.random.RandomState(9).randint(0, 256, (137, 137, 3), np.uint8)
    v, f = pipeline.image_to_mesh(p, img, jsynthetic.demo_trans_mat(), cfg,
                                  device="cpu")
    assert len(f) > 1000
    assert np.abs(np.abs(v).sum(1) - 0.6).max() < 1e-5


def _sphere(R, r=0.6):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    return (np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) - r).astype(np.float32)


@pytest.mark.parametrize("case", ["sphere", "boundary", "random", "iso"])
def test_extract_mesh_matches_jax(case):
    """marching_tets + weld: identical welded vertices and faces (the same
    cell order and slot order on both sides)."""
    iso = 0.07 if case == "iso" else 0.0
    if case == "random":
        vol = np.random.RandomState(3).randn(9, 9, 9).astype(np.float32)
    else:
        vol = _sphere(17, r=1.3 if case == "boundary" else 0.6)
    jv, jf = jmarching.extract_mesh(vol, BOX, iso=iso)
    v, f = marching.extract_mesh(torch.from_numpy(vol), BOX, iso=iso)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-6)


def test_upsample_and_cull_match_jax():
    rng = np.random.RandomState(4)
    vol_c = (_sphere(13) + 0.01 * rng.randn(13, 13, 13)).astype(np.float32)
    np.testing.assert_allclose(
        sparse._upsample_aligned(torch.from_numpy(vol_c), 4).numpy(),
        np.asarray(jsparse._upsample_aligned(jnp.asarray(vol_c), 4)),
        rtol=1e-6, atol=1e-6)
    cfg = Config(**SMALL)
    tau = sparse._band_tau(torch.from_numpy(vol_c), torch.from_numpy(BOX),
                           13, 1.5, cfg)
    jtau = jsparse._band_tau(jnp.asarray(vol_c), jnp.asarray(BOX), 13, 1.5,
                             JConfig(**SMALL))
    np.testing.assert_allclose(float(tau), float(jtau), rtol=1e-6)
    ids, count = sparse._active_cells(torch.from_numpy(vol_c), tau)
    jids, jcount = jsparse._active_cells(jnp.asarray(vol_c), jtau, 12 ** 3)
    assert count == int(jcount) > 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:count])


SMALL64 = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
               sdf_res=64, cell_cap_frac=0.9)


@pytest.mark.parametrize("kind,sdf_res", [("octahedron", 32),
                                          ("octahedron", 64),
                                          ("random", 32)])
def test_phase_b_mesh_matches_jax(kind, sdf_res):
    """The fine pass + candidate scan against _phase_b_mesh_jit, both fed
    the port's phase_a outputs' JAX counterparts: the volume to f32
    summation order, the scan's ids, count and block rows bit for bit
    whenever the two volumes have the same signs (they do: on the
    octahedron the field is exact at grid points; with random weights the
    values differ only in summation order, and the test requires the sign
    patterns to be equal before it compares)."""
    kw = dict(SMALL, sdf_res=sdf_res, cell_cap_frac=1.0)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jp, p = _params(kind, jcfg)
    img, trans = _img(), jsynthetic.demo_trans_mat()
    stats = {}
    vol, scan = sparse.sparse_volume(p, img, trans, BOX, cfg, device="cpu",
                                     stats=stats, scan_iso=0.0)
    assert not stats["dense_fallback"] and scan is not None
    assert stats["scan_ms"] > 0 and stats["phase_b_ms"] > 0
    ids, n, guard, blk = scan

    jvol = jsparse.sparse_dense_sdf(jp, img, trans, BOX, jcfg,
                                    cell_cap_frac=1.0, dynamic=True)
    scale = np.abs(jvol).max()
    np.testing.assert_allclose(vol.numpy(), jvol, rtol=1e-5,
                               atol=1e-5 * scale)
    assert ((vol.numpy() < 0) == (np.asarray(jvol) < 0)).all()
    rc = sdf_res // 4 + 1
    jids_c, jcount = jsparse._active_cells(
        jnp.asarray(np.asarray(jvol)[::4, ::4, ::4]),
        jsparse._band_tau(jnp.asarray(np.asarray(jvol)[::4, ::4, ::4]),
                          jnp.asarray(BOX), rc, jcfg.band_factor, jcfg),
        (rc - 1) ** 3)
    want_ids, want_n, want_over, want_blk = jmarching._active_cells_from_coarse(
        jnp.asarray(jvol), jids_c, jcount, iso=0.0, stride=4,
        bcap=2 * rc ** 3)
    assert n == int(want_n) and guard == int(want_over)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids)[:n])
    wb = np.asarray(want_blk)
    np.testing.assert_array_equal(
        blk.numpy(), wb[(wb[:, 1] != 0) | (wb[:, 2] != 0)])


@pytest.mark.parametrize("sdf_res", [32, 64])
def test_image_to_mesh_owned_route_matches_jax(sdf_res):
    """End to end on the narrow net with the analytic octahedron head: the
    port's owned route gives the reference's faces exactly (the reference's
    record route emits the same order) and its vertices within atol 2e-5.
    The reference ships u16 edge parameters at these grids (sdf_res < 128):
    its vertices are off the exact ones by at most cell/131070 = 4.8e-7 at
    32, far inside the tolerance, which is test_image_to_mesh_matches_jax's."""
    kw = dict(SMALL, sdf_res=sdf_res, cell_cap_frac=0.9)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jp, p = _params("octahedron", jcfg)
    img, trans = _img()[0], jsynthetic.demo_trans_mat()
    jv, jf = jpipeline.image_to_mesh(jp, img, trans, jcfg)
    stats = {}
    v, f = pipeline.image_to_mesh(p, img, trans, cfg, device="cpu",
                                  stats=stats)
    assert stats["route"] == "owned_ids" and stats["guard"] == 0
    assert stats["fine_cells"] > 0 and not stats["dense_fallback"]
    assert {"scan_ms", "extract_ms", "fetch_ms", "extraction_ms"} <= set(stats)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2e-5, rtol=0)
    assert np.abs(np.abs(v).sum(1) - 0.6).max() < 1e-5
    # the mesh oracle on the same volume: the same vertex and triangle sets
    vol = pipeline.predict_volume(p, img, trans, BOX, cfg, device="cpu")
    tv, tf_ = pipeline.volume_to_mesh(vol, BOX)
    assert len(tv) == len(v) and len(tf_) == len(f)
    for a, b in zip(_mesh_sets(v, f), _mesh_sets(tv, tf_)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_image_to_mesh_cap_overflow_takes_tets_route():
    kw = dict(SMALL, sdf_res=32, cell_cap_frac=0.01)
    cfg = Config(**kw)
    _, p = _params("octahedron", JConfig(**kw))
    img, trans = _img()[0], jsynthetic.demo_trans_mat()
    stats = {}
    v, f = pipeline.image_to_mesh(p, img, trans, cfg, device="cpu",
                                  stats=stats)
    assert stats["dense_fallback"] and stats["route"] == "tets"
    assert "guard" not in stats and "scan_ms" not in stats
    ov, of_ = pipeline.image_to_mesh(p, img, trans,
                                     cfg.replace(cell_cap_frac=0.9),
                                     device="cpu")
    assert len(v) == len(ov) and len(f) == len(of_)
    for a, b in zip(_mesh_sets(v, f), _mesh_sets(ov, of_)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_image_to_mesh_guard_takes_full_scan(monkeypatch):
    """A candidate scan that misses change cells (here: told of no active
    coarse cell) reports guard > 0, and image_to_mesh scans the whole
    volume it already built: the same mesh as the guard-free run."""
    kw = dict(SMALL, sdf_res=32, cell_cap_frac=0.9)
    cfg = Config(**kw)
    _, p = _params("octahedron", JConfig(**kw))
    img, trans = _img()[0], jsynthetic.demo_trans_mat()
    want_v, want_f = pipeline.image_to_mesh(p, img, trans, cfg, device="cpu")
    real_scan = marching._active_cells_from_coarse

    def blind_scan(vol, coarse_ids, iso, stride, count=None, bcap=None):
        if count is None:
            return real_scan(vol, coarse_ids[:0], iso, stride=stride)
        # the speculative dispatch's fixed form: a count of 0
        return real_scan(vol, coarse_ids, iso, stride=stride,
                         count=count * 0, bcap=bcap)

    monkeypatch.setattr(marching, "_active_cells_from_coarse", blind_scan)
    stats = {}
    v, f = pipeline.image_to_mesh(p, img, trans, cfg, device="cpu",
                                  stats=stats)
    assert stats["route"] == "owned_scan" and stats["guard"] > 0
    np.testing.assert_array_equal(f, want_f)
    np.testing.assert_array_equal(v, want_v)


def test_image_to_mesh_ineligible_config_takes_tets_route():
    """sdf_res not a multiple of the stride: the dense path and the mesh
    oracle."""
    kw = dict(SMALL, sdf_res=16, sparse_stride=8)
    cfg = Config(**kw)
    _, p = _params("octahedron", JConfig(**kw))
    stats = {}
    v, f = pipeline.image_to_mesh(p, _img()[0], jsynthetic.demo_trans_mat(),
                                  cfg, device="cpu", stats=stats)
    assert stats["route"] == "tets" and len(f) > 100
    assert np.abs(np.abs(v).sum(1) - 0.6).max() < 1e-5


def test_clean_small_parts_matches_jax():
    """Two spheres, one small and far from the centre: the same kept mesh
    as the reference's clean_small_parts, and through clean=True."""
    from disn_tpu import postprocessing as jpost
    from disn_tpu_torch import postprocessing as post

    lin = np.linspace(-1, 1, 33, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = np.minimum(np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.4,
                     np.sqrt((x - 0.8) ** 2 + y ** 2 + z ** 2) - 0.1
                     ).astype(np.float32)
    v, f = marching.extract_mesh_owned(vol, BOX, device="cpu")
    np.testing.assert_array_equal(post.connected_components(len(v), f),
                                  jpost.connected_components(len(v), f))
    wv, wf = jpost.clean_small_parts(v, f)
    gv, gf = post.clean_small_parts(v, f)
    assert 0 < len(gv) < len(v)
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gv, wv)
    cv, cf = pipeline.volume_to_mesh(torch.from_numpy(vol), BOX, clean=True)
    assert len(cv) == len(gv) and len(cf) == len(gf)
    ev, ef = post.clean_small_parts(v[:0], f[:0])
    assert len(ev) == 0 and len(ef) == 0
