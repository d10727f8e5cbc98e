"""disn_tpu_torch's multi-view fusion (infer/multiview, the local-feature
sampling and unfolded streams it decodes with, the sign-change cull)
against disn_tpu's, on the CPU at CI width (width_mult 0.125, 32 classes,
sdf_res 8-32), from the same params (convert.params_from_jax) and seeded
numpy inputs. Tolerances: f32 summation order (XLA against torch on the
CPU) unless a test says otherwise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import multiview as jmv
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.infer import sparse as jsparse
from disn_tpu.models import disn as jdisn
from disn_tpu.models import sdfnet as jsdfnet
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import dense, multiview, pipeline, sparse
from disn_tpu_torch.models import disn, sdfnet
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SMALL = dict(num_classes=32, width_mult=0.125)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(**kw):
    kw = dict(SMALL, **kw)
    return JConfig(**kw), Config(**kw)


def _views(v=3, seed=1, u8=False):
    """V seeded images and V cameras (the JAX tests' focal ladder)."""
    rng = np.random.RandomState(seed)
    if u8:
        imgs = rng.randint(0, 256, (v, 137, 137, 3), dtype=np.uint8)
    else:
        imgs = rng.rand(v, 137, 137, 3).astype(np.float32)
    trans = np.stack([np.vstack([np.eye(3) * (50 + 10 * i),
                                 [68.0, 68.0, 2.0]]) for i in range(v)]
                     ).astype(np.float32)
    return imgs, trans


def _params(jcfg, kind="random", seed=1):
    if kind == "octahedron":
        jp = jsynthetic.analytic_octahedron_params(jcfg, r=0.6)
    else:
        jp = jdisn.init(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_jax(jax.device_get(jp))


def _close(got, want, dtype="float32"):
    """f32: 1e-4 of the scale. bf16: tests/test_fused.py's bounds (both
    sides round to bf16 per layer, at different places): max 2% and mean
    0.3% of the scale."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1e-3, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert np.abs(got - want).max() <= 0.02 * scale
        assert np.abs(got - want).mean() <= 0.003 * scale


@pytest.fixture(scope="module")
def endpoints():
    """One view's VGG endpoint maps (the port's encoder), as numpy."""
    _, cfg = _cfgs()
    _, p = _params(JConfig(**SMALL))
    img = np.random.RandomState(2).rand(2, 137, 137, 3).astype(np.float32)
    _, eps = disn.encode(p, torch.from_numpy(img), cfg)
    return {k: v.numpy() for k, v in eps.items()}


@pytest.mark.parametrize("arm", ["native", "fused", "materialising"])
def test_sample_local_features_matches_jax(endpoints, arm):
    """[B,N,1472] per-point features on every arm, the same maps and pixel
    coordinates (the image's corners included) through both packages."""
    jcfg, cfg = _cfgs(sampling="native" if arm == "native" else "tf1")
    rng = np.random.RandomState(3)
    px = rng.uniform(0, 136, (2, 200, 2)).astype(np.float32)
    px[0, :3] = [[0, 0], [136, 136], [135.999, 0.0]]
    fused = arm != "materialising"
    want = jdisn.sample_local_features(
        {k: jnp.asarray(v) for k, v in endpoints.items()}, jnp.asarray(px),
        jcfg, fused=fused)
    got = disn.sample_local_features(
        {k: torch.from_numpy(v) for k, v in endpoints.items()},
        torch.from_numpy(px), cfg, fused=fused)
    assert got.shape == (2, 200, cfg.local_feat_dim)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("binary", [False, True])
def test_decode_from_features_matches_jax(dtype, binary):
    """The unfolded two streams (fold1, concat, fold2; 512+32 and 512+1472
    inputs here) from given features, and each head alone."""
    jcfg, cfg = _cfgs(compute_dtype=dtype, binary=binary)
    jp, p = _params(jcfg)
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    emb = rng.randn(1, 32).astype(np.float32)
    loc = rng.randn(1, 300, cfg.local_feat_dim).astype(np.float32)
    want = jdisn.decode_from_features(jp, jnp.asarray(pts), jnp.asarray(emb),
                                      jnp.asarray(loc), jcfg)
    got = disn.decode_from_features(p, torch.from_numpy(pts),
                                    torch.from_numpy(emb),
                                    torch.from_numpy(loc), cfg)
    assert got.dtype == DTYPES[dtype] and got.shape == (1, 300,
                                                        2 if binary else 1)
    _close(got.float().numpy(), want, dtype)
    cd, jcd = DTYPES[dtype], jnp.dtype(dtype)
    _close(sdfnet.apply_global_head(
        p["sdfprediction"], torch.from_numpy(pts), torch.from_numpy(emb),
        cd).float().numpy(),
        jsdfnet.apply_global_head(jp["sdfprediction"], jnp.asarray(pts),
                                  jnp.asarray(emb), jcd), dtype)
    _close(sdfnet.apply_local_head(
        p["sdfprediction_imgfeat"], torch.from_numpy(pts),
        torch.from_numpy(loc), cd).float().numpy(),
        jsdfnet.apply_local_head(jp["sdfprediction_imgfeat"],
                                 jnp.asarray(pts), jnp.asarray(loc), jcd),
        dtype)


@pytest.mark.parametrize("mode", ["band", "sign"])
@pytest.mark.parametrize("seed", [0, 1])
def test_active_cells_matches_jax(mode, seed):
    """Equal ids (ascending) and counts on a noisy sphere's coarse grid;
    it holds values exactly at 0 (in the class v >= 0) and at tau."""
    rng = np.random.RandomState(seed)
    lin = np.linspace(-1, 1, 9)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = (np.sqrt(x * x + y * y + z * z) - 0.6
           + 0.05 * rng.randn(9, 9, 9)).astype(np.float32)
    vol[rng.rand(9, 9, 9) < 0.05] = 0.0
    tau = np.float32(0.15)
    vol[0, 0, :4] = [tau, -tau, 0.14999, 0.15001]
    jids, jcount = jsparse._active_cells(jnp.asarray(vol), jnp.asarray(tau),
                                         512, mode=mode)
    ids, count = sparse._active_cells(torch.from_numpy(vol),
                                      torch.tensor(tau), mode=mode)
    assert count == int(jcount) and 0 < count < 512
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:count])


def test_active_cells_sign_mode_dilates_by_one_cell():
    """One cell with a sign change activates its 3^3 neighbourhood, cut at
    the grid's faces."""
    vol = np.ones((9, 9, 9), np.float32)
    vol[0, 0, 0] = -1.0                      # a corner of cell (0,0,0) only
    ids, count = sparse._active_cells(torch.from_numpy(vol),
                                      torch.tensor(0.0), mode="sign")
    assert count == 8
    assert ids.tolist() == [0, 1, 8, 9, 64, 65, 72, 73]
    with pytest.raises(ValueError):
        sparse._active_cells(torch.from_numpy(vol), torch.tensor(0.0),
                             mode="other")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mv_prep_matches_jax(dtype):
    """The fused embedding, each view's folded map and the MEAN
    embedding's g_contrib (its cast to the compute type, then the
    matmul)."""
    jcfg, cfg = _cfgs(compute_dtype=dtype, sdf_res=8, sampling="tf1")
    jp, p = _params(jcfg)
    imgs, _ = _views(3, u8=True)
    jemb, jmerged, jg, jeps = jmv._mv_prep(jp, jnp.asarray(imgs), jcfg)
    emb, merged, g, eps = multiview._mv_prep(p, torch.from_numpy(imgs), cfg)
    assert jeps is None and eps is None
    assert merged.shape == (3, 137, 137, 512) and g.shape == (1, 512)
    assert merged.dtype == g.dtype == DTYPES[dtype]
    for a, b in ((emb, jemb), (merged, jmerged), (g, jg)):
        _close(a.float().numpy(), b, dtype)
    cd = DTYPES[dtype]
    wg = p["sdfprediction"]["fold2"]["conv1"]["weights"]
    assert torch.equal(g, torch.matmul(emb.to(cd), wg[512:].to(cd)))


def test_mv_prep_general_arm_matches_jax():
    """Native sampling: no fold; the fused embedding and each view's
    endpoint maps."""
    jcfg, cfg = _cfgs(sdf_res=8, sampling="native")
    jp, p = _params(jcfg)
    imgs, _ = _views(2)
    jemb, jmerged, jg, jeps = jmv._mv_prep(jp, jnp.asarray(imgs), jcfg)
    emb, merged, g, eps = multiview._mv_prep(p, torch.from_numpy(imgs), cfg)
    assert merged is None and g is None and jmerged is None and jg is None
    assert set(eps) == set(jeps)
    _close(emb.numpy(), jemb)
    for name in disn.endpoint_names(cfg):
        assert eps[name].shape[0] == 2
        _close(eps[name].numpy(), jeps[name])


def _jax_state(jstate):
    return tuple(None if x is None else
                 ({k: torch.from_numpy(np.array(v, np.float32)).to(
                     DTYPES[str(v.dtype)]) for k, v in x.items()}
                  if isinstance(x, dict) else
                  torch.from_numpy(np.array(x, np.float32)).to(
                      DTYPES[str(x.dtype)]))
                 for x in jstate)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sampling", ["tf1", "native"])
def test_mv_decode_matches_jax(dtype, sampling):
    """The decode on the JAX package's own state (so the encoders' bf16
    rounding stays out): the folded arm (tf1: the resampler's taps per
    view, their f32 mean, the prefold streams) and the general arm
    (native: per-view features, their mean, the unfolded streams)."""
    jcfg, cfg = _cfgs(compute_dtype=dtype, sdf_res=8, sampling=sampling)
    jp, p = _params(jcfg)
    imgs, trans = _views(3)
    jstate = jmv._mv_prep(jp, jnp.asarray(imgs), jcfg)
    pts = np.random.RandomState(5).uniform(-1, 1, (500, 3)).astype(
        np.float32)
    want = jmv._mv_decode(jp, jstate, jnp.asarray(trans), jnp.asarray(pts),
                          jcfg)
    got = multiview._mv_decode(p, _jax_state(jstate), torch.from_numpy(trans),
                               torch.from_numpy(pts), cfg)
    assert got.shape == (500,) and got.dtype == DTYPES[dtype]
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("sampling", ["tf1", "native"])
def test_multiview_sdf_matches_jax(sampling):
    """The dense stream's volume, u8 views."""
    jcfg, cfg = _cfgs(sdf_res=8, sampling=sampling)
    jp, p = _params(jcfg)
    imgs, trans = _views(3, u8=True)
    want = np.asarray(jmv.multiview_sdf(jp, imgs, trans, BOX, jcfg,
                                        block=128))
    got = multiview.multiview_sdf(p, imgs, trans, BOX, cfg, device="cpu")
    assert got.shape == (9, 9, 9) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind,binary", [("random", False),
                                         ("octahedron", False),
                                         ("octahedron", True)])
def test_multiview_sdf_sparse_matches_jax(kind, binary):
    """sdf_res 16: the band cull (random params, the analytic head) and the
    dilated sign cull (its binary head), the fine cells, the upsampled far
    field and the boundary planes. The active counts are equal."""
    jcfg, cfg = _cfgs(sdf_res=16, binary=binary)
    jp, p = _params(jcfg, kind)
    imgs, trans = _views(3)
    jstate, jvol_c, jids, jcount = jmv._mv_parts(
        jcfg, 4, 32768, 0.25, 1.5)[1](jp, jnp.asarray(imgs),
                                      jnp.asarray(trans), jnp.asarray(BOX))
    want = np.asarray(jmv.multiview_sdf_sparse(jp, imgs, trans, BOX, jcfg))
    stats = {}
    got = multiview.multiview_sdf_sparse(p, imgs, trans, BOX, cfg,
                                         device="cpu", stats=stats)
    assert stats["active_cells"] == int(jcount) > 0
    assert not stats["dense_fallback"]
    assert stats["cell_cap"] == jmv._mv_parts(jcfg, 4, 32768, 0.25,
                                              1.5)[0]["cell_cap"]
    _close(got.numpy(), want)


def test_multiview_sparse_overflow_returns_none():
    """A cap below the active count (blocks of 256 points: a cap of 256
    cells) gives None in both packages; a grid the stride does not divide
    too."""
    jcfg, cfg = _cfgs(sdf_res=32)
    jp, p = _params(jcfg)
    imgs, trans = _views(2)
    assert jmv.multiview_sdf_sparse(jp, imgs, trans, BOX, jcfg,
                                    block=256) is None
    stats = {}
    assert multiview.multiview_sdf_sparse(p, imgs, trans, BOX, cfg,
                                          block=256, device="cpu",
                                          stats=stats) is None
    assert stats["dense_fallback"] and stats["active_cells"] > 256
    assert stats["cell_cap"] == 256 and "finish_ms" not in stats
    odd = cfg.replace(sdf_res=30)
    assert multiview.multiview_sdf_sparse(p, imgs, trans, BOX, odd,
                                          device="cpu") is None


def test_multiview_folded_matches_general():
    """tf1: the folded arm's decode equals the general per-view path
    (resize_then_sample of every map, mean, unfolded streams) up to f32
    summation order (the JAX test's tolerance)."""
    _, cfg = _cfgs(sdf_res=8, sampling="tf1")
    assert multiview._use_fold(cfg)
    _, p = _params(JConfig(**SMALL))
    imgs, trans = _views(2, seed=3)
    imgs_t, trans_t = torch.from_numpy(imgs), torch.from_numpy(trans)
    pts = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, (256, 3)).astype(np.float32))
    state = multiview._mv_prep(p, imgs_t, cfg)
    assert state[1] is not None
    folded = multiview._mv_decode(p, state, trans_t, pts, cfg)
    embeddings, endpoints = disn.encode(p, imgs_t, cfg)
    local = multiview.fused_point_features(endpoints, pts, trans_t, cfg)
    pred = disn.decode_from_features(p, pts[None],
                                     embeddings.mean(0, keepdim=True),
                                     local[None], cfg)
    general = dense.scale_pred(pred, cfg)[0]
    np.testing.assert_allclose(folded.numpy(), general.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_multiview_single_view_matches_dense_sdf():
    """One view fused is the single-view volume: the port's dense_sdf (the
    fused decode's plain version and the planes) against multiview_sdf."""
    _, cfg = _cfgs(sdf_res=8, sampling="tf1")
    _, p = _params(JConfig(**SMALL))
    imgs, trans = _views(1)
    single = dense.dense_sdf(p, imgs, trans[0], BOX, cfg, device="cpu")
    fused = multiview.multiview_sdf(p, imgs, trans, BOX, cfg, device="cpu")
    np.testing.assert_allclose(fused.numpy(), single.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_decode_steps_cover_the_points(monkeypatch):
    """With a decode step of 64 points the volumes are the one-step
    volumes: the steps cover every point once."""
    _, cfg = _cfgs(sdf_res=16)
    _, p = _params(JConfig(**SMALL))
    imgs, trans = _views(2)
    whole = multiview.multiview_sdf_sparse(p, imgs, trans, BOX, cfg,
                                           device="cpu")
    dense_whole = multiview.multiview_sdf(p, imgs, trans, BOX, cfg,
                                          device="cpu")
    monkeypatch.setattr(multiview, "TAP_BYTES", 64 * 2 * 512 * 4)
    assert multiview.decode_step(multiview._mv_prep(
        p, torch.from_numpy(imgs), cfg), cfg) == 64
    np.testing.assert_allclose(multiview.multiview_sdf_sparse(
        p, imgs, trans, BOX, cfg, device="cpu").numpy(), whole.numpy(),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(multiview.multiview_sdf(
        p, imgs, trans, BOX, cfg, device="cpu").numpy(), dense_whole.numpy(),
        rtol=1e-6, atol=1e-7)


def test_multiview_sparse_matches_dense_mesh():
    """On the analytic head (its band engages as a trained net's) the
    sparse volume gives the dense stream's mesh: equal faces, vertices
    within 1e-6; and both packages' sparse meshes agree (JAX's extractor
    against the port's owned-edge one, as vertex and triangle sets)."""
    jcfg, cfg = _cfgs(sdf_res=32, num_classes=64)
    jp, p = _params(jcfg, "octahedron")
    imgs, trans = _views(3, seed=2, u8=True)
    dense_vol = multiview.multiview_sdf(p, imgs, trans, BOX, cfg,
                                        device="cpu")
    sparse_vol = multiview.multiview_sdf_sparse(p, imgs, trans, BOX, cfg,
                                                device="cpu")
    assert sparse_vol is not None
    dv, df = pipeline.volume_to_mesh(dense_vol, BOX)
    sv, sf = pipeline.volume_to_mesh(sparse_vol, BOX)
    assert len(df) > 100
    np.testing.assert_array_equal(sf, df)
    np.testing.assert_allclose(sv, dv, atol=1e-6)
    assert np.abs(np.abs(sv).sum(1) - 0.6).max() < 1e-5
    jv, jf = jpipeline.volume_to_mesh(
        jmv.multiview_sdf_sparse(jp, imgs, trans, BOX, jcfg), BOX)
    assert len(jf) == len(sf)
    for a, b in ((np.sort(sv, 0), np.sort(np.asarray(jv), 0)),
                 (np.sort(np.sort(sv[sf].reshape(len(sf), -1), 1), 0),
                  np.sort(np.sort(np.asarray(jv)[np.asarray(jf)].reshape(
                      len(jf), -1), 1), 0))):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_multiview_to_mesh_falls_back_to_dense(monkeypatch):
    """A cap overflow takes the dense stream (stats says so), whose mesh
    the roomy sparse flow gives too."""
    _, cfg = _cfgs(sdf_res=16, num_classes=64)
    _, p = _params(JConfig(**dict(SMALL, sdf_res=16, num_classes=64)),
                   "octahedron")
    imgs, trans = _views(2, u8=True)
    roomy = {}
    v, f = pipeline.multiview_to_mesh(p, imgs, trans, BOX, cfg,
                                      device="cpu", stats=roomy)
    assert not roomy["dense_fallback"] and "dense_ms" not in roomy
    monkeypatch.setattr(multiview, "cell_cap", lambda *a, **k: 1)
    stats = {}
    dv, df = pipeline.multiview_to_mesh(p, imgs, trans, BOX, cfg,
                                        device="cpu", stats=stats)
    assert stats["dense_fallback"] and "dense_ms" in stats
    assert "extraction_ms" in stats and len(df) > 100
    np.testing.assert_array_equal(f, df)
    np.testing.assert_allclose(v, dv, atol=1e-6)
