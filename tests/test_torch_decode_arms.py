"""disn_tpu_torch's decode of every arm against disn_tpu's, float32 on the
CPU at CI width (width_mult 0.125, 32 classes, grids of 17^3-49^3): the
fold modes, _prep, _decode_block (fold 137, folded-local, split twostream,
onestream, global; tf1 and native sampling), _stream_blocks, dense_sdf and
the sparse flow off the kernel, kernel_enabled and Config.fused_kernel, the
binary heads' sign cull, and the binary twostream head through K1 (its
plain version here, JAX's kernel in interpret mode). Same params
(convert.params_from_jax) and seeded numpy inputs. Tolerance: 1e-4 of the
output's scale (XLA and torch sum matmuls in other orders) unless a test
says otherwise."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.config import Variant as JVariant
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import dense as jdense
from disn_tpu.infer import fused as jfused
from disn_tpu.infer import pipeline as jpipeline
from disn_tpu.infer import sparse as jsparse
from disn_tpu.models import disn as jdisn
from disn_tpu.ops import pallas_fused as jpallas
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import dense, fused, pipeline, sparse
from disn_tpu_torch.ops import fused_decode
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32")
RTOL = 1e-4
TRANS = synthetic.demo_trans_mat()


def _cfgs(variant="twostream", **kw):
    kw = dict(SMALL, **kw)
    return (JConfig(**dict(kw, variant=JVariant(variant))),
            Config(**dict(kw, variant=Variant(variant))))


@functools.lru_cache(maxsize=None)
def _params(variant, binary=False):
    """A seeded JAX init with head biases N(0, 0.1^2), and the port's copy."""
    jcfg, _ = _cfgs(variant, binary=binary)
    tree = jax.device_get(jdisn.init(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.RandomState(4)

    def biased(t):
        return {k: (biased(v) if isinstance(v, dict) else
                    (0.1 * rng.randn(*v.shape)).astype(np.float32)
                    if k == "biases" else v) for k, v in t.items()}

    tree = {k: (v if k == "vgg_16" else biased(v)) for k, v in tree.items()}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree))


def _img(seed=0):
    return np.random.RandomState(seed).rand(1, 137, 137, 3).astype(
        np.float32)


def _close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("variant", ["twostream", "onestream", "global"])
@pytest.mark.parametrize("sampling", ["tf1", "native"])
def test_normalize_fold_matches_jax(variant, sampling):
    jcfg, cfg = _cfgs(variant, sampling=sampling)
    for fold in (None, "auto", True, False, "none", "local", "137"):
        assert dense.normalize_fold(fold, cfg) == \
            jdense.normalize_fold(fold, jcfg)
    with pytest.raises(ValueError):
        dense.normalize_fold("folded", cfg)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("variant,sampling", [("twostream", "tf1"),
                                              ("twostream", "native"),
                                              ("onestream", "tf1")])
def test_kernel_enabled_matches_jax(mode, variant, sampling):
    """Every grid and stride, strict and not: the same answer, or both
    raise (fused_kernel='on' on an ineligible config). The port knowingly
    differs on the grids below 49^3 (17, 33, 45): the JAX package's
    fine_r - 1 >= 48 term sizes its TPU tiles, and the CUDA kernel has
    none, so there the port answers as the JAX package does on a grid
    64 points larger (same residue mod 4, no size term)."""
    jcfg, cfg = _cfgs(variant, sampling=sampling, fused_kernel=mode)
    fold = dense.normalize_fold(None, cfg)
    for fine_r in (17, 33, 45, 49, 50, 65, 257):
        jr = fine_r + 64 if fine_r < 49 else fine_r
        for stride in (2, 4):
            for strict in (True, False):
                try:
                    want = jfused.kernel_enabled(jcfg, fold, stride, jr,
                                                 strict=strict)
                except ValueError:
                    with pytest.raises(ValueError):
                        fused.kernel_enabled(cfg, fold, stride, fine_r,
                                             strict=strict)
                    continue
                assert fused.kernel_enabled(cfg, fold, stride, fine_r,
                                            strict=strict) == want


def test_kernel_serves_the_grids_below_49():
    """Where the port differs from the JAX package (see above): on a
    twostream + tf1 config at 17^3, 33^3 and 45^3 the JAX package refuses
    the kernel ('on' raises) and the port takes it."""
    for fine_r in (17, 33, 45):
        for mode in ("auto", "on"):
            jcfg, cfg = _cfgs(fused_kernel=mode)
            assert fused.kernel_enabled(cfg, "137", 4, fine_r)
            if mode == "auto":
                assert not jfused.kernel_enabled(jcfg, "137", 4, fine_r)
            else:
                with pytest.raises(ValueError, match="ineligible"):
                    jfused.kernel_enabled(jcfg, "137", 4, fine_r)


# (variant, fold, sampling): every arm of _decode_block
ARMS = [("twostream", "137", "tf1"), ("twostream", "local", "tf1"),
        ("twostream", "local", "native"), ("twostream", "none", "tf1"),
        ("twostream", "none", "native"), ("onestream", "none", "tf1"),
        ("onestream", "none", "native"), ("global", "none", "tf1")]


@pytest.mark.parametrize("variant,fold,sampling", ARMS)
@pytest.mark.parametrize("head", ["regress", "binary_tanh"])
def test_decode_block_matches_jax(variant, fold, sampling, head):
    """_prep (each endpoint dict entry) and _decode_block on 700 points of
    the box, under the demo camera."""
    binary = head != "regress"
    jcfg, cfg = _cfgs(variant, sampling=sampling, binary=binary,
                      tanh=binary)
    jp, p = _params(variant, binary)
    img = _img(1)
    jemb, jeps = jax.jit(functools.partial(jdense._prep, cfg=jcfg,
                                           fold_local=fold))(
        jp, jnp.asarray(img))
    emb, eps = dense._prep(p, torch.from_numpy(img), cfg, fold_local=fold)
    assert set(eps) == set(jeps)
    for k in jeps:
        _close(eps[k], jeps[k], what=k)
    pts = np.random.RandomState(2).uniform(-1, 1, (700, 3)).astype(
        np.float32)
    want = jax.jit(functools.partial(jdense._decode_block, cfg=jcfg,
                                     folded=fold))(
        jp, jeps, jemb, jnp.asarray(TRANS), jnp.asarray(pts))
    got = dense._decode_block(p, eps, emb, torch.from_numpy(TRANS),
                              torch.from_numpy(pts), cfg, folded=fold)
    assert got.shape == (700,)
    _close(got, want)


def test_decode_block_refuses_threedcnn():
    jcfg, cfg = _cfgs("threedcnn")
    with pytest.raises(ValueError, match="THREEDCNN"):
        jdense._decode_block({}, {}, None, None, jnp.zeros((4, 3)), jcfg)
    with pytest.raises(ValueError, match="THREEDCNN"):
        dense._decode_block({}, {}, None, None, torch.zeros(4, 3), cfg)


def test_stream_blocks_matches_jax():
    """Flat indices [1000, 1000 + 5000) of a 33^3 grid in blocks of 1536
    (the port's last block is short, JAX's count is a whole number of
    blocks: 4 x 1536 = 6144 covers it, compared on the first 5000)."""
    jcfg, cfg = _cfgs("onestream", sdf_res=32)
    jp, p = _params("onestream")
    img = _img(3)
    jemb, jeps = jdense._prep(jp, jnp.asarray(img), jcfg)
    emb, eps = dense._prep(p, torch.from_numpy(img), cfg)
    want = np.asarray(jdense._stream_blocks(
        jp, jeps, jemb, jnp.asarray(TRANS), jnp.asarray(BOX), jcfg,
        jnp.int32(1000), 6144, 1536))[:5000]
    got = dense._stream_blocks(p, eps, emb, torch.from_numpy(TRANS),
                               torch.from_numpy(BOX), cfg, 1000, 5000,
                               block=1536)
    _close(got, want)


@pytest.mark.parametrize("variant,sampling", [("global", "tf1"),
                                              ("onestream", "tf1"),
                                              ("onestream", "native")])
def test_dense_sdf_matches_jax(variant, sampling):
    """The plain route of dense_sdf (no kernel off twostream + tf1) on a
    17^3 grid."""
    jcfg, cfg = _cfgs(variant, sampling=sampling, sdf_res=16)
    jp, p = _params(variant)
    img = _img(4)
    want = jdense.dense_sdf(jp, img, TRANS, BOX, jcfg)
    got = dense.dense_sdf(p, img, TRANS, BOX, cfg, device="cpu")
    assert got.shape == (17, 17, 17) and got.dtype == torch.float32
    _close(got, want)


def _count_kernel(monkeypatch):
    calls = []
    real = fused.decode_cells

    def counting(*a, **k):
        calls.append(k["fine_r"])
        return real(*a, **k)

    monkeypatch.setattr(fused, "decode_cells", counting)
    return calls


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_fused_kernel_setting_picks_the_decode(mode, monkeypatch):
    """Config.fused_kernel on an eligible config (twostream + tf1, 49^3):
    'auto' decodes the cells through K1 (here its plain version), once a
    grid; 'off' takes the plain per-point decode and never reaches K1.
    Either way the volume is the JAX package's XLA decode (fused_kernel
    'off'), which its own tests hold equal to its kernel's in f32."""
    jcfg, cfg = _cfgs(sdf_res=48, fused_kernel=mode)
    jp, p = _params("twostream")
    calls = _count_kernel(monkeypatch)
    img = _img(5)
    got = dense.dense_sdf(p, img, TRANS, BOX, cfg, device="cpu")
    assert calls == ([49] if mode == "auto" else [])
    _close(got, jdense.dense_sdf(jp, img, TRANS, BOX,
                                 jcfg.replace(fused_kernel="off")))


def test_fused_kernel_on_raises_where_jax_does(monkeypatch):
    """'on' with a config the kernel does not serve raises in both
    packages, on the dense and the sparse path; 'on' on an eligible one
    runs, at 49^3 and at 33^3 (a grid the JAX package refuses: see
    test_kernel_serves_the_grids_below_49), through K1 (here its plain
    version) once a grid, to the JAX package's XLA volume."""
    for variant, kw in (("onestream", {}), ("twostream",
                                            {"sampling": "native"})):
        jcfg, cfg = _cfgs(variant, fused_kernel="on", **kw)
        _, p = _params(variant)
        with pytest.raises(ValueError, match="ineligible"):
            jdense.make_dense_sdf_fn(jcfg)
        with pytest.raises(ValueError, match="ineligible"):
            dense.dense_sdf(p, _img(), TRANS, BOX, cfg, device="cpu")
        with pytest.raises(ValueError, match="ineligible"):
            pipeline.image_to_mesh(p, _img()[0], TRANS, cfg, device="cpu")
    jp, p = _params("twostream")
    calls = _count_kernel(monkeypatch)
    for res in (48, 32):
        jcfg, cfg = _cfgs(sdf_res=res, fused_kernel="on")
        calls.clear()
        got = dense.dense_sdf(p, _img(), TRANS, BOX, cfg, device="cpu")
        assert got.shape == (res + 1,) * 3 and calls == [res + 1]
        _close(got, jdense.dense_sdf(jp, _img(), TRANS, BOX,
                                     jcfg.replace(fused_kernel="off")))


@pytest.mark.parametrize("variant,sampling", [("onestream", "tf1"),
                                              ("twostream", "native")])
def test_sparse_volume_matches_jax(variant, sampling, monkeypatch):
    """The sparse flow off the kernel at 33^3 (coarse 9^3 and the fine
    cells by the plain decode, as the JAX package's XLA arm), for a head
    whose band culls: the analytic octahedron's global stream copied into
    the variant's (see _octahedron). Same active cells, same volume."""
    jcfg, cfg = _cfgs(variant, sampling=sampling, sdf_res=32,
                      cell_cap_frac=0.9)
    jp, p = _octahedron(variant, sampling)
    calls = _count_kernel(monkeypatch)
    img = _img(6)
    want = jsparse.sparse_dense_sdf(jp, img, TRANS, BOX, jcfg,
                                    cell_cap_frac=0.9, dynamic=True)
    stats = {}
    got = sparse.sparse_dense_sdf(p, img, TRANS, BOX, cfg, device="cpu",
                                  stats=stats)
    assert calls == [] and not stats["dense_fallback"]
    assert 0 < stats["active_cells"] < 8 ** 3
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _octahedron(variant, sampling):
    """The analytic octahedron head (|x|+|y|+|z| - 0.6, times 10) in the
    variant's point MLP: the twostream fixture's global stream, its
    fold2/conv1 rows copied into the same rows of the variant's (the point
    part comes first), the rest of the output layer zeroed, so that the
    band cull engages."""
    jcfg, _ = _cfgs("twostream", sampling=sampling)
    src = jax.device_get(jsynthetic.analytic_octahedron_params(jcfg, r=0.6))
    jp, _ = _params(variant)
    tree = jax.device_get(jp)
    if variant == "twostream":
        tree = src
    else:
        g = src["sdfprediction"]
        dst = tree["sdfimgfeat"]
        for fold in ("fold1", "fold2"):
            for name, leaf in g[fold].items():
                w = leaf["weights"]
                if (fold, name) == ("fold2", "conv1"):
                    w = np.zeros_like(dst[fold][name]["weights"])
                    w[:512] = g[fold][name]["weights"][:512]
                dst[fold][name] = {"weights": np.array(w),
                                   "biases": np.array(leaf["biases"])}
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree))


def test_binary_sign_route_matches_jax():
    """A binary twostream head (the analytic octahedron's logits (0,
    10(s - r))) with binary_sparse at 33^3 under a cap that holds the
    dilated band (cell_cap_frac 0.9): the sign cull's volume equals
    the JAX package's, its signs equal the dense volume's, and both
    packages' image_to_mesh give the same mesh (JAX ships u16 fixed-point
    vertices: atol 2e-5)."""
    kw = dict(sdf_res=32, binary=True, binary_sparse=True,
              cell_cap_frac=0.9)
    jcfg, cfg = _cfgs(**kw)
    jp = jsynthetic.analytic_octahedron_params(jcfg, r=0.6)
    p = convert.params_from_jax(jax.device_get(jp))
    img = _img(7)
    want = jpipeline.predict_volume(jp, img, TRANS, BOX, jcfg, sparse=True)
    stats = {}
    got = pipeline.predict_volume(p, img, TRANS, BOX, cfg, device="cpu",
                                  stats=stats)
    assert not stats["dense_fallback"] and stats["active_cells"] > 0
    _close(got, want)
    vol_d = pipeline.predict_volume(p, img, TRANS, BOX, cfg, device="cpu",
                                    sparse=False)
    np.testing.assert_array_equal(np.sign(got.numpy()),
                                  np.sign(vol_d.numpy()))
    jv, jf = jpipeline.image_to_mesh(jp, img[0], TRANS, jcfg)
    v, f = pipeline.image_to_mesh(p, img[0], TRANS, cfg, device="cpu")
    dv, df = pipeline.volume_to_mesh(vol_d, BOX)
    assert len(f) == len(jf) == len(df) > 100
    np.testing.assert_allclose(np.sort(v, axis=0), np.sort(jv, axis=0),
                               atol=2e-5)
    np.testing.assert_allclose(np.sort(v, axis=0), np.sort(dv, axis=0),
                               atol=1e-5)
    # without binary_sparse, binary heads take the exact dense path
    stats = {}
    pipeline.image_to_mesh(p, img[0], TRANS, cfg.replace(binary_sparse=False),
                           device="cpu", stats=stats)
    assert stats["route"] == "tets"


K1_FINE_R, K1_COARSE_C = 49, 12


@functools.lru_cache(maxsize=None)
def _binary_k1(dtype):
    """A binary twostream net at 49^3: JAX's folded map and params, and the
    port's copies in `dtype`."""
    jcfg, cfg = _cfgs(sdf_res=K1_FINE_R - 1, binary=True,
                      compute_dtype=dtype)
    jp, p = _params("twostream", True)
    _, jeps = jax.jit(functools.partial(jdense._prep, cfg=jcfg,
                                        fold_local="137"))(
        jp, jnp.asarray(_img(8)))
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    eps = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)
           for k, v in jeps.items()}
    return jcfg, cfg, jp, p, jeps, eps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binary_k1_matches_jax_kernel(dtype):
    """K1 with out_dim 2: the port's plain version against the Pallas
    kernel in interpret mode, on 96 seeded cells of a 49^3 grid: the two
    raw logits (fused_cell_decode) of the cells whose taps the TPU kernel's
    tiles hold, and the scaled (softmax_1 - 0.5)/10 values (decode_cells,
    which re-decodes the others: every cell in f32). f32: 1e-5 of the scale (summation order); bf16:
    tests/test_fused.py's bounds, max 2% and mean 0.3% of the scale."""
    jcfg, cfg, jp, p, jeps, eps = _binary_k1(dtype)
    cells = np.sort(np.random.RandomState(9).choice(
        K1_COARSE_C ** 3, 96, replace=False)).astype(np.int32)
    cd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tx, ty, cb = jfused.tiles_for(K1_FINE_R)
    raw_j, esc = jpallas.fused_cell_decode(
        jpallas.prep_map(jeps["fold137"], ty),
        jpallas.pack_weights(jp, jeps["g_contrib"], cd), jnp.asarray(TRANS),
        jnp.asarray(BOX), jnp.asarray(cells), stride=4, fine_r=K1_FINE_R,
        coarse_c=K1_COARSE_C, tx_t=tx, ty_t=ty, cb=cb, out_dim=2,
        interpret=True)
    # the TPU kernel's tiles miss some cells' taps (it rescues them in
    # decode_cells); its raw rows hold for the others
    ok = np.repeat(np.asarray(esc)[:96] == 0, 64)
    assert ok.sum() >= 48 * 64
    w = fused_decode.pack_weights(p, eps["g_contrib"], eps["fold137"].dtype)
    raw = fused_decode.fused_cell_decode(
        eps["fold137"][0].contiguous(), w, torch.from_numpy(TRANS),
        torch.from_numpy(BOX), torch.from_numpy(cells), fine_r=K1_FINE_R,
        coarse_c=K1_COARSE_C)
    assert raw.shape == (96 * 64, 2)
    vals_j, _ = jfused.decode_cells(jp, jeps, jnp.asarray(TRANS),
                                    jnp.asarray(BOX), jnp.asarray(cells),
                                    jcfg, fine_r=K1_FINE_R,
                                    coarse_c=K1_COARSE_C)
    vals = fused.decode_cells(p, eps, torch.from_numpy(TRANS),
                              torch.from_numpy(BOX),
                              torch.from_numpy(cells), cfg,
                              fine_r=K1_FINE_R, coarse_c=K1_COARSE_C)
    # in bf16 the rescued rows are JAX's XLA decode, which rounds the
    # logits to bf16 where the kernels keep f32: held where both are kernels
    rows = slice(None) if dtype == "float32" else ok
    for got, want in ((raw.numpy()[ok], np.asarray(raw_j)[:96 * 64][ok]),
                      (vals.numpy()[rows], np.asarray(vals_j)[rows])):
        scale = max(1e-3, float(np.abs(want).max()))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
        else:
            assert np.abs(got - want).max() <= 0.02 * scale
            assert np.abs(got - want).mean() <= 0.003 * scale


def test_binary_dense_sdf_through_k1_matches_jax():
    """The binary twostream head's exact dense route at 49^3 (every cell
    through K1, the planes per point) against the JAX package's XLA decode
    of the grid (its kernel is held to that in f32 by its own tests, and
    to the port's K1 above), at 1e-5 of the scale."""
    jcfg, cfg, jp, p, _, _ = _binary_k1("float32")
    img = _img(8)
    want = jdense.dense_sdf(jp, img, TRANS, BOX,
                            jcfg.replace(fused_kernel="off"))
    got = dense.dense_sdf(p, img, TRANS, BOX, cfg, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
