"""The volume flow's speculative dispatch (sparse_words=False, and every
(cfg, iso) the words flow pins to it) against disn_tpu's functions and
against the port's own synchronous flow (_SPEC_CACHE cleared), float32 on
the CPU: the fixed-shape owned extractor, the fixed candidate scan, the
fixed phase_b_mesh with and without the boundary planes, image_to_mesh
ending in every kind of the volume arm of _spec_resolve, a hit against
the JAX image_to_mesh, a non-K1 arm and a words-flow pin. K1 runs as its
plain version; the heads are tests/test_torch_speculative.py's analytic
octahedron at width 0.125. The JAX references run at sdf_res 32 (and 44
with fused_kernel 'off'), where its decode is plain XLA, each once a
module."""
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
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import dense, pipeline, sparse
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import marching
from torch_threads import few_threads  # noqa: F401  (autouse)

SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32",
             cell_cap_frac=0.9, sparse_words=False)
# the head's radius on each grid: at sdf_res 44 the band of r = 0.1 (305
# active cells; a cap of 332, so one block of 332) keeps off the +
# boundary layer (no planes); at sdf_res 32 the 8^3 coarse cells put 72
# of r = 0.25's 352 active cells there; at sdf_res 48 (the words flow's
# least grid) r = 0.15 puts 12 of 448 there
NO_PLANES = dict(SMALL, sdf_res=44, cell_cap_frac=0.25)
PLANES = dict(SMALL, sdf_res=32)
R_HEAD = {44: 0.1, 32: 0.25, 48: 0.15}
BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
TRANS = jsynthetic.demo_trans_mat()
# the world coordinates: the JAX package's lo + g / (R-1) * span and the
# port's IEEE divide by a device scalar round alike but for the order of
# the lerp's terms (test_torch_marching's owned-route bound)
VERT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each test starts with no prediction and no pinned (cfg, iso)."""
    monkeypatch.setattr(pipeline, "_SPEC_CACHE", {})
    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())


@functools.lru_cache(maxsize=None)
def _params(sdf_res):
    """(disn_tpu's, the port's) params of the head of radius
    R_HEAD[sdf_res]."""
    jp = jsynthetic.analytic_octahedron_params(JConfig(**NO_PLANES),
                                               r=R_HEAD[sdf_res])
    return jp, convert.params_from_jax(jax.device_get(jp))


def _img(seed=1):
    return np.random.RandomState(seed).rand(137, 137, 3).astype(np.float32)


# -- the fixed owned extractor and the fixed scan ---------------------------

@functools.lru_cache(maxsize=None)
def _field(kind):
    """A 33^3 field (z, y, x) and its exact scan's ids: a sphere inside the
    box, or one the box cuts (its surface reaches the + faces, so the
    ghost cells own crossings and the alias rule is exercised)."""
    lin = np.linspace(-1, 1, 33, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    c, r = {"inside": ((0.1, -0.05, 0.0), 0.6),
            "cut": ((0.5, 0.45, 0.55), 0.9)}[kind]
    vol = (np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
           - r).astype(np.float32)
    ids, n = marching._active_cells_ext(torch.from_numpy(vol), 0.0)
    return vol, ids, n


@functools.lru_cache(maxsize=None)
def _jax_extract(kind, pad, n_iter, batch):
    vol, ids, n = _field(kind)
    buf = np.zeros(pad, np.int32)
    buf[:n] = ids.numpy()
    out = jmarching._extract_owned(jnp.asarray(vol), jnp.asarray(BOX),
                                   jnp.asarray(buf), jnp.int32(n), iso=0.0,
                                   n_iter=n_iter, batch=batch)
    return buf, tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("kind,batch", [("inside", 512), ("cut", 1024)])
def test_fixed_extractor_matches_jax_and_the_exact_one(kind, batch):
    """_extract_owned_fixed against disn_tpu's _extract_owned on the same
    padded ids, n_cells, n_iter and batch (the slots cover the cells):
    counts equal, faces equal with their zero padding, vertices within
    VERT_ATOL; and against the port's exact _extract_owned on ids[:n],
    bit for bit on the first nv / ntri rows, no owner missing."""
    vol, ids, n = _field(kind)
    n_iter = -(-n // batch)
    pad = n_iter * batch + batch
    buf, (jv, jnv, jf, jntri) = _jax_extract(kind, pad, n_iter, batch)
    verts, nv, faces, ntri, missing = marching._extract_owned_fixed(
        torch.from_numpy(vol), torch.from_numpy(BOX), torch.from_numpy(buf),
        torch.tensor(n, dtype=torch.int32), 0.0, n_iter, batch)
    assert int(nv) == int(jnv) > 100 and int(ntri) == int(jntri) > 100
    assert int(missing) == 0
    assert verts.shape == jv.shape and faces.shape == jf.shape
    np.testing.assert_array_equal(faces.numpy(), jf)
    np.testing.assert_allclose(verts.numpy(), jv, atol=VERT_ATOL, rtol=0)
    ev, ef = marching._extract_owned(torch.from_numpy(vol),
                                     torch.from_numpy(BOX), ids, 0.0)
    assert torch.equal(verts[:int(nv)], ev) and torch.equal(
        faces[:int(ntri)], ef)
    assert not verts[int(nv):].any() and not faces[int(ntri):].any()


def test_fixed_extractor_short_slots_flag_missing_owners():
    """Slots that cover only part of the cells: the counts are those of
    the covered slots, and the triangles whose owner lies past them are
    counted in `missing` (the exact function raises on such a list)."""
    vol, ids, n = _field("inside")
    buf = np.zeros(4 * 512, np.int32)
    buf[:n] = ids.numpy()
    *_, missing = marching._extract_owned_fixed(
        torch.from_numpy(vol), torch.from_numpy(BOX), torch.from_numpy(buf),
        torch.tensor(n, dtype=torch.int32), 0.0, 1, 256)
    assert n > 256 and int(missing) > 0
    with pytest.raises(ValueError, match="active-cell list"):
        marching._extract_owned(torch.from_numpy(vol), torch.from_numpy(BOX),
                                ids[:256], 0.0)


def _coarse_ids(vol, pad):
    """The coarse cells (of the 8^3 grid of the 33^3 field) with a corner
    within 0.3 of the surface, padded with 0 to `pad`, and their count."""
    c = (vol.shape[0] - 1) // 4
    vc = vol[::4, ::4, ::4]
    corners = np.stack([vc[dz:dz + c, dy:dy + c, dx:dx + c]
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
    act = (np.abs(corners).min(0) < 0.3) | ((corners < 0).any(0)
                                            & (corners >= 0).any(0))
    ids = np.flatnonzero(act.reshape(-1)).astype(np.int32)
    buf = np.zeros(pad, np.int32)
    buf[:len(ids)] = ids
    return buf, len(ids)


@pytest.mark.parametrize("case", ["fits", "overflow", "blind"])
def test_fixed_scan_matches_jax(case):
    """_active_cells_from_coarse(count=, bcap=) against disn_tpu's with
    coarse_count and bcap on the same padded coarse ids: ids, n, g_over
    and blk bit for bit. "fits": the sphere's band, gov and guard 0, and
    ids[:n] and the masked rows are the exact scan's; "overflow": a seeded
    random field with every coarse cell a candidate, whose 729 blocks
    with a change overflow the 512 rows (gov > 0, guard 0); "blind": the
    sphere with a count of 0, no candidate block (guard = gov = every
    change cell)."""
    vol, _, _ = _field("inside")
    buf, count = _coarse_ids(vol, 600)
    if case == "overflow":
        vol = np.random.RandomState(4).randn(33, 33, 33).astype(np.float32)
        buf[:512] = np.arange(512)
        count = 512
    if case == "blind":
        count = 0
    bcap = 1024
    got = marching._active_cells_from_coarse(
        torch.from_numpy(vol), torch.from_numpy(buf), 0.0,
        count=torch.tensor(count, dtype=torch.int32), bcap=bcap)
    ids, n, guard, gov, blk = (t.numpy() for t in got)
    jids, jn, jover, jblk = (np.asarray(a) for a in
                             jmarching._active_cells_from_coarse(
                                 jnp.asarray(vol), jnp.asarray(buf),
                                 jnp.int32(count), iso=0.0, stride=4,
                                 bcap=bcap))
    assert int(n) == int(jn) and int(gov) == int(jover)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(blk, jblk)
    total = int(marching._sign_change_cells(torch.from_numpy(vol),
                                            0.0).sum())
    assert (int(gov) > 0) == (case != "fits")
    assert int(guard) == (total if case == "blind" else 0)
    if case == "fits":
        eids, en, eguard, eblk = marching._active_cells_from_coarse(
            torch.from_numpy(vol), torch.from_numpy(buf[:count]), 0.0)
        assert en == int(n) > 500 and eguard == 0
        np.testing.assert_array_equal(ids[:en], eids.numpy())
        np.testing.assert_array_equal(blk[:len(eblk)], eblk.numpy())


# -- the fixed phase_b_mesh -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pbm(planes):
    """disn_tpu's phase_a, then _phase_b_mesh_jit at the bucket its count
    needs: (count, padded ids, (vol, ids, n, g_over, blk), n_blocks,
    bcap)."""
    kw = PLANES if planes else dict(NO_PLANES, fused_kernel="off")
    jcfg = JConfig(**kw)
    jp = _params(kw["sdf_res"])[0]
    args = (jcfg, 4, pipeline.SPEC_BLOCK, jcfg.cell_cap_frac,
            jcfg.band_factor)
    sizes = jsparse._sparse_parts(*args)[0]
    img = jnp.asarray(_img()[None])
    trans, box = jnp.asarray(TRANS), jnp.asarray(BOX)
    emb, eps, vol_c, cell_ids, count, _ = jsparse._phase_a_jit(*args)(
        jp, img, trans, box)
    nb = jpipeline._needed_blocks(int(count), sizes)
    bcap = jpipeline._fused_bcap(nb, sizes)
    out = jsparse._phase_b_mesh_jit(*args, nb, 0.0, bcap)(
        jp, emb, eps, vol_c, cell_ids, count, trans, box)
    vol, _, ids, n, g_over, blk = (np.asarray(a) for a in out)
    return (int(count), np.asarray(cell_ids), (vol, ids, n, g_over, blk),
            nb, bcap)


@pytest.mark.parametrize("planes", [True, False])
def test_fixed_phase_b_mesh_matches_jax(planes):
    """phase_b_mesh(count=, n_kcells=, bcap=, planes=) on the JAX phase_a's
    padded ids and count against disn_tpu's _phase_b_mesh_jit at the same
    block bucket and bcap: the volume within the f32 tolerance of
    tests/test_torch_pipeline.py's sparse volumes, the scan (ids, n,
    g_over, blk) bit for bit, the boundary count deciding the planes as
    the JAX cond does. With planes (sdf_res 32: K1's plain version on the
    port's side, the plain decode on JAX's) and without (sdf_res 44,
    fused_kernel 'off': the plain decode on both). The port's own exact
    form on the first count ids gives the fixed form's volume bit for
    bit."""
    kw = PLANES if planes else dict(NO_PLANES, fused_kernel="off")
    cfg = Config(**kw)
    count, jids, (jvol, jscan_ids, jn, jover, jblk), nb, bcap = _jax_pbm(
        planes)
    p = _params(kw["sdf_res"])[1]
    cpu = torch.device("cpu")
    img_t, trans, sdfp = dense.as_inputs(_img(), TRANS, BOX, cpu)
    emb, eps, vol_c, _, _ = sparse.phase_a(p, img_t, trans, sdfp, cfg)
    ids = torch.from_numpy(jids.copy())
    sizes = pipeline._spec_sizes(cfg)
    assert pipeline._fused_bcap(nb, sizes) == bcap
    vol, sids, n, guard, gov, blk, n_bd = sparse.phase_b_mesh(
        p, eps, vol_c, ids, trans, sdfp, cfg, 0.0, embedding=emb,
        count=torch.tensor(count, dtype=torch.int32),
        n_kcells=nb * sizes["cells_per_block"], bcap=bcap, planes=planes)
    assert (int(n_bd) > 0) == planes
    scale = np.abs(jvol).max()
    np.testing.assert_allclose(vol.numpy(), jvol, rtol=1e-5,
                               atol=1e-5 * scale)
    assert int(n) == int(jn) > 50 and int(gov) == int(jover) == 0
    assert int(guard) == 0
    np.testing.assert_array_equal(sids.numpy(), jscan_ids)
    np.testing.assert_array_equal(blk.numpy(), jblk)
    evol = sparse.finish(p, eps, vol_c, ids[:count], trans, sdfp, cfg,
                         embedding=emb)
    assert torch.equal(vol, evol)


# -- image_to_mesh on every kind --------------------------------------------

@functools.lru_cache(maxsize=None)
def _seed_run(kw_items):
    """The synchronous flow (no prediction) on _img(): (mesh, stats, the
    volume flow's prediction it seeded)."""
    kw = dict(kw_items)
    cfg = Config(**kw)
    saved, pinned = pipeline._SPEC_CACHE, pipeline._SWORDS_SKIP
    pipeline._SPEC_CACHE, pipeline._SWORDS_SKIP = {}, set()
    try:
        stats: dict = {}
        mesh = pipeline.image_to_mesh(_params(kw["sdf_res"])[1], _img(),
                                      TRANS, cfg, device="cpu", stats=stats)
        return mesh, stats, pipeline._SPEC_CACHE.get(pipeline._vkey(cfg,
                                                                    0.0))
    finally:
        pipeline._SPEC_CACHE, pipeline._SWORDS_SKIP = saved, pinned


KINDS = {  # case: (kind, config, route of the mesh)
    "hit": ("hit", NO_PLANES, "owned_ids"),
    "blocks": ("blocks", NO_PLANES, "owned_ids"),
    "planes missed": ("planes", PLANES, "owned_ids"),
    "planes extra": ("planes", NO_PLANES, "owned_ids"),
    "guard": ("guard", NO_PLANES, "owned_scan"),
    "overflow": ("overflow", NO_PLANES, "owned_ids"),
    "extract slots": ("extract", NO_PLANES, "owned_ids"),
    "extract rows": ("extract", NO_PLANES, "owned_ids"),
    "cap": ("cap", dict(PLANES, cell_cap_frac=0.05), "tets"),
}


@pytest.mark.parametrize("case", list(KINDS))
def test_volume_route_equals_the_seed_path(case, monkeypatch):
    """image_to_mesh on the volume flow with a prediction in _SPEC_CACHE
    ends in the case's kind and gives the synchronous flow's verts and
    faces bit for bit and the same stats keys: the seed's own prediction
    (hit; tests below hit with the planes); at 256 cells a block, a block
    bucket of 1, under the 2 the 305 active cells need (blocks); the plane
    bit flipped either way (planes); a scan told of no active coarse cell,
    as tests/test_torch_pipeline.py's guard test does (guard: the full
    scan, route owned_scan); a compaction of 4 rows under the 7 blocks
    with a change (overflow: the exact scan); 1 slot batch of 16 (2 after
    the bucket: 32 slots) under the scan's 80 cells, or a vertex
    prediction of 1 (extract: the exact extractor); at sdf_res 32, a cell
    cap of 256 under the 352 active cells (cap: the dense route).
    Afterwards the prediction has the image's plane bit and covers its
    block bucket."""
    kind, kw, route = KINDS[case]
    cfg = Config(**kw)
    key = pipeline._vkey(cfg, 0.0)
    (want_v, want_f), want_stats, seeded = _seed_run(tuple(kw.items()))
    if kind == "cap":  # its seed path takes the dense route: no prediction
        seeded = _seed_run(tuple(PLANES.items()))[2]
    nb, ni, nv, _, nvc, ntri, planes = seeded
    pred = {"blocks": (1, ni, nv, 0, nvc, ntri, planes),
            "planes": (nb, ni, nv, 0, nvc, ntri, not planes),
            "extract rows": (nb, ni, 1, 0, nvc, ntri, planes),
            "cap": (pipeline._spec_sizes(cfg)["max_blocks"], ni, nv, 0, nvc,
                    ntri, planes)}
    pipeline._SPEC_CACHE[key] = pred.get(case, pred.get(kind, seeded))
    if case == "extract slots":
        pipeline._SPEC_CACHE[key] = (nb, 1, nv, 0, nvc, ntri, planes)
        monkeypatch.setattr(pipeline, "SPEC_BATCH", 16)
    if kind == "blocks":  # 256 cells a block: the 305 active cells need 2
        real_sizes = pipeline._spec_sizes
        monkeypatch.setattr(pipeline, "_spec_sizes", lambda c: dict(
            real_sizes(c), cells_per_block=256,
            max_blocks=-(-real_sizes(c)["cell_cap"] // 256)))
    if kind == "overflow":
        monkeypatch.setattr(marching, "_b2cap", lambda bcap: 4)
    if kind == "guard":
        real_scan = marching._active_cells_from_coarse

        def blind_scan(vol, coarse_ids, iso, stride, count=None, bcap=None):
            if count is None:
                return real_scan(vol, coarse_ids[:0], iso, stride=stride)
            return real_scan(vol, coarse_ids, iso, stride=stride,
                             count=count * 0, bcap=bcap)

        monkeypatch.setattr(marching, "_active_cells_from_coarse",
                            blind_scan)
    stats: dict = {}
    v, f = pipeline.image_to_mesh(_params(kw["sdf_res"])[1], _img(), TRANS,
                                  cfg, device="cpu", stats=stats)
    assert stats["spec"] == kind and want_stats["spec"] == "seed"
    assert stats["route"] == route
    assert set(stats) == set(want_stats)
    if kind == "cap":
        assert stats["dense_fallback"] and want_stats["route"] == "tets"
    else:
        assert want_stats["route"] == "owned_ids"
        assert stats["guard"] > 0 if kind == "guard" else stats["guard"] == 0
    assert len(f) > 300
    np.testing.assert_array_equal(f, want_f)
    np.testing.assert_array_equal(v, want_v)
    after = pipeline._SPEC_CACHE[key]
    if kind != "cap":
        assert after[0] >= nb and after[6] == planes
    if kind == "hit":
        assert after == seeded


# -- against the JAX package, another arm, a words-flow pin ----------------

def test_volume_hit_matches_jax_image_to_mesh():
    """A hit against disn_tpu's image_to_mesh(sparse_words=False) on the
    same params at sdf_res 32 (its record route: faces in the same order,
    vertices u16-quantised): faces equal, vertices within
    tests/test_torch_speculative.py's 2e-5; the seed and the hit equal bit
    for bit, both with the boundary planes."""
    jp, p = _params(32)
    cfg, jcfg = Config(**PLANES), JConfig(**PLANES)
    jpipeline._SWORDS_SKIP.clear()
    jpipeline._SPEC_CACHE.clear()
    jv, jf = jpipeline.image_to_mesh(jp, _img(), TRANS, jcfg)
    meshes, kinds = [], []
    for _ in range(2):
        stats: dict = {}
        meshes.append(pipeline.image_to_mesh(p, _img(), TRANS, cfg,
                                             device="cpu", stats=stats))
        kinds.append(stats["spec"])
    assert kinds == ["seed", "hit"] and stats["route"] == "owned_ids"
    assert pipeline._SPEC_CACHE[pipeline._vkey(cfg, 0.0)][6] is True
    v, f = meshes[1]
    np.testing.assert_array_equal(f, meshes[0][1])
    np.testing.assert_array_equal(v, meshes[0][0])
    assert len(f) > 500 and len(v) == len(jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2e-5, rtol=0)


def test_global_arm_seeded_then_hit():
    """The global head (plain decode, no K1) with the analytic octahedron
    in its stream, at sdf_res 32: seeded, then a hit, bit for bit."""
    cfg = Config(**dict(PLANES, variant=Variant.GLOBAL))
    src = synthetic.analytic_octahedron_params(
        cfg.replace(variant=Variant.TWOSTREAM), r=R_HEAD[32], device="cpu")
    p = disn.init(cfg, seed=0, device="cpu")
    p["sdfprediction"] = src["sdfprediction"]
    meshes, kinds = [], []
    for _ in range(2):
        stats: dict = {}
        meshes.append(pipeline.image_to_mesh(p, _img(), TRANS, cfg,
                                             device="cpu", stats=stats))
        kinds.append(stats["spec"])
    assert kinds == ["seed", "hit"] and len(meshes[0][1]) > 500
    np.testing.assert_array_equal(meshes[1][1], meshes[0][1])
    np.testing.assert_array_equal(meshes[1][0], meshes[0][0])


def test_words_guard_pins_then_volume_hit():
    """sdf_res 48, r 0.15: the band's active cells reach the + boundary,
    so the words flow's guard trips, pins (cfg, iso) and runs the volume
    flow, which seeds the volume prediction with the planes; the next
    image is a volume-flow hit with the planes, equal to
    sparse_words=False's seed path bit for bit."""
    cfg = Config(**dict(SMALL, sdf_res=48, sparse_words=True))
    p = _params(48)[1]
    kinds = []
    for seed in (1, 2):
        stats: dict = {}
        v, f = pipeline.image_to_mesh(p, _img(seed), TRANS, cfg,
                                      device="cpu", stats=stats)
        kinds.append(stats["spec"])
    assert kinds == ["seed", "hit"] and (cfg, 0.0) in pipeline._SWORDS_SKIP
    assert "swords_guard" not in stats and stats["route"] == "owned_ids"
    assert pipeline._SPEC_CACHE[pipeline._vkey(cfg, 0.0)][6] is True
    pipeline._SPEC_CACHE.clear()
    want = pipeline.image_to_mesh(p, _img(2), TRANS,
                                  cfg.replace(sparse_words=False),
                                  device="cpu")
    assert len(f) > 500
    np.testing.assert_array_equal(f, want[1])
    np.testing.assert_array_equal(v, want[0])
