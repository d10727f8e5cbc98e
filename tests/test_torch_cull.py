"""The plain versions of K4 (the band cull: _band_tau, _active_cells) and
of the block compaction (_compact_block_bits) against disn_tpu's, float32
on the CPU at small grids (coarse rc 9-17, E 17-65), on inputs made with
numpy from a seed: tau, ids, counts, block rows and g_over. CPU tensors
take the plain versions and never reach the kernels' wrappers or their
launch counters (csrc/band_cull.cu, csrc/block_compact.cu run only on the
card: tests/test_torch_cull_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.infer import sparse as jsparse
from disn_tpu.ops import marching as jmarching
from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import sparse
from disn_tpu_torch.ops import band_cull, block_compact, marching
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SKEWED_BOX = np.array([-0.7, -1.1, -0.4, 0.9, 1.3, 0.8], np.float32)
SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32")
TAU = np.float32(0.2)


def grid(kind: str, rc: int, seed: int = 0) -> np.ndarray:
    """A seeded coarse grid [rc]^3 f32: a noisy sphere's distance, the same
    steepened 3x (the autocal's slope), nothing near the surface, every
    cell near it and changing sign, the sphere with corners exactly at
    +0.0 and -0.0, or the sphere with NaN and +-inf corners."""
    rng = np.random.RandomState(seed)
    lin = np.linspace(-1, 1, rc)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(x * x + y * y + z * z) - 0.55 + 0.03 * rng.randn(
        rc, rc, rc)
    if kind == "sphere":
        vol = sphere
    elif kind == "steep":
        vol = 3.0 * sphere
    elif kind == "none":
        vol = 1.0 + rng.rand(rc, rc, rc)
    elif kind == "all":  # a checkerboard: every cell changes sign
        i = np.arange(rc)
        parity = (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2
        vol = (1 - 2 * parity) * (0.05 * rng.rand(rc, rc, rc) + 0.01)
    elif kind == "zeros":
        vol = sphere.copy()
        vol[rng.rand(rc, rc, rc) < 0.1] = 0.0
        vol[rng.rand(rc, rc, rc) < 0.1] = -0.0
    elif kind == "nan":
        vol = sphere.copy()
        vol[rng.rand(rc, rc, rc) < 0.02] = np.nan
        vol[rng.rand(rc, rc, rc) < 0.01] = np.inf
        vol[rng.rand(rc, rc, rc) < 0.01] = -np.inf
    else:
        raise ValueError(kind)
    return vol.astype(np.float32)


@pytest.mark.parametrize("box", ["unit", "skewed"])
@pytest.mark.parametrize("kind", ["sphere", "steep", "all"])
@pytest.mark.parametrize("autocal,binary", [(True, False), (False, False),
                                            (True, True)])
def test_band_tau_matches_jax(kind, box, autocal, binary):
    """tau of the plain version against disn_tpu's _band_tau, with and
    without the observed-slope widening, and on a binary config (which
    never widens): to f32 summation order."""
    rc = 13 if box == "unit" else 17
    vol = grid(kind, rc)
    sp = BOX if box == "unit" else SKEWED_BOX
    kw = dict(SMALL, band_autocal=autocal, binary=binary)
    tau = sparse._band_tau(torch.from_numpy(vol), torch.from_numpy(sp), rc,
                           1.5, Config(**kw))
    jtau = jsparse._band_tau(jnp.asarray(vol), jnp.asarray(sp), rc, 1.5,
                             JConfig(**kw))
    assert tau.dtype == torch.float32 and tau.dim() == 0
    np.testing.assert_allclose(float(tau), float(jtau), rtol=1e-6)
    plain = sparse._band_tau_plain(torch.from_numpy(vol),
                                   torch.from_numpy(sp), rc, 1.5,
                                   Config(**kw))
    assert torch.equal(tau, plain)
    if kind == "steep" and autocal and not binary:
        flat = sparse._band_tau(torch.from_numpy(vol),
                                torch.from_numpy(sp), rc, 1.5,
                                Config(**dict(kw, band_autocal=False)))
        assert float(tau) > 2.0 * float(flat)  # the slope widened it


@pytest.mark.parametrize("kind", ["sphere", "none", "all", "zeros"])
@pytest.mark.parametrize("mode", ["band", "sign"])
@pytest.mark.parametrize("max_cells", [None, 4096, 40])
def test_active_cells_match_jax(kind, mode, max_cells):
    """The cull against disn_tpu's _active_cells on the same tau: the fixed
    form's ids with their padding and its 0-d count bit for bit (at 40 the
    cap drops ids while the count counts them), the exact form's ids the
    reference's first count; no cell, every cell, and corners at +-0.0."""
    rc = 17 if kind != "none" else 9
    c = rc - 1
    vol = grid(kind, rc, seed=1)
    tau = torch.tensor(TAU)
    jids, jcount = jsparse._active_cells(
        jnp.asarray(vol), jnp.asarray(TAU),
        c ** 3 if max_cells is None else max_cells, mode)
    ids, count = sparse._active_cells(torch.from_numpy(vol), tau, mode,
                                      max_cells)
    assert ids.dtype == torch.int32
    jn = int(jcount)
    expect = {"none": 0, "all": c ** 3}.get(kind)
    assert jn == expect if expect is not None else 0 < jn < c ** 3
    if max_cells is None:
        assert count == jn
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:jn])
    else:
        assert count.dtype == torch.int32 and count.dim() == 0
        assert int(count) == jn
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    if max_cells == 40 and jn > 40:
        assert ids.shape[0] == 40 and ids.numpy()[-1] > 0


def block_inputs(E: int, density: float, seed: int):
    """bits [B3^3, 2] int32, cand [B3^3] bool and an own-slot table [c^3]
    (slots of about half the coarse cells, -1 elsewhere), seeded: a block
    holds change bits with probability `density`, each of its 64 bits with
    probability 1/3; bits on cand-free blocks stay (they must be skipped)."""
    rng = np.random.RandomState(seed)
    b3 = -(-E // 4)
    nb = b3 ** 3
    words = np.where(rng.rand(nb, 64) < 1 / 3, 1, 0).astype(np.uint64)
    words *= (rng.rand(nb) < density)[:, None].astype(np.uint64)
    packed = (words << np.arange(64, dtype=np.uint64)).sum(1,
                                                           dtype=np.uint64)
    bits = packed.view(np.int32).reshape(nb, 2).copy()
    cand = rng.rand(nb) < 0.8
    c = b3 - 1
    own = np.full(c ** 3, -1, np.int32)
    live = rng.rand(c ** 3) < 0.5
    own[live] = np.arange(int(live.sum()), dtype=np.int32)
    return (torch.from_numpy(bits), torch.from_numpy(cand),
            torch.from_numpy(own))


def jax_compaction(bits, cand, E, bcap, srow, guard):
    b3 = -(-E // 4)
    return jmarching._compact_block_bits(
        jnp.asarray(bits.numpy()), jnp.asarray(cand.numpy()), bcap=bcap,
        E=E, S=4, B3=b3, guard=jnp.int32(guard),
        srow_tbl=None if srow is None else jnp.asarray(srow.numpy()))


@pytest.mark.parametrize("sparse_ids", [False, True])
@pytest.mark.parametrize("E,density,bcap", [
    (33, 0.5, 4096),    # every selected block kept
    (65, 0.3, 1024),    # 1,100-odd selected blocks past b2 = 512 rows
    (17, 0.0, 1024),    # no change bit at all
    (65, 0.04, 256),    # b2 = 512 rows, most of them padding
])
def test_compaction_matches_jax(sparse_ids, E, density, bcap):
    """The plain compaction against disn_tpu's, flat and sparse row ids:
    the capped form's ids, n, g_over (guard 3 + the blocks past b2) and
    rows bit for bit; the exact form's ids, n and rows those of the
    reference run with room for every block."""
    bits, cand, own = block_inputs(E, density, seed=E + int(100 * density))
    srow = own if sparse_ids else None
    guard = torch.tensor(3, dtype=torch.int32)
    got, n, g_over, blk = marching._compact_block_bits(
        bits, cand, E, srow_tbl=srow, bcap=bcap, guard=guard)
    want, jn, jg, jblk = jax_compaction(bits, cand, E, bcap, srow, 3)
    assert n.dtype == g_over.dtype == torch.int32
    assert int(n) == int(jn) and int(g_over) == int(jg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jblk))
    ids, n_exact, blk_exact = marching._compact_block_bits(bits, cand, E,
                                                           srow_tbl=srow)
    b3 = -(-E // 4)
    want, jn, _, jblk = jax_compaction(bits, cand, E, 2 * b3 ** 3, srow, 0)
    jblk = np.asarray(jblk)
    sel = (jblk[:, 1] != 0) | (jblk[:, 2] != 0)
    assert n_exact == int(jn) and ids.shape == (n_exact,)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want)[:n_exact])
    np.testing.assert_array_equal(blk_exact.numpy(), jblk[sel])
    over = int(g_over) - 3
    assert over == max(0, len(blk_exact) - marching._b2cap(bcap))
    assert (n_exact == 0) == (density == 0.0)
    if over == 0:
        assert int(n) == n_exact


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """Every dispatcher sends a CPU tensor to its plain version: the
    kernels' launch counters stay put and their wrappers are not called;
    the wrappers themselves refuse a CPU tensor."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU tensor reached a kernel's wrapper")

    counters = (band_cull.band_tau, band_cull.active_cells,
                block_compact.compact_block_bits)
    before = [f.launches for f in counters]
    wrappers = {name: getattr(mod, name) for mod, name in (
        (band_cull, "band_tau"), (band_cull, "active_cells"),
        (block_compact, "compact_block_bits"))}
    monkeypatch.setattr(band_cull, "band_tau", refuse)
    monkeypatch.setattr(band_cull, "active_cells", refuse)
    monkeypatch.setattr(block_compact, "compact_block_bits", refuse)
    vol = torch.from_numpy(grid("sphere", 13))
    tau = sparse._band_tau(vol, torch.from_numpy(BOX), 13, 1.5,
                           Config(**SMALL))
    for mode in ("band", "sign"):
        sparse._active_cells(vol, tau, mode)
        sparse._active_cells(vol, tau, mode, max_cells=100)
    bits, cand, own = block_inputs(33, 0.5, seed=1)
    marching._compact_block_bits(bits, cand, 33)
    marching._compact_block_bits(bits, cand, 33, srow_tbl=own, bcap=1024,
                                 guard=torch.tensor(0, dtype=torch.int32))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        wrappers["band_tau"](vol, torch.from_numpy(BOX), 13, 1.5, True)
    with pytest.raises(ValueError, match="CUDA"):
        wrappers["active_cells"](vol, tau)
    with pytest.raises(ValueError, match="CUDA"):
        wrappers["compact_block_bits"](bits, cand, 33)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("rc", [9, 17])
@pytest.mark.parametrize("kind", ["sphere", "zeros", "nan"])
@pytest.mark.parametrize("mode", ["band", "sign"])
@pytest.mark.parametrize("max_cells", [None, 40])
def test_band_cull_equals_the_pair_and_jax(rc, kind, mode, max_cells):
    """The fused entry's dispatcher on the CPU (_band_cull: tau, then the
    cull with it) against _band_tau then _active_cells, bit for bit, and
    against disn_tpu's _band_tau then _active_cells on that tau, in both
    modes and both forms, with corners at +-0.0 and at NaN and +-inf."""
    vol = grid(kind, rc, seed=rc)
    sp = torch.from_numpy(SKEWED_BOX)
    cfg = Config(**SMALL)
    tau, ids, count = sparse._band_cull(torch.from_numpy(vol), sp, rc, 1.5,
                                        cfg, mode, max_cells)
    tau2 = sparse._band_tau(torch.from_numpy(vol), sp, rc, 1.5, cfg)
    ids2, count2 = sparse._active_cells(torch.from_numpy(vol), tau2, mode,
                                        max_cells)
    assert torch.equal(tau.view(torch.int32), tau2.view(torch.int32))
    assert torch.equal(ids, ids2)
    if max_cells is None:
        assert count == count2
    else:
        assert torch.equal(count, count2)
    jtau = jsparse._band_tau(jnp.asarray(vol), jnp.asarray(SKEWED_BOX), rc,
                             1.5, JConfig(**SMALL))
    np.testing.assert_allclose(float(tau), float(jtau), rtol=1e-6)
    c = rc - 1
    jids, jcount = jsparse._active_cells(
        jnp.asarray(vol), jnp.asarray(tau.numpy()),
        c ** 3 if max_cells is None else max_cells, mode)
    jn = int(jcount)
    assert int(count) == jn
    if max_cells is None:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:jn])
    else:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("ctas", [8, 16])
@pytest.mark.parametrize("rc", [2, 3, 9, 17, 33, 65, 129, 257, 1290])
def test_cull_plan_walks_every_plane_once_in_order(rc, ctas):
    """K4's split of the c = rc - 1 cell planes: each round gives every CTA
    one slab of at most ZMAX planes; the slabs, in the kernel's order
    (round, then CTA), cover [0, c) once, contiguous and ascending, so the
    ids come out in row-major order; the main path's 65^3 grid takes one
    round."""
    c = rc - 1
    zr = band_cull.cull_plan(rc, ctas)
    assert 1 <= zr <= band_cull.ZMAX
    slabs = band_cull.cull_slabs(rc, ctas)
    assert len(slabs) % ctas == 0
    assert [j for _, j, _, _ in slabs] == list(range(ctas)) * (
        len(slabs) // ctas)
    end = 0
    for _, _, z0, z1 in slabs:
        assert z0 == end and z0 <= z1 <= z0 + zr
        end = z1
    assert end == c
    assert slabs[-ctas][2] < c  # the last round holds a plane
    if rc == 65:
        assert len(slabs) == ctas


@pytest.mark.parametrize("ctas", [8, 16])
@pytest.mark.parametrize("E", [1, 5, 17, 65, 257, 513, 1285])
def test_compact_plan_owns_every_chunk_once_in_order(E, ctas):
    """K2c's split of the B3^3 block rows: 128-row chunks covering every
    row, units of `group` consecutive chunks dealt to the CTAs in turn
    (CTA j the units j, j + ctas, ...), at most MAX_UNITS a CTA, every
    chunk in exactly one unit; read in global unit order the units run
    through the chunks in row-major order."""
    nb = (-(-E // 4)) ** 3
    chunks, group = block_compact.compact_plan(nb, ctas)
    assert chunks * block_compact.CHUNK_ROWS >= nb > (
        chunks - 1) * block_compact.CHUNK_ROWS
    dealt = block_compact.compact_units(nb, ctas)
    assert len(dealt) == ctas
    assert all(len(units) <= block_compact.MAX_UNITS for units in dealt)
    by_unit = sorted((u * ctas + j, run) for j, units in enumerate(dealt)
                     for u, run in enumerate(units))
    assert [k for k, _ in by_unit] == list(range(len(by_unit)))
    end = 0
    for _, (c0, c1) in by_unit:
        assert c0 == end and c0 < c1 <= c0 + group
        end = c1
    assert end == chunks
    if E == 257:
        assert group == 1


def test_cpu_tensors_take_the_plain_band_cull(monkeypatch):
    """_band_cull sends a CPU grid to _band_cull_plain: the fused entry is
    not called and its counter stays put; the entry refuses a CPU grid."""
    def refuse(*args, **kw):
        raise AssertionError("a CPU tensor reached the kernel's wrapper")

    entry = band_cull.band_cull
    before = entry.launches
    monkeypatch.setattr(band_cull, "band_cull", refuse)
    vol = torch.from_numpy(grid("sphere", 13))
    for mode in ("band", "sign"):
        for max_cells in (None, 100):
            sparse._band_cull(vol, torch.from_numpy(BOX), 13, 1.5,
                              Config(**SMALL), mode, max_cells)
    assert entry.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        entry(vol, torch.from_numpy(BOX), 13, 1.5, True)
    assert entry.launches == before
