"""The candidate scan (K2s) and the owned-edge extractor (K7) on the CPU:
ops/marching sends CPU tensors to their plain versions and the kernels'
wrappers refuse them; the plain scan's bits, candidate flags and counts
against disn_tpu's _sign_change_cells and the candidate rule of its
_active_cells_from_coarse; the exact and the fixed extractor against each
other and against disn_tpu's _extract_owned, on the same numpy-seeded
volumes at small grids (<= 65^3); the extractor's owner look-up through
the scan's block rows (the kernel's rows route) against the dense table
and against disn_tpu, on the exact and fixed coarse scans' lists (the
fixed form's capped rows ending in zero rows), the full scan's, lists cut
to fewer slots than cells, ragged grids and a list whose first row is
block 0. Integer outputs (bits, counts, faces) must be equal; vertices
agree to atol 1e-6 (f32 interpolation on a box of size 2; the two
packages round the lerp's terms in another order), and bit for bit
between the port's forms and look-ups."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disn_tpu.ops import marching as jm
from disn_tpu_torch.ops import change_scan, owned_extract
from disn_tpu_torch.ops import marching as m
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SKEW_BOX = np.array([-0.7, -1.1, -0.4, 0.9, 1.3, 0.8], np.float32)
VERT_ATOL = 1e-6
# (field, R, iso): inside the box, cut by the + faces (ghost cells),
# smooth noise, a ragged grid (R % 4 != 1), exact dyadic values
CASES = [("sphere", 33, 0.0), ("sphere", 49, 0.07), ("cut", 33, 0.0),
         ("cut", 65, 0.0), ("noise", 29, 0.0), ("sphere", 30, 0.0),
         ("dyadic", 33, 0.25)]


@functools.lru_cache(maxsize=None)
def field(name: str, R: int) -> np.ndarray:
    lin = np.linspace(-1, 1, R)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(x * x + y * y + z * z) - 0.6
    if name == "sphere":
        v = sphere
    elif name == "cut":
        v = np.sqrt((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) - 0.9
    elif name == "noise":
        v = np.random.RandomState(5).randn(R, R, R)
        for ax in range(3):
            v = (v + np.roll(v, 1, ax) + np.roll(v, -1, ax)) / 3
    elif name == "dyadic":  # multiples of 1/8: every value exact in f32
        v = np.round(sphere * 8) / 8 + 0.25
    elif name == "corner":  # a surface in the grid's first block
        v = np.sqrt((x + 1) ** 2 + (y + 1) ** 2 + (z + 1) ** 2) - 0.3
    else:
        raise KeyError(name)
    return np.ascontiguousarray(v, np.float32)


def coarse_cells(vol: np.ndarray, iso: float) -> np.ndarray:
    """Coarse cells (stride 4) with a corner within 0.3 of the iso or
    corners of both signs, int32."""
    c = (vol.shape[0] - 1) // 4
    vc = vol[::4, ::4, ::4][:c + 1, :c + 1, :c + 1] - iso
    corners = np.stack([vc[dz:dz + c, dy:dy + c, dx:dx + c]
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
    act = (np.abs(corners).min(0) < 0.3) | ((corners < 0).any(0)
                                            & (corners >= 0).any(0))
    return np.flatnonzero(act.reshape(-1)).astype(np.int32)


def pack_blocks(change: np.ndarray) -> np.ndarray:
    """[E,E,E] bool -> [B3^3, 2] int32 (lo, hi): bit (z*4 + y)*4 + x of a
    block, the blocks in (z, y, x) order."""
    E = change.shape[0]
    B3 = -(-E // 4)
    ch = np.zeros((B3 * 4,) * 3, bool)
    ch[:E, :E, :E] = change
    blocks = ch.reshape(B3, 4, B3, 4, B3, 4).transpose(0, 2, 4, 1, 3, 5)
    bits = blocks.reshape(B3 ** 3, 64).astype(np.uint64)
    words = (bits << np.arange(64, dtype=np.uint64)).sum(1, dtype=np.uint64)
    return words.view(np.int32).reshape(-1, 2)


def candidate_blocks(cells: np.ndarray, count: int, R: int) -> np.ndarray:
    """The JAX rule: the first `count` coarse cells flagged, edge-padded
    by one block on each axis -> [B3^3] bool."""
    c = (R - 1) // 4
    act = np.zeros(c ** 3, bool)
    act[cells[:count]] = True
    return np.pad(act.reshape(c, c, c), ((0, 1),) * 3,
                  mode="edge").reshape(-1)


@pytest.mark.parametrize("name,R,iso", CASES)
def test_scan_matches_jax(name, R, iso):
    """The full scan's bits are disn_tpu's _sign_change_cells packed by
    block; the coarse scan's flags are its candidate rule, exact and fixed
    (a padded list, a 0-d count); total is its sum of the change cells,
    inside the change bits in candidate blocks, outside the rest."""
    vol = field(name, R)
    change = np.asarray(jm._sign_change_cells(jnp.asarray(vol), iso))
    want_bits = pack_blocks(change)
    total = int(change.sum())
    bits, cand, counts = m._candidate_scan(torch.from_numpy(vol), iso)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    assert cand.all() and counts.tolist() == [total, total, 0]
    cells = coarse_cells(vol, iso)
    pop = np.array([bin(int(w)).count("1") for w in
                    want_bits.view(np.uint64).reshape(-1)], np.int64)
    padded = np.zeros(len(cells) + 50, np.int32)
    padded[:len(cells)] = cells
    for ids, count in ((cells, None), (padded, len(cells)),
                       (padded, len(cells) // 3), (padded, 0)):
        n = len(ids) if count is None else count
        want_cand = candidate_blocks(ids, n, R)
        inside = int((pop * want_cand).sum())
        got = m._candidate_scan(
            torch.from_numpy(vol), iso, torch.from_numpy(ids),
            None if count is None else torch.tensor(count, dtype=torch.int32))
        np.testing.assert_array_equal(got[0].numpy(), want_bits)
        np.testing.assert_array_equal(got[1].numpy(), want_cand)
        assert got[2].dtype == torch.int32
        assert got[2].tolist() == [total, inside, total - inside]


@pytest.mark.parametrize("name,R,iso", CASES)
@pytest.mark.parametrize("box", ["unit", "skewed"])
def test_extractors_match_each_other_and_jax(name, R, iso, box):
    """The exact _extract_owned equals _extract_owned_fixed at S = n on
    its leading rows, bit for bit, with no owner missing; both equal
    disn_tpu's _extract_owned on the same ids: counts and faces exactly,
    vertices within VERT_ATOL (exactly where the field and the box are
    dyadic)."""
    vol = field(name, R)
    sp = BOX if box == "unit" else SKEW_BOX
    ids, n = m._active_cells_ext(torch.from_numpy(vol), iso)
    assert n > 0
    volt, spt = torch.from_numpy(vol), torch.from_numpy(sp)
    ev, ef = m._extract_owned(volt, spt, ids, iso)
    verts, nv, faces, ntri, missing = m._extract_owned_fixed(
        volt, spt, ids, torch.tensor(n, dtype=torch.int32), iso, n, 1)
    assert int(missing) == 0 and (int(nv), int(ntri)) == (len(ev), len(ef))
    assert torch.equal(verts[:int(nv)], ev) and torch.equal(
        faces[:int(ntri)], ef)
    # the same through the full scan's rows (the kernel's rows route)
    rids, rn, blk = m._active_cells_ext_rows(volt, iso)
    assert rn == n and torch.equal(rids, ids)
    rv, rf = m._extract_owned(volt, spt, ids, iso, blk)
    assert torch.equal(rv, ev) and torch.equal(rf, ef)
    rfixed = m._extract_owned_fixed(
        volt, spt, ids, torch.tensor(n, dtype=torch.int32), iso, n, 1, blk)
    assert all(torch.equal(a, b) for a, b in zip(
        rfixed, (verts, nv, faces, ntri, missing)))
    jv, jnv, jf, jntri = (np.asarray(a) for a in jm._extract_owned(
        jnp.asarray(vol), jnp.asarray(sp), jnp.asarray(ids.numpy()),
        jnp.int32(n), iso=iso, n_iter=1, batch=n))
    assert (int(jnv), int(jntri)) == (int(nv), int(ntri))
    np.testing.assert_array_equal(faces.numpy(), jf)
    np.testing.assert_allclose(verts.numpy(), jv, atol=VERT_ATOL, rtol=0)
    if name == "dyadic" and box == "unit":
        np.testing.assert_array_equal(verts.numpy(), jv)


# (list, field, R, iso): the lists and rows the owned extractor is handed.
# The coarse scan's exact and fixed forms (capped: zero rows past its
# blocks) and the fixed form's list cut to half its cells, on every case
# whose grid the coarse pass takes (R - 1 a multiple of 4); the full scan
# and the fixed coarse scan of a surface in the grid's first block (the
# first row is block 0), and the full scan of it on a ragged grid.
ROW_CASES = [(form, name, R, iso)
             for form in ("coarse exact", "coarse fixed", "cut")
             for name, R, iso in CASES if (R - 1) % 4 == 0] + [
    ("full", "corner", 33, 0.0), ("coarse fixed", "corner", 33, 0.0),
    ("full", "corner", 30, 0.0)]


@pytest.mark.parametrize("form,name,R,iso", ROW_CASES)
def test_block_lookup_matches_dense_and_jax(form, name, R, iso):
    """The plain extractors with the owners looked up through the scan's
    rows (_block_owner, the kernel's rows route: a block's row, the rows'
    popcount prefix, the popcount below the bit) equal them with the dense
    [R^3] table (_dense_owner) bit for bit, missing owners included, and
    equal disn_tpu's _extract_owned on the same ids and slots: counts and
    faces exactly (on a cut list, but for the missing owners' corners),
    vertices within VERT_ATOL."""
    vol = field(name, R)
    volt, spt = torch.from_numpy(vol), torch.from_numpy(SKEW_BOX)
    if form == "full":
        ids, n, blk = m._active_cells_ext_rows(volt, iso)
    elif form == "coarse exact":
        ids, n, guard, blk = m._active_cells_from_coarse(
            volt, torch.from_numpy(coarse_cells(vol, iso)), iso)
        assert guard == 0
    else:
        cells = coarse_cells(vol, iso)
        padded = np.zeros(len(cells) + 50, np.int32)
        padded[:len(cells)] = cells
        ids, n_t, guard, gov, blk = m._active_cells_from_coarse(
            volt, torch.from_numpy(padded), iso,
            count=torch.tensor(len(cells), dtype=torch.int32),
            bcap=4 * len(cells) + 1024)
        n = int(n_t)
        assert int(guard) == 0 and int(gov) == 0
        assert not blk[-1].any()  # the capped rows end in zero rows
    if name == "corner":
        assert int(blk[0, 0]) == 0 and blk[0, 1:].any()
    assert n > 0
    S = n // 2 if form == "cut" else n
    if form in ("full", "coarse exact"):
        got = m._extract_owned_plain(volt, spt, ids[:n], iso, blk)
        want = m._extract_owned_plain(volt, spt, ids[:n], iso)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    n_t = torch.tensor(n, dtype=torch.int32)
    got = m._extract_owned_fixed_plain(volt, spt, ids, n_t, iso, S, 1, blk)
    want = m._extract_owned_fixed_plain(volt, spt, ids, n_t, iso, S, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (int(got[4]) > 0) == (form == "cut")
    jv, jnv, jf, jntri = (np.asarray(a) for a in jm._extract_owned(
        jnp.asarray(vol), jnp.asarray(SKEW_BOX), jnp.asarray(ids.numpy()),
        jnp.int32(n), iso=iso, n_iter=1, batch=S))
    assert (int(jnv), int(jntri)) == (int(got[1]), int(got[3]))
    np.testing.assert_allclose(got[0].numpy(), jv, atol=VERT_ATOL, rtol=0)
    faces = got[2].numpy()
    if form != "cut":
        np.testing.assert_array_equal(faces, jf)
        return
    # a missing owner's corner: the port lets slot 0 stand in (its first
    # vertex plus the rank of the direction in its mask), disn_tpu reads
    # index 0; every other corner is equal
    off = faces != jf
    assert ((jf[off] == 0) & (faces[off] < 7)).all()
    assert off.sum() <= int(got[4])


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """With the kernels' wrappers refusing, every scan form and both
    extractor forms run on CPU tensors and give their results."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    monkeypatch.setattr(change_scan, "change_scan", refuse)
    monkeypatch.setattr(owned_extract, "extract_owned", refuse)
    monkeypatch.setattr(owned_extract, "extract_owned_exact", refuse)
    vol = torch.from_numpy(field("sphere", 33))
    box = torch.from_numpy(BOX)
    cells = torch.from_numpy(coarse_cells(field("sphere", 33), 0.0))
    ids, n = m._active_cells_ext(vol, 0.0)
    eids, en, guard, _ = m._active_cells_from_coarse(vol, cells, 0.0)
    assert en == n and guard == 0 and torch.equal(eids, ids)
    fids, fn, fguard, gov, _ = m._active_cells_from_coarse(
        vol, cells, 0.0, count=torch.tensor(len(cells), dtype=torch.int32),
        bcap=4096)
    assert int(fn) == n and int(fguard) == 0 and int(gov) == 0
    verts, faces = m._extract_owned(vol, box, ids, 0.0)
    out = m._extract_owned_fixed(vol, box, fids, fn, 0.0, n, 1)
    assert len(faces) > 100 and torch.equal(out[2][:len(faces)], faces)
    _, _, blk = m._active_cells_ext_rows(vol, 0.0)
    rows = m._extract_owned_fixed(vol, box, fids, fn, 0.0, n, 1, blk)
    assert torch.equal(rows[2], out[2])
    assert torch.equal(m._extract_owned(vol, box, ids, 0.0, blk)[1], faces)


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only, and say so before any
    build."""
    vol = torch.from_numpy(field("sphere", 33))
    box = torch.from_numpy(BOX)
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        change_scan.change_scan(vol, 0.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        change_scan.change_scan(vol, 0.0, ids, torch.tensor(3,
                                                            dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        owned_extract.extract_owned(vol, box, ids, 8, 0.0, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        owned_extract.extract_owned_exact(vol, box, ids, 0.0)


def test_kernel_tables_are_the_plain_versions():
    """The case tables the extractor's kernel receives are ops/marching's,
    laid out as csrc/owned_extract.cu's Tables: corners, tets, triangle
    counts, owner corner | direction << 3, pair_j, alias axes."""
    raw = np.frombuffer(owned_extract.tables(), np.uint8)
    _, counts = m._tables()
    _, pair_j, nb_tbl, dir_tbl = m._owned_tables()
    sizes = (24, 24, 96, 576, 7, 7)
    parts = np.split(raw, np.cumsum(sizes)[:-1])
    assert len(raw) == sum(sizes)
    np.testing.assert_array_equal(parts[0].reshape(8, 3), m.CORNERS)
    np.testing.assert_array_equal(parts[1].reshape(6, 4), m.TETS)
    np.testing.assert_array_equal(parts[2].reshape(6, 16), counts)
    np.testing.assert_array_equal(parts[3].reshape(6, 16, 2, 3) & 7, nb_tbl)
    np.testing.assert_array_equal(parts[3].reshape(6, 16, 2, 3) >> 3,
                                  dir_tbl)
    np.testing.assert_array_equal(parts[4], pair_j)
    np.testing.assert_array_equal(parts[5], m._alias_axes())
    assert counts.max() <= 2 and (dir_tbl < 7).all() and (nb_tbl < 8).all()
