"""disn_tpu_torch's owned-edge extraction family (scans, device extractor,
records, numpy and C++ host assembly) against disn_tpu's, on the CPU.

The same seeded numpy volumes go through the JAX functions (as
tests/test_marching.py runs them) and the port's with CPU tensors. Integer
outputs (cell ids, block rows, records, quantised edge parameters, faces)
must be bit-identical; vertices agree to atol 1e-6 (f32 interpolation on a
box of size 2, the two packages' operations in the same order).

The CPU cannot show the CUDA fault that `_world` and `plane_points` guard
against (a tensor divided by a Python float becomes a multiply by the
reciprocal only on a card); chip_smoke.py holds both against a float64
evaluation at 49^3 on the card.
"""
import functools

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

from disn_tpu.infer import sparse as jsparse
from disn_tpu.ops import marching as jm
from disn_tpu_torch import native
from disn_tpu_torch.infer import fused, sparse
from disn_tpu_torch.ops import marching as m
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SKEW_BOX = np.array([-0.3, -1, -2, 0.9, 1, 2], np.float32)
VERT_ATOL = 1e-6

# (field, R, iso): SDF-like fields inside the box, fields cut by the high
# boundary (ghost cells, alias suppression), several components, noise
CASES = [("sphere", 17, 0.0), ("sphere", 17, 0.07), ("boundary", 17, 0.0),
         ("box_cut", 33, 0.0), ("plane", 17, 0.0), ("torus", 33, 0.0),
         ("two", 49, 0.0),
         ("noise", 17, 0.0), ("sphere", 65, 0.0), ("empty", 9, 0.0),
         ("full", 9, 0.0)]
SDF_CASES = [c for c in CASES if c[0] not in ("noise", "empty", "full")]


@functools.lru_cache(maxsize=None)
def field(name: str, R: int) -> np.ndarray:
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    if name == "sphere":
        v = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6
    elif name == "boundary":      # a sphere larger than the box
        v = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.3
    elif name == "box_cut":       # a box that the high faces cut on 3 axes
        v = np.maximum(np.maximum(np.abs(x - 0.5) - 0.6,
                                  np.abs(y - 0.4) - 0.7),
                       np.abs(z - 0.5) - 0.65)
    elif name == "plane":         # cut by four faces of the box
        v = z - 0.1
    elif name == "torus":
        v = np.sqrt((np.sqrt(x ** 2 + y ** 2) - 0.55) ** 2 + z ** 2) - 0.2
    elif name == "two":
        v = np.minimum(
            np.sqrt((x + 0.45) ** 2 + y ** 2 + z ** 2) - 0.3,
            np.sqrt((x - 0.5) ** 2 + (y - 0.2) ** 2 + (z - 0.1) ** 2) - 0.25)
    elif name == "noise":
        v = scipy.ndimage.gaussian_filter(
            np.random.RandomState(3).randn(R, R, R), 1.5)
    elif name == "empty":
        v = np.ones((R, R, R))
    elif name == "full":
        v = -np.ones((R, R, R))
    else:
        raise KeyError(name)
    return np.ascontiguousarray(v, np.float32)


@functools.lru_cache(maxsize=None)
def jax_scan(name, R, iso):
    """The JAX full-volume scan: (ids [n] valid prefix, n)."""
    gcap = jm._norm_gcap(R, 1 << 30)
    ids, n, gov = jm._active_cells_ext(jnp.asarray(field(name, R)),
                                       float(iso), gcap)
    assert int(gov) == 0
    return np.asarray(ids)[:int(n)], int(n)


@functools.lru_cache(maxsize=None)
def jax_owned(name, R, iso, box=tuple(BOX)):
    return jm.extract_mesh_owned(field(name, R), np.array(box, np.float32),
                                 iso=iso, gcap=1 << 30, batch=512,
                                 packed=False)


@functools.lru_cache(maxsize=None)
def jax_records(name, R, iso):
    """(rec u16 [n], tq [n, D]) on the valid slots."""
    _, n = jax_scan(name, R, iso)
    gcap = jm._norm_gcap(R, 1 << 30)
    vol = jnp.asarray(field(name, R))
    ids, ncd, _ = jm._active_cells_ext(vol, float(iso), gcap)
    n_iter, batch = jm.records_n_iter(int(ids.shape[0]), max(n, 1), 512)
    rec, tq = jm._extract_records(vol, ids, ncd, iso=float(iso),
                                  n_iter=n_iter, batch=batch)
    return np.asarray(rec)[:n], np.asarray(tq)[:n]


def port_scan(name, R, iso):
    ids, n = m._active_cells_ext(torch.from_numpy(field(name, R)), iso)
    return ids, n


def coarse_ids(vol: np.ndarray):
    """Band-active coarse cells, JAX's and the port's, as the packages'
    own tests make them (tau = 1.5 coarse cell diagonals)."""
    coarse = np.ascontiguousarray(vol[::4, ::4, ::4])
    rc = coarse.shape[0]
    tau = np.float32(1.5 * np.sqrt(np.sum(((BOX[3:] - BOX[:3])
                                           / (rc - 1)) ** 2)))
    jids, jcount = jsparse._active_cells(jnp.asarray(coarse),
                                         jnp.float32(tau), (rc - 1) ** 3)
    ids, count = sparse._active_cells(torch.from_numpy(coarse),
                                      torch.tensor(tau))
    assert count == int(jcount)
    return (jids, jcount), ids


def valid_blk(blk) -> np.ndarray:
    blk = np.asarray(blk)
    return blk[(blk[:, 1] != 0) | (blk[:, 2] != 0)]


def test_owned_tables_equal():
    for got, want in zip(m._owned_tables(), jm._owned_tables()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert m.D_OWNED == len(jm._owned_tables()[0])
    assert m._tq_bits(129) == jm._tq_bits(129) == 8
    assert m._tq_bits(128) == jm._tq_bits(128) == 16


@pytest.mark.parametrize("name,R,iso", CASES)
def test_sign_change_cells_equal(name, R, iso):
    vol = field(name, R)
    want = np.asarray(jm._sign_change_cells(jnp.asarray(vol), iso))
    got = m._sign_change_cells(torch.from_numpy(vol), iso).numpy()
    assert got.shape == (R, R, R)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,R,iso", CASES)
def test_full_scan_ids_bit_identical(name, R, iso):
    want, n = jax_scan(name, R, iso)
    ids, got_n = port_scan(name, R, iso)
    assert got_n == n and ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), want)
    if name in ("empty", "full"):
        assert n == 0


@pytest.mark.parametrize("name,R,iso", SDF_CASES)
def test_candidate_scan_bit_identical(name, R, iso):
    """ids, n_cells, guard and blk rows equal the reference's valid prefix,
    and with guard 0 the ids equal the full scan's."""
    vol = field(name, R)
    (jids, jcount), ids_c = coarse_ids(vol - np.float32(iso))
    bcap = ((R - 1) // 4 + 1) ** 3 * 2
    want_ids, want_n, want_over, want_blk = jm._active_cells_from_coarse(
        jnp.asarray(vol), jids, jcount, iso=float(iso), stride=4, bcap=bcap)
    ids, n, guard, blk = m._active_cells_from_coarse(
        torch.from_numpy(vol), ids_c, iso)
    assert n == int(want_n) > 0 and guard == int(want_over) == 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids)[:n])
    assert blk.dtype == torch.int32
    np.testing.assert_array_equal(blk.numpy(), valid_blk(want_blk))
    full, n_full = port_scan(name, R, iso)
    assert n_full == n
    np.testing.assert_array_equal(ids.numpy(), full.numpy())


def test_candidate_scan_guard_flags_missed_cells():
    """No active coarse cell claimed: every change cell is missed, and the
    guard counts them all, as the reference's does."""
    vol = field("sphere", 33)
    _, _, want, _ = jm._active_cells_from_coarse(
        jnp.asarray(vol), jnp.zeros((8,), jnp.int32), jnp.int32(0), iso=0.0,
        stride=4, bcap=768)
    ids, n, guard, blk = m._active_cells_from_coarse(
        torch.from_numpy(vol), torch.zeros(0, dtype=torch.int32), 0.0)
    assert n == 0 and len(blk) == 0
    assert guard == int(want) == port_scan("sphere", 33, 0.0)[1]


def test_candidate_scan_high_mask_bits():
    """A block whose change bits 31 and 63 are set: the int32 masks hold the
    sign bit's pattern and the host reads them back as uint32."""
    vol = np.ones((9, 9, 9), np.float32)
    vol[1, 3, 3] = vol[3, 3, 3] = -1.0  # corners of cells with x=y=3, z=1|3
    ids, n, guard, blk = m._active_cells_from_coarse(
        torch.from_numpy(vol), torch.arange(8, dtype=torch.int32), 0.0)
    assert guard == 0
    b = blk.numpy()
    first = b[b[:, 0] == 0][0]
    assert first[1] < 0 and first[2] < 0          # bits 31 and 63
    eids, en = m.expand_block_ids_np(b, 9)
    assert en == n == m._mask_cell_count(b)
    np.testing.assert_array_equal(eids, ids.numpy())
    jids, jn = jm.expand_block_ids_np(b, 9)
    np.testing.assert_array_equal(eids, jids[:jn])
    nids, nn = native.mesh_expand_ids(b, 9)
    assert nn == n
    np.testing.assert_array_equal(nids, ids.numpy())


@pytest.mark.parametrize("name,R,iso", CASES)
def test_extract_mesh_owned_matches_jax(name, R, iso):
    """Faces identical, vertices atol 1e-6, against packed=False."""
    jv, jf = jax_owned(name, R, iso)
    v, f = m.extract_mesh_owned(field(name, R), BOX, iso=iso, device="cpu")
    assert v.dtype == np.float32 and f.dtype == np.int32
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=VERT_ATOL, rtol=0)


def test_extract_mesh_from_ids_skewed_box():
    """A box with unequal sides and origin, the ids from the candidate
    scan."""
    vol = field("torus", 33)
    jv, jf = jax_owned("torus", 33, 0.0, box=tuple(SKEW_BOX))
    _, ids_c = coarse_ids(vol)
    ids, n, guard, _ = m._active_cells_from_coarse(torch.from_numpy(vol),
                                                   ids_c, 0.0)
    assert guard == 0
    stats = {}
    v, f = m.extract_mesh_from_ids(vol, SKEW_BOX, ids, device="cpu",
                                   stats=stats)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2 * VERT_ATOL, rtol=0)  # span 4
    assert stats["extract_ms"] > 0 and "fetch_ms" in stats


def test_owned_watertight_and_outward_on_sphere():
    v, f = m.extract_mesh_owned(field("sphere", 33), BOX, device="cpu")
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = np.cross(v1 - v0, v2 - v0)
    assert np.einsum("ij,ij->i", v0, cr).sum() / 6 > 0  # outward normals
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert len(v) - len(edges) // 2 + len(f) == 2       # Euler, genus 0
    assert len(np.unique(f)) == len(v)                  # no orphan vertex


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), 9), axis=1), axis=0)
    return np.sort(v, axis=0), tris


@pytest.mark.parametrize("name,R,iso", [c for c in CASES if c[1] <= 33])
def test_owned_matches_tets_and_weld(name, R, iso):
    """The port's two routes against each other: the same welded vertex
    and triangle sets as marching_tets + weld, also where the boundary cuts
    the surface."""
    vol = torch.from_numpy(field(name, R))
    hv, hf = m.extract_mesh(vol, BOX, iso=iso)
    ov, of_ = m.extract_mesh_owned(vol, BOX, iso=iso, device="cpu")
    assert len(ov) == len(hv) and len(of_) == len(hf)
    for a, b in zip(_mesh_sets(ov, of_), _mesh_sets(hv, hf)):
        np.testing.assert_allclose(a, b, atol=VERT_ATOL, rtol=0)


@pytest.mark.parametrize("name,R,iso", CASES + [("sphere", 129, 0.0)])
def test_records_bit_identical(name, R, iso):
    """rec, tq and the compact tq stream on the valid slots, in the u16
    (R < 129) and the u8 (R = 129) width."""
    jrec, jtq = jax_records(name, R, iso)
    vol = torch.from_numpy(field(name, R))
    ids, n = m._active_cells_ext(vol, iso)
    rec_d, tq_d = m._extract_records(vol, ids, iso)
    rec, tq = m._records_to_host(rec_d, tq_d)
    assert rec.dtype == jrec.dtype == np.uint16 and tq.dtype == jtq.dtype
    assert tq.dtype == (np.uint8 if R >= 129 else np.uint16)
    np.testing.assert_array_equal(rec, jrec)
    np.testing.assert_array_equal(tq, jtq)
    if n == 0:
        return
    nv = m._count_cross(rec_d)
    assert nv == int(jm._count_cross(jnp.asarray(jrec)))
    want_c, want_nv = jm._compact_tq(jnp.asarray(jrec), jnp.asarray(jtq),
                                     nv + 8)
    assert int(want_nv) == nv
    got_c = m._compact_tq(rec_d, tq_d).numpy().astype(jtq.dtype)
    np.testing.assert_array_equal(got_c, np.asarray(want_c)[:nv])


@pytest.mark.parametrize("name,R,iso", [("boundary", 33, 0.0),
                                        ("box_cut", 33, 0.0),
                                        ("sphere", 33, 0.0)])
def test_derive_recs_equals_device_cross(name, R, iso):
    """The u8 inside masks alone give back the device's records, ghost
    cells with suppressed edges included: numpy twin, the reference's, and
    the C++ pass."""
    vol = field(name, R)
    _, ids_c = coarse_ids(vol)
    volt = torch.from_numpy(vol)
    ids, n, guard, blk = m._active_cells_from_coarse(volt, ids_c, iso)
    assert guard == 0 and n > 0
    rec, _ = m._records_to_host(*m._extract_records(volt, ids, iso))
    want = rec.astype(np.uint32)
    imask = (want & 0xFF).astype(np.uint8)
    b = blk.numpy()
    np.testing.assert_array_equal(m.derive_recs_np(b, imask, R), want)
    np.testing.assert_array_equal(native.derive_recs(b, imask, R), want)
    np.testing.assert_array_equal(jm._derive_recs(b, imask, R), want)
    if name != "sphere":  # some ghost cell's alias suppression is at work
        c = m._cell_xyz(ids, R).numpy()
        ghost = (c == R - 1).any(1)
        raw = m.derive_recs_np(b, imask, R + 4)[ghost]  # no cell is a ghost
        assert ghost.any() and (raw != want[ghost]).any()


@pytest.mark.parametrize("name,R,iso", SDF_CASES + [("noise", 17, 0.0),
                                                    ("sphere", 129, 0.0)])
def test_host_assembly_numpy_and_cpp(name, R, iso):
    """assemble_mesh_np equals the reference's (faces and vertices bit for
    bit: the same numpy arithmetic), in both tq forms; the C++ passes give
    the same faces bit for bit and vertices within 2e-7 (they interpolate
    in double and round once, numpy in f32: one ulp at |x| <= 1); and both
    give the device extractor's faces, with vertices within the
    quantisation step."""
    volt = torch.from_numpy(field(name, R))
    ids_t, n = m._active_cells_ext(volt, iso)
    rec_d, tq_d = m._extract_records(volt, ids_t, iso)
    rec, tq = m._records_to_host(rec_d, tq_d)
    ids = ids_t.numpy()
    want_v, want_f = jm.assemble_mesh_np(ids, rec, tq, n, R, BOX)
    got_v, got_f = m.assemble_mesh_np(ids, rec, tq, n, R, BOX)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_v, want_v)
    tqc = m._compact_tq(rec_d, tq_d).numpy().astype(tq.dtype)
    cv, cf = m.assemble_mesh_np(ids, rec, tqc, n, R, BOX, tq_compact=True)
    np.testing.assert_array_equal(cf, want_f)
    np.testing.assert_array_equal(cv, want_v)

    nv_, nf_ = native.mesh_assemble(ids, rec, tq, n, R, BOX)
    np.testing.assert_array_equal(nf_, got_f)
    np.testing.assert_allclose(nv_, got_v, atol=2e-7, rtol=0)

    ov, of_ = m.extract_mesh_owned(volt, BOX, iso=iso, device="cpu")
    np.testing.assert_array_equal(got_f, of_)
    step = 2.0 / (R - 1) / (2 * (255 if R >= 129 else 65535))
    assert np.abs(got_v - ov).max() <= step + 1e-6
    assert np.abs(nv_ - ov).max() <= step + 1e-6


@pytest.mark.parametrize("name,R,iso", SDF_CASES + [("sphere", 129, 0.0)])
def test_blocks_passes_equal_numpy(name, R, iso):
    """The blocks-driven C++ passes (the record route's) equal the numpy
    twin on the same records: faces bit for bit, vertices within 2e-7, in
    both tq forms; and extract_mesh_records ends in the same mesh."""
    vol = field(name, R)
    _, ids_c = coarse_ids(vol - np.float32(iso))
    volt = torch.from_numpy(vol)
    ids, n, guard, blk = m._active_cells_from_coarse(volt, ids_c, iso)
    assert guard == 0
    rec_d, tq_d = m._extract_records(volt, ids, iso)
    rec, tq = m._records_to_host(rec_d, tq_d)
    b = blk.numpy()
    np_v, np_f = m.assemble_mesh_np(ids.numpy(), rec, tq, n, R, BOX)
    f = native.mesh_faces_blocks(b, rec, n, R)
    v = native.mesh_verts_blocks(b, rec, tq, n, R, BOX)
    np.testing.assert_array_equal(f, np_f)
    np.testing.assert_allclose(v, np_v, atol=2e-7, rtol=0)
    tqc = m._compact_tq(rec_d, tq_d).numpy().astype(tq.dtype)
    vc = native.mesh_verts_blocks(b, rec, tqc, n, R, BOX, compact=True,
                                  nv=len(np_v))
    np.testing.assert_array_equal(vc, v)
    rv, rf = m.extract_mesh_records(volt, BOX, ids, n, blk=blk, iso=iso,
                                    device="cpu")
    np.testing.assert_array_equal(rf, f)
    np.testing.assert_array_equal(rv, v)
    iv, if_ = m.extract_mesh_records(volt, BOX, ids, n, iso=iso,
                                     device="cpu")   # the id-list form
    np.testing.assert_array_equal(if_, f)
    np.testing.assert_array_equal(iv, v)


def test_record_route_matches_jax_record_route():
    """extract_mesh_records against the reference's, u8 width (R = 129):
    identical faces; vertices atol 2e-7 (both assemble in C++ from the same
    records; the libraries are built separately)."""
    R = 129
    vol = field("sphere", R)
    gcap = jm._norm_gcap(R, None)
    jids, jn, _ = jm._active_cells_ext(jnp.asarray(vol), 0.0, gcap)
    jv, jf = jm.extract_mesh_records(jnp.asarray(vol), BOX, jids, int(jn))
    ids, n = port_scan("sphere", R, 0.0)
    v, f = m.extract_mesh_records(vol, BOX, ids, n, device="cpu")
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=2e-7, rtol=0)
    ov, _ = jax_owned("sphere", R, 0.0)
    assert np.abs(v - ov).max() <= 2.0 / (R - 1) / 510 + 1e-6


def test_record_route_raises_on_inconsistent_streams():
    """No quiet fallback: a cell count the masks do not encode, a record
    stream that names a missing neighbour, and a compiler that cannot be
    run all raise."""
    vol = field("sphere", 33)
    _, ids_c = coarse_ids(vol)
    volt = torch.from_numpy(vol)
    ids, n, _, blk = m._active_cells_from_coarse(volt, ids_c, 0.0)
    with pytest.raises(ValueError, match="ids for"):
        m.extract_mesh_records(volt, BOX, ids, n - 1, blk=blk, device="cpu")
    with pytest.raises(RuntimeError, match="block masks encode"):
        m.extract_mesh_records(volt, BOX, ids[:-1], n - 1, blk=blk,
                               device="cpu")
    rec, tq = m._records_to_host(*m._extract_records(volt, ids, 0.0))
    b = blk.numpy().copy()
    keep = np.ones(len(b), bool)
    keep[len(b) // 2] = False            # drop a block some triangle needs
    n_less = m._mask_cell_count(b[keep])
    with pytest.raises(RuntimeError, match="mesh_faces_blocks failed"):
        native.mesh_faces_blocks(b[keep], rec, n_less, 33)
    with pytest.raises(RuntimeError, match="under-covers"):
        native.mesh_faces_blocks(b, rec[:n - 1], n, 33)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nowhere")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+"):
        native.build()
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed on meshassemble.cpp"):
        native.build()


def test_native_builds_from_source_into_build_dir():
    lib = native.build()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")
    assert native._SRC.name == "meshassemble.cpp" and native._SRC.exists()


def test_world_and_plane_points_against_float64():
    """Grid index -> world coordinate at a spacing that is inexact in f32
    (2/48): within one ulp of the float64 evaluation rounded to f32, on
    the CPU. (The CUDA fault this guards against cannot occur here.)"""
    R = 49
    sp = torch.from_numpy(SKEW_BOX)
    g = torch.stack(torch.meshgrid(*[torch.arange(R)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    lo, hi = SKEW_BOX[:3].astype(np.float64), SKEW_BOX[3:].astype(np.float64)
    want = lo + g.numpy().astype(np.float64) / (R - 1) * (hi - lo)
    ulp = np.spacing(np.abs(SKEW_BOX).max().astype(np.float32))
    got = m._world(g, R, sp).numpy()
    assert np.abs(got - want).max() <= ulp
    pts, flat = fused.plane_points(R, sp)
    idx = flat.numpy()
    gp = np.stack([idx % R, (idx // R) % R, idx // (R * R)], -1)
    want_p = lo + gp.astype(np.float64) / (R - 1) * (hi - lo)
    assert np.abs(pts.numpy() - want_p).max() <= ulp
