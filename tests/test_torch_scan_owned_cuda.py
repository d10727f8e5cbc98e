"""K2s (csrc/change_scan.cu: the volume flow's candidate scan) and K7
(csrc/owned_extract.cu: the owned-edge extractor) on the card against
their plain versions on the same card, bit for bit over their whole
outputs: grids of 49^3, 65^3, 129^3 and a ragged 100^3, both boxes; no
cell, every cell, +-0.0 and NaN in the volume, a value exactly at iso;
the coarse scan in its exact and fixed forms (padded ids, the count on the
card, count 0); the extractor with the owners looked up through the scan's
rows (the main path's route) and through the dense table (hand-built
lists), each against its plain version and the two routes against each
other: ghost cells, slots past the cells, count 0, a list the slots do not
cover (missing > 0; the exact route raising where the plain one raises),
the capped compaction's zero rows; launch calls a call; scratch and peak
memory at 257^3; the main path's callers pass the rows; the fixed forms
under torch.cuda.set_sync_debug_mode("error"). Needs an NVIDIA GPU and
nvcc; skips without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_owned_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.ops import change_scan, owned_extract
from disn_tpu_torch.ops import marching as m

BOXES = {"unit": [-1, -1, -1, 1, 1, 1],
         "skewed": [-0.7, -1.1, -0.4, 0.9, 1.3, 0.8]}
KINDS = ("sphere", "cut", "noise", "none", "every", "zeros", "nan", "at_iso")
ISO = {"at_iso": 0.25}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def field(kind: str, R: int, seed: int = 0) -> np.ndarray:
    """A seeded [R]^3 f32 field: a sphere inside the box, one the box cuts
    (ghost cells own crossings), smooth noise, no change cell, every cell
    changing (a checkerboard), a sphere with corners at +-0.0, noise with
    NaN, and a sphere with values exactly at ISO["at_iso"]."""
    rng = np.random.RandomState(seed)
    lin = np.linspace(-1, 1, R)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(x * x + y * y + z * z) - 0.6
    if kind == "sphere":
        v = sphere
    elif kind == "cut":
        v = np.sqrt((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) - 0.9
    elif kind == "noise":
        v = rng.randn(R, R, R)
        for ax in range(3):
            v = (v + np.roll(v, 1, ax) + np.roll(v, -1, ax)) / 3
    elif kind == "none":
        v = np.ones((R, R, R))
    elif kind == "every":
        v = np.where((np.indices((R, R, R)).sum(0) % 2) == 0, 1.0, -1.0)
    elif kind == "zeros":
        v = sphere + 0.02 * rng.randn(R, R, R)
        v[rng.rand(R, R, R) < 0.1] = 0.0
        v[rng.rand(R, R, R) < 0.1] = -0.0
    elif kind == "nan":
        v = sphere + 0.05 * rng.randn(R, R, R)
        v[rng.rand(R, R, R) < 0.02] = np.nan
    elif kind == "at_iso":
        v = np.round(sphere * 8) / 8 + 0.25  # many values exactly 0.25
        v = v - 0.25 + ISO["at_iso"]
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(v, np.float32)


def coarse_ids(vol: torch.Tensor, iso: float) -> torch.Tensor:
    """The coarse cells (stride 4) with a corner within 0.3 of the iso or
    corners of both signs: a band like the sparse pass's active cells."""
    c = (vol.shape[0] - 1) // 4
    vc = vol[::4, ::4, ::4][:c + 1, :c + 1, :c + 1] - iso
    corners = torch.stack([vc[dz:dz + c, dy:dy + c, dx:dx + c]
                           for dz in (0, 1) for dy in (0, 1)
                           for dx in (0, 1)])
    act = ((corners.abs().amin(0) < 0.3) | ((corners < 0).any(0)
                                             & (corners >= 0).any(0)))
    return torch.nonzero(act.reshape(-1))[:, 0].int()


def same(a, b) -> bool:
    """Equal dtype, shape and bits (floats compared as their bits)."""
    if not torch.is_tensor(a):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def rows_of(ids: torch.Tensor, R: int) -> torch.Tensor:
    """The rows [b,3] int32 (block id, mask lo, mask hi) of a list in a
    scan's order (blocks ascending, a block's cells by bit), as
    marching._compact_block_bits gives a scan's: one row a block the list
    touches, with the list's cells as its bits."""
    xyz = m._cell_xyz(ids, R)
    B3 = -(-R // 4)
    b = ((xyz[:, 2] >> 2) * B3 + (xyz[:, 1] >> 2)) * B3 + (xyz[:, 0] >> 2)
    bit = ((xyz[:, 2] & 3) * 4 + (xyz[:, 1] & 3)) * 4 + (xyz[:, 0] & 3)
    blocks, inv = torch.unique_consecutive(b, return_inverse=True)
    mask = torch.zeros_like(blocks).index_add_(0, inv, 1 << bit)
    words = torch.stack([blocks, mask & 0xFFFFFFFF, (mask >> 32) & 0xFFFFFFFF],
                        1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def scan_holds(vol, iso, ids=None, count=None) -> torch.Tensor:
    got = m._candidate_scan(vol, iso, ids, count)
    want = m._candidate_scan_plain(vol, iso, ids, count)
    assert all(same(g, w) for g, w in zip(got, want)), (
        [same(g, w) for g, w in zip(got, want)], got[2], want[2])
    return got[2]


def launch_calls(fn) -> dict:
    """The runtime's launch, memset and copy calls in one fn(), by name
    (the runtime's events, not the device's: cudaMemsetAsync, not Memset
    (Device))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.name.startswith("cuda") and any(
                k in e.name for k in ("LaunchKernel", "Memset", "Memcpy")):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def device_calls(calls: dict) -> int:
    """Launch calls, memsets included."""
    return sum(n for k, n in calls.items() if "Memcpy" not in k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("R", [49, 65, 129, 100])
def test_scan_equals_plain(card, kind, R):
    """The full scan, the coarse scan's exact form, its fixed form on a
    padded list with the count on the card, count 0 and a count past the
    list: bits, flags and counts bit for bit; the counts add up."""
    iso = ISO.get(kind, 0.0)
    vol = torch.from_numpy(field(kind, R)).to(card)
    counts = scan_holds(vol, iso)
    total, inside, outside = counts.tolist()
    assert inside == total and outside == 0
    if kind == "every":  # all but the far corner's ghost, whose corners
        assert total == R ** 3 - 1  # clamp onto one point
    if kind == "none":
        assert total == 0
    ids = coarse_ids(vol, iso)
    counts = scan_holds(vol, iso, ids)
    assert counts[0] == total and counts[1] + counts[2] == total
    padded = torch.zeros(ids.shape[0] + 333, dtype=torch.int32, device=card)
    padded[:ids.shape[0]] = ids
    padded[ids.shape[0]:] = 7  # a live-looking id past the count
    for cnt in (ids.shape[0], 0, ids.shape[0] // 2, padded.shape[0] + 5):
        scan_holds(vol, iso, padded,
                   torch.tensor(cnt, dtype=torch.int32, device=card))


def extract_holds(args, blk) -> tuple:
    """The fixed extractor on (volume, sdf_params, ids, n, iso, n_iter,
    batch) through the rows `blk`: equal to its plain version and to the
    dense route's kernel, every output bit for bit -> the kernel's
    result."""
    got = m._extract_owned_fixed(*args, blk=blk)
    want = m._extract_owned_fixed_plain(*args, blk=blk)
    dense = m._extract_owned_fixed(*args)
    assert all(same(g, w) for g, w in zip(got, want)), (
        [same(g, w) for g, w in zip(got, want)])
    assert all(same(g, w) for g, w in zip(got, dense)), (
        [same(g, w) for g, w in zip(got, dense)])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "cut", "noise", "zeros", "nan",
                                  "at_iso"])
@pytest.mark.parametrize("R", [49, 65, 100])
@pytest.mark.parametrize("box", ["unit", "skewed"])
def test_extractor_equals_plain(card, kind, R, box):
    """The fixed extractor over the full scan's ids: slots past the cells
    (padded), S = n, the count 0 and S < n (missing > 0): every output bit
    for bit, on the dense route against its plain version, on the rows
    route against its plain version and the dense route; the exact route
    at S = n on both routes: the plain one's rows bit for bit, and the
    fixed form's leading rows."""
    iso = ISO.get(kind, 0.0)
    vol = torch.from_numpy(field(kind, R)).to(card)
    sp = torch.tensor(BOXES[box], dtype=torch.float32, device=card)
    ids, n, blk = m._active_cells_ext_rows(vol, iso)
    assert n > 0
    padded = torch.zeros(n + 700, dtype=torch.int32, device=card)
    padded[:n] = ids
    for S, live in ((n + 500, n), (n, n), (n + 500, 0), (n // 2, n)):
        n_t = torch.tensor(live, dtype=torch.int32, device=card)
        args = (vol, sp, padded, n_t, iso, S, 1)
        got = m._extract_owned_fixed(*args)
        want = m._extract_owned_fixed_plain(*args)
        assert all(same(g, w) for g, w in zip(got, want)), (
            S, live, [same(g, w) for g, w in zip(got, want)])
        extract_holds(args, blk)
        if S < live:
            assert int(got[4]) > 0
        elif live:
            assert int(got[4]) == 0
    ev, ef = m._extract_owned(vol, sp, ids, iso)
    pv, pf = m._extract_owned_plain(vol, sp, ids, iso)
    assert same(ev, pv) and same(ef, pf)
    rv, rf = m._extract_owned(vol, sp, ids, iso, blk)
    qv, qf = m._extract_owned_plain(vol, sp, ids, iso, blk)
    assert same(rv, qv) and same(rf, qf) and same(rv, ev) and same(rf, ef)
    fixed = m._extract_owned_fixed(vol, sp, ids, n, iso, n, 1, blk=blk)
    assert same(fixed[0][:ev.shape[0]], ev) and same(fixed[2][:ef.shape[0]],
                                                     ef)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "cut", "noise"])
@pytest.mark.parametrize("R", [65, 129])
def test_extractor_on_the_capped_rows(card, kind, R):
    """The capped compaction's list and rows (a cap that keeps every block,
    zero rows past them; the least cap, 512 rows, which the 129^3 sphere
    and the noise overflow): the rows route bit for bit its plain version
    and the dense route at S = n, at S = n/2 (missing > 0) and at slots
    past n."""
    vol = torch.from_numpy(field(kind, R)).to(card)
    sp = torch.tensor(BOXES["skewed"], dtype=torch.float32, device=card)
    cids = coarse_ids(vol, 0.0)
    cnt = torch.tensor(cids.shape[0], dtype=torch.int32, device=card)
    for bcap in (4 * cids.shape[0] + 4096, 64):
        ids, n, _, gov, blk = m._active_cells_from_coarse(
            vol, cids, 0.0, count=cnt, bcap=bcap)
        nn = int(n)
        if bcap > 64:
            assert not blk[-1].any()  # zero rows
        if (kind, R) == ("sphere", 129):  # ~1,150 blocks
            assert (int(gov) > 0) == (bcap == 64)
        cut = extract_holds((vol, sp, ids, n, 0.0, nn // 2, 1), blk)
        assert int(cut[4]) > 0
        for S in (nn, min(ids.shape[0], nn + 300)):
            got = extract_holds((vol, sp, ids, n, 0.0, S, 1), blk)
            if int(gov) == 0:
                assert int(got[4]) == 0


@pytest.mark.cuda
def test_exact_route_raises_where_the_plain_one_raises(card):
    """A list the slots do not cover: the kernel's exact route raises the
    plain version's ValueError, and the fixed form counts the missing
    owners, on both routes."""
    vol = torch.from_numpy(field("sphere", 49)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    ids, n = m._active_cells_ext(vol, 0.0)
    with pytest.raises(ValueError, match="active-cell list"):
        m._extract_owned_plain(vol, sp, ids[:n // 3], 0.0)
    with pytest.raises(ValueError, match="active-cell list"):
        m._extract_owned(vol, sp, ids[:n // 3], 0.0)
    *_, missing = m._extract_owned_fixed(vol, sp, ids, n, 0.0, n // 3, 1)
    assert int(missing) > 0
    _, _, blk = m._active_cells_ext_rows(vol, 0.0)
    with pytest.raises(ValueError, match="active-cell list"):
        m._extract_owned_plain(vol, sp, ids[:n // 3], 0.0, blk)
    with pytest.raises(ValueError, match="active-cell list"):
        m._extract_owned(vol, sp, ids[:n // 3], 0.0, blk)
    *_, rmissing = m._extract_owned_fixed(vol, sp, ids, n, 0.0, n // 3, 1,
                                          blk=blk)
    assert int(rmissing) == int(missing)


@pytest.mark.cuda
def test_ghost_cells_own_vertices_and_emit_no_triangle(card):
    """A surface the box cuts: the scan lists ghost cells, which own
    vertices (alias-suppressed) and no triangle, and the kernel equals the
    plain version on them, on the dense route and through the ghost list's
    own rows. The full scan's rows hold the ghost list's rows' bits."""
    vol = torch.from_numpy(field("cut", 65)).to(card)
    sp = torch.tensor(BOXES["skewed"], dtype=torch.float32, device=card)
    ids, n = m._active_cells_ext(vol, 0.0)
    xyz = m._cell_xyz(ids, 65)
    ghosts = (xyz == 64).any(1)
    assert ghosts.any()
    gids = ids[ghosts].contiguous()
    got = m._extract_owned_fixed(vol, sp, gids, gids.shape[0], 0.0,
                                 gids.shape[0], 1)
    want = m._extract_owned_fixed_plain(vol, sp, gids, gids.shape[0], 0.0,
                                        gids.shape[0], 1)
    assert all(same(g, w) for g, w in zip(got, want))
    assert int(got[1]) > 0 and int(got[3]) == 0
    _, _, blk = m._active_cells_ext_rows(vol, 0.0)
    rows = blk[(blk[:, 1] | blk[:, 2]) != 0]
    assert same(rows, rows_of(ids, 65))
    got_rows = extract_holds((vol, sp, gids, gids.shape[0], 0.0,
                              gids.shape[0], 1), rows_of(gids, 65))
    assert all(same(g, w) for g, w in zip(got_rows, got))


@pytest.mark.cuda
def test_launch_calls(card):
    """At most 3 launch calls a scan (memset included), 3 a fixed
    extraction through the scan's rows (no memset) and 4 through the dense
    table, with no copy; the exact extraction adds one copy."""
    vol = torch.from_numpy(field("sphere", 129)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    ids = coarse_ids(vol, 0.0)
    cnt = torch.tensor(ids.shape[0], dtype=torch.int32, device=card)
    fids, n, blk = m._active_cells_ext_rows(vol, 0.0)
    n_t = torch.tensor(n, dtype=torch.int32, device=card)
    fns = {"full scan": lambda: change_scan.change_scan(vol, 0.0),
           "coarse scan": lambda: change_scan.change_scan(vol, 0.0, ids, cnt),
           "fixed extract": lambda: owned_extract.extract_owned(
               vol, sp, fids, n_t, 0.0, n, blk=blk),
           "exact extract": lambda: owned_extract.extract_owned_exact(
               vol, sp, fids, 0.0, blk=blk),
           "dense fixed extract": lambda: owned_extract.extract_owned(
               vol, sp, fids, n_t, 0.0, n),
           "dense exact extract": lambda: owned_extract.extract_owned_exact(
               vol, sp, fids, 0.0)}
    for f in fns.values():
        f()
    calls = {k: launch_calls(f) for k, f in fns.items()}
    assert device_calls(calls["full scan"]) == 2, calls
    assert device_calls(calls["coarse scan"]) == 3, calls
    assert device_calls(calls["fixed extract"]) == 3, calls
    assert device_calls(calls["exact extract"]) == 3, calls
    assert device_calls(calls["dense fixed extract"]) == 4, calls
    assert device_calls(calls["dense exact extract"]) == 4, calls
    for k in ("full scan", "coarse scan", "fixed extract",
              "dense fixed extract"):
        assert not any("Memcpy" in name for name in calls[k]), calls
    for k in ("fixed extract", "exact extract"):
        assert not any("Memset" in name for name in calls[k]), calls


@pytest.mark.cuda
def test_no_r3_scratch_at_257(card):
    """At 257^3 through the scan's rows: the scratch a call takes is at
    most 2 MB (the dense route's [R^3] owner table alone is 68 MB), and
    the bytes the call asks the caching allocator for rise at their peak
    by no more than the outputs plus 2 MB; the bytes it allocates, by no
    more than that and one 2 MB block of the allocator's rounding (a
    block it hands out holds a request rounded up, up to its segment's
    2 MB when the rest cannot be split off)."""
    R, S = 257, 81920  # a volume-flow hit's slots at 257^3
    lin = torch.linspace(-1, 1, R, device=card)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    vol = ((x * x + y * y + z * z).sqrt() - 0.45).contiguous()
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    ids, n, blk = m._active_cells_ext_rows(vol, 0.0)
    assert 50000 < n <= S
    padded = torch.zeros(S, dtype=torch.int32, device=card)
    padded[:n] = ids
    n_t = torch.tensor(n, dtype=torch.int32, device=card)
    scratch = owned_extract.scratch_bytes(R, S, blk.shape[0])
    assert scratch <= 2 << 20, scratch
    assert owned_extract.scratch_bytes(R, S, None) >= 4 * R ** 3
    owned_extract.extract_owned(vol, sp, padded, n_t, 0.0, S, blk=blk)
    torch.cuda.synchronize()
    outputs = 4 * (S * 7 * 3 + S * 12 * 3 + 4)
    stats = torch.cuda.memory_stats()
    base = {k: stats[f"{k}_bytes.all.current"]
            for k in ("requested", "allocated")}
    torch.cuda.reset_peak_memory_stats()
    out = owned_extract.extract_owned(vol, sp, padded, n_t, 0.0, S, blk=blk)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats()
    rise = {k: stats[f"{k}_bytes.all.peak"] - v for k, v in base.items()}
    assert outputs <= rise["requested"] <= outputs + (2 << 20), (rise,
                                                                   outputs)
    assert rise["allocated"] <= outputs + (2 << 20) + (2 << 20), (rise,
                                                                   outputs)
    assert int(out[4]) == 0 and int(out[1]) > 0


@pytest.mark.cuda
def test_main_path_callers_pass_the_rows(card, monkeypatch):
    """The volume flow's callers hand the extractor their scan's rows:
    image_to_mesh on the volume flow (a seed, then hits), the full-volume
    scan's extract_mesh_owned (volume_to_mesh, the dense paths) and
    _extraction on a scan's tuple launch K7 without one dense call."""
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())
    monkeypatch.setattr(pipeline, "_SPEC_CACHE", {})
    cfg = Config(sdf_res=64, compute_dtype="bfloat16", cell_cap_frac=0.9,
                 sparse_words=False)
    params = synthetic.analytic_octahedron_params(cfg, r=0.25)
    img = np.random.RandomState(0).randint(0, 256, (137, 137, 3),
                                           dtype=np.uint8)
    trans = synthetic.demo_trans_mat()
    before = (owned_extract.extract_owned.launches,
              owned_extract.extract_owned.dense_calls)
    hits = pipeline.spec_counts["hit"]
    meshes = [pipeline.image_to_mesh(params, img, trans, cfg)
              for _ in range(3)]
    assert pipeline.spec_counts["hit"] == hits + 2
    vol = torch.from_numpy(field("cut", 65)).to(card)
    v, f = pipeline.volume_to_mesh(vol, BOXES["unit"])
    cids = coarse_ids(vol, 0.0)
    scan = m._active_cells_from_coarse(vol, cids, 0.0)
    ctx = pipeline._extraction(vol, scan, BOXES["unit"], 0.0, card, None)
    iv, if_ = ctx["fin"]()
    assert (owned_extract.extract_owned.launches - before[0] == 5
            and owned_extract.extract_owned.dense_calls == before[1])
    assert len(meshes[2][1]) > 500 and len(f) > 500
    np.testing.assert_array_equal(meshes[2][1], meshes[0][1])
    if scan[2] == 0:
        np.testing.assert_array_equal(if_, f)


@pytest.mark.cuda
def test_fixed_forms_wait_for_nothing(card):
    """The coarse scan's fixed form and the fixed extractor queue their
    work under set_sync_debug_mode("error"), as the speculative dispatch
    runs them; each wrapper counts one launch a call."""
    vol = torch.from_numpy(field("sphere", 65)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    ids = coarse_ids(vol, 0.0)
    cnt = torch.tensor(ids.shape[0], dtype=torch.int32, device=card)
    fids, n = m._active_cells_ext(vol, 0.0)
    n_t = torch.tensor(n, dtype=torch.int32, device=card)
    m._candidate_scan(vol, 0.0, ids, cnt)  # the builds, outside the gate
    m._extract_owned_fixed(vol, sp, fids, n_t, 0.0, n, 1)
    torch.cuda.synchronize()
    before = (change_scan.change_scan.launches,
              owned_extract.extract_owned.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        scan = m._candidate_scan(vol, 0.0, ids, cnt)
        ext = m._extract_owned_fixed(vol, sp, fids, n_t, 0.0, n, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (change_scan.change_scan.launches,
            owned_extract.extract_owned.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = m._candidate_scan_plain(vol, 0.0, ids, cnt)
    assert all(same(g, w) for g, w in zip(scan, want))
    want = m._extract_owned_fixed_plain(vol, sp, fids, n_t, 0.0, n, 1)
    assert all(same(g, w) for g, w in zip(ext, want))


@pytest.mark.cuda
def test_cuda_tensors_take_the_kernels(card, monkeypatch):
    """ops/marching sends CUDA tensors to the kernels: with the plain
    versions refusing, the scans and both extractor forms still run."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("_candidate_scan_plain", "_extract_owned_fixed_plain",
                 "_extract_owned_plain"):
        monkeypatch.setattr(m, name, refuse)
    vol = torch.from_numpy(field("sphere", 65)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    ids, n = m._active_cells_ext(vol, 0.0)
    m._active_cells_from_coarse(vol, coarse_ids(vol, 0.0), 0.0)
    m._extract_owned(vol, sp, ids, 0.0)
    m._extract_owned_fixed(vol, sp, ids, n, 0.0, n, 1)
