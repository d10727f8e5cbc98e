"""K5 (csrc/sparse_words.cu) on the card against its plain version on the
same card, and the sparse-words flow against the volume flow on fields the
smoke run's octahedron never gives it. Needs an NVIDIA GPU and nvcc; skips
without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sparse_words_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.infer import sparse
from disn_tpu_torch.ops import fused_decode
from disn_tpu_torch.ops import marching as m
from disn_tpu_torch.ops import sparse_words as sw


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def random_inputs(R, nk, count, seed, dev):
    """nk distinct random coarse cells (most "+1" neighbours absent), rows
    and coarse grid around the iso with 5% of the rows exactly at it; the
    ids past `count` are 0."""
    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(c ** 3, nk, replace=False)).astype(np.int32)
    ids[count:] = 0
    rows = (0.3 * rng.randn(nk * 64)).astype(np.float32)
    rows[rng.rand(nk * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(ids).to(dev),
            count, torch.from_numpy(vol_c).to(dev))


def field(name, R, dev):
    lin = torch.linspace(-1, 1, R, device=dev)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    if name == "sphere":
        return torch.sqrt(x * x + y * y + z * z) - 0.45
    return torch.maximum(torch.maximum((x - 0.1).abs() - 0.5,
                                       (y + 0.05).abs() - 0.6),
                         (z - 0.02).abs() - 0.45)


def sparse_parts(name, R, dev):
    """A field as the sparse pass leaves it: the coarse grid, its active
    cells (the band cull at 1.5 coarse diagonals), their fine rows, and the
    volume the volume flow would assemble from them."""
    full = field(name, R, dev)
    vol_c = full[::4, ::4, ::4].contiguous()
    c = vol_c.shape[0] - 1
    tau = torch.tensor(1.5 * 3 ** 0.5 * 2.0 / c, device=dev)
    cells, count = sparse._active_cells(vol_c, tau)
    _, flats = fused_decode.cell_points(cells, c, R,
                                        torch.tensor([-1., -1, -1, 1, 1, 1],
                                                     device=dev))
    rows = full.reshape(-1)[flats].contiguous()
    vol = sparse._upsample_aligned(vol_c, 4).reshape(-1)
    vol[flats] = rows
    return rows, cells, count, vol_c, vol.reshape(R, R, R)


def hold(args, R, iso=0.0):
    got = sw.sparse_cell_words(*args, R=R, iso=iso)
    want = m._sparse_cell_words(*args, R, iso)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("R", [65, 257])
@pytest.mark.parametrize("nk,count", [(1, 1), (3, 2), (61, 61),
                                      (2001, 2001), (2001, 1500)])
def test_kernel_equals_plain_on_random_inputs(card, R, nk, count):
    """Every output bit for bit at u16 (R = 65) and u8 (257) grids, at
    ragged cell counts and with padded ids past `count`."""
    before = sw.sparse_cell_words.launches
    hold(random_inputs(R, nk, count, seed=nk + R, dev=card), R)
    assert sw.sparse_cell_words.launches == before + 1


def lattice_inputs(R, stride, seed, dev, pad=0):
    """Every `stride`-th coarse cell along each axis active (stride 1:
    every "+1" and "-1" neighbour active; 2: none), rows and coarse grid
    around the iso; `pad` more ids past the count, copies of active cells."""
    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ax = np.arange(0, c, stride)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    ids = ((z * c + y) * c + x).reshape(-1).astype(np.int32)
    count = len(ids)
    ids = np.concatenate([ids, rng.choice(ids, pad)]).astype(np.int32)
    rows = (0.3 * rng.randn(len(ids) * 64)).astype(np.float32)
    rows[rng.rand(len(ids) * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(ids).to(dev),
            count, torch.from_numpy(vol_c).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [65, 257])
def test_kernel_equals_plain_with_no_cells(card, R):
    """nk = 0: the step still fills the own-slot table, zeroes bits and
    cand and counts guard term (1), in one call."""
    c = (R - 1) // 4
    vol_c = torch.from_numpy((0.3 * np.random.RandomState(R).randn(
        c + 1, c + 1, c + 1)).astype(np.float32)).to(card)
    empty = (torch.empty(0, device=card),
             torch.empty(0, dtype=torch.int32, device=card), 0, vol_c)
    before = sw.sparse_cell_words.launches
    words, bits, cand, own, guard = hold(empty, R)
    assert sw.sparse_cell_words.launches == before + 1
    assert words.shape[1] == 0 and int(guard) > 0 and not bool(cand.any())


@pytest.mark.cuda
@pytest.mark.parametrize("R", [65, 129])
@pytest.mark.parametrize("stride,pad", [(1, 0), (2, 0), (1, 37), (2, 37)])
def test_kernel_equals_plain_on_lattices(card, R, stride, pad):
    """Every neighbour active (the patch from neighbours' rows, guard term
    (2) skipped) or none (the patch's faces from coarse lerps, every low
    face checked), with and without padded ids past the count that repeat
    active cells."""
    hold(lattice_inputs(R, stride, seed=R + stride + pad, dev=card, pad=pad),
         R)


# windows of torch.profiler a test takes at most: the profiler drops a
# device event now and then (K5's 1.25 us memset, once a whole window), so
# a window that misses an event the step always launches is taken again
PROFILE_TRIES = 3
# steps in one window: late in a long process the profiler drops the
# first device events of a window (the first step's memset), so the
# window holds more than one step
PROFILE_STEPS = 3


@pytest.mark.cuda
def test_one_step_is_only_the_librarys_work(card):
    """torch.profiler over PROFILE_STEPS CUDA steps: the device runs the
    library's memset of the own-slot table and its two kernels, and
    nothing else. A window that misses one of the three is taken again (up
    to PROFILE_TRIES, each printed); a window with any other device event
    fails at once; the assertions read the window kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ours = ("Memset", "own_scatter", "sparse_words_grid")
    args = random_inputs(257, 500, 450, seed=3, dev=card)
    sw.sparse_cell_words(*args, R=257, iso=0.0)  # build and load first
    for window in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                sw.sparse_cell_words(*args, R=257, iso=0.0)
            torch.cuda.synchronize()
        names = sorted(e.key for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        assert all(any(o in k for o in ours) for k in names), names
        missing = [o for o in ours if not any(o in k for k in names)]
        print(f"profiler window {window} of {PROFILE_TRIES}: {names}"
              + (f", missing {missing}" if missing else ""))
        if not missing:
            break
    assert len(names) == 3, names
    assert any("Memset" in k for k in names), names
    assert any("own_scatter" in k for k in names), names
    assert any("sparse_words_grid" in k for k in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("name,R", [("sphere", 65), ("box", 129),
                                    ("sphere", 257)])
def test_words_flow_equals_volume_flow_on_the_card(card, name, R):
    """Kernel = plain on a band of active cells with their neighbours
    present; then the compaction's blk and count equal the candidate scan's
    on the assembled volume, and the records from the words equal
    _extract_records on it byte for byte."""
    rows, cells, count, vol_c, vol = sparse_parts(name, R, card)
    words, bits, cand, own, guard = hold((rows, cells, count, vol_c), R)
    assert int(guard) == 0
    sids, n, blk = m._compact_block_bits(bits, cand, R, srow_tbl=own)
    ids, n_d, guard_d, blk_d = m._active_cells_from_coarse(vol, cells, 0.0)
    assert guard_d == 0 and n == n_d > 0 and torch.equal(blk, blk_d)
    rec, tq = m._records_from_words_sparse(words, sids, R)
    rec_d, tq_d = m._extract_records(vol, ids, 0.0)
    assert torch.equal(rec, rec_d) and torch.equal(tq, tq_d)


@pytest.mark.cuda
def test_iso_away_from_zero(card):
    """A non-zero iso goes to the kernel as f32, as the plain version
    compares in f32."""
    rows, cells, count, vol_c, _ = sparse_parts("sphere", 65, card)
    hold((rows, cells, count, vol_c), 65, iso=0.07)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    rows, ids, count, vol_c = random_inputs(65, 10, 10, seed=0, dev=card)
    with pytest.raises(ValueError, match="must be on"):
        sw.sparse_cell_words(rows, ids, count, vol_c.cpu(), R=65, iso=0.0)
    with pytest.raises(TypeError):
        sw.sparse_cell_words(rows.double(), ids, count, vol_c, R=65, iso=0.0)
    with pytest.raises(TypeError):
        sw.sparse_cell_words(rows, ids.long(), count, vol_c, R=65, iso=0.0)
    strided = torch.stack([rows, rows], 1)[:, 0]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        sw.sparse_cell_words(strided, ids, count, vol_c, R=65, iso=0.0)
    with pytest.raises(ValueError):
        sw.sparse_cell_words(rows[:-64], ids, count, vol_c, R=65, iso=0.0)
    with pytest.raises(ValueError):
        sw.sparse_cell_words(rows, ids, 11, vol_c, R=65, iso=0.0)
    with pytest.raises(ValueError):
        sw.sparse_cell_words(rows, ids, count, vol_c, R=129, iso=0.0)
