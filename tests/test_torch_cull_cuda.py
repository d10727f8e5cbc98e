"""K4 (csrc/band_cull.cu: tau and the active cells) and the block
compaction (csrc/block_compact.cu) on the card against their plain
versions on the same card, bit for bit: random, lattice and NaN grids, the
main path's 65^3 grid of its octahedron head, both cull modes, cap
overflow, both compaction forms and id kinds; the fixed-shape forms under
torch.cuda.set_sync_debug_mode("error"). Needs an NVIDIA GPU and nvcc;
skips without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cull_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.config import Config
from disn_tpu_torch.infer import sparse
from disn_tpu_torch.ops import band_cull, block_compact
from disn_tpu_torch.ops import marching as m

BOXES = {"unit": [-1, -1, -1, 1, 1, 1],
         "skewed": [-0.7, -1.1, -0.4, 0.9, 1.3, 0.8]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def grid(kind: str, rc: int, seed: int = 0) -> np.ndarray:
    """A seeded coarse grid [rc]^3 f32: noise around 0, the octahedron head's
    field |x|+|y|+|z| - 0.6 on the lattice (the main path's, at rc 65), a
    noisy sphere with corners at +-0.0, or noise with NaN and +-inf."""
    rng = np.random.RandomState(seed)
    lin = np.linspace(-1, 1, rc)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    if kind == "random":
        vol = 0.3 * rng.randn(rc, rc, rc)
    elif kind == "lattice":
        vol = np.abs(x) + np.abs(y) + np.abs(z) - 0.6
    elif kind == "zeros":
        vol = np.sqrt(x * x + y * y + z * z) - 0.5 + 0.02 * rng.randn(
            rc, rc, rc)
        vol[rng.rand(rc, rc, rc) < 0.05] = 0.0
        vol[rng.rand(rc, rc, rc) < 0.05] = -0.0
    elif kind == "nan":
        vol = 0.3 * rng.randn(rc, rc, rc)
        vol[rng.rand(rc, rc, rc) < 0.01] = np.nan
        vol[rng.rand(rc, rc, rc) < 0.005] = np.inf
        vol[rng.rand(rc, rc, rc) < 0.005] = -np.inf
    else:
        raise ValueError(kind)
    return vol.astype(np.float32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if bool(torch.isnan(a)) and bool(torch.isnan(b)):
        return True
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "lattice", "zeros", "nan"])
@pytest.mark.parametrize("rc", [13, 49, 65])
@pytest.mark.parametrize("box", ["unit", "skewed"])
def test_band_tau_equals_plain(card, kind, rc, box):
    """tau bit for bit, with and without autocal and on a binary config, at
    rc - 1 = 12, 48 and 64 (the host scalar's reciprocal is inexact at 12
    and 48); one library call a tau."""
    vol = torch.from_numpy(grid(kind, rc)).to(card)
    sp = torch.tensor(BOXES[box], dtype=torch.float32, device=card)
    for autocal, binary in ((True, False), (False, False), (True, True)):
        cfg = Config(band_autocal=autocal, binary=binary)
        before = band_cull.band_tau.launches
        got = sparse._band_tau(vol, sp, rc, 1.5, cfg)
        assert band_cull.band_tau.launches == before + 1
        want = sparse._band_tau_plain(vol, sp, rc, 1.5, cfg)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert same_bits(got, want), (autocal, binary, float(got),
                                      float(want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "lattice", "zeros", "nan"])
@pytest.mark.parametrize("rc", [17, 65])
@pytest.mark.parametrize("mode", ["band", "sign"])
def test_active_cells_equal_plain(card, kind, rc, mode):
    """ids and count bit for bit in both forms: exact, fixed with room,
    fixed past its cap (ids dropped, the count counting them), at the tau
    the card computes and at 0 (no band) and 10 (every cell)."""
    vol = torch.from_numpy(grid(kind, rc, seed=rc)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    c = rc - 1
    tau = sparse._band_tau_plain(vol, sp, rc, 1.5, Config())
    for t in (tau, torch.zeros((), device=card),
              torch.full((), 10.0, device=card)):
        want, n = sparse._active_cells_plain(vol, t, mode)
        before = band_cull.active_cells.launches
        got, n_got = sparse._active_cells(vol, t, mode)
        assert band_cull.active_cells.launches == before + 1
        assert n_got == n and torch.equal(got, want)
        for cap in (c ** 3, max(1, n // 2), 1):
            want_f, n_f = sparse._active_cells_plain(vol, t, mode, cap)
            got_f, n_fg = sparse._active_cells(vol, t, mode, cap)
            assert n_fg.dtype == torch.int32 and n_fg.dim() == 0
            assert int(n_fg) == int(n_f) == n
            assert torch.equal(got_f, want_f)


def block_inputs(E: int, density: float, seed: int, dev):
    """Seeded bits [B3^3, 2] int32 (a block holds bits with probability
    `density`, each bit with probability 1/3), cand [B3^3] bool (80%) and
    an own-slot table [c^3] int32 (half the cells, -1 elsewhere)."""
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
    return (torch.from_numpy(bits).to(dev), torch.from_numpy(cand).to(dev),
            torch.from_numpy(own).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("sparse_ids", [False, True])
@pytest.mark.parametrize("E,density,bcap", [
    (257, 0.06, 65536),   # the main path's grid, every block kept
    (257, 0.06, 16384),   # b2 = 8,192 rows, ~13,000 selected: overflow
    (65, 0.5, 4096),
    (33, 0.0, 1024),      # no change bit
    (17, 1.0, 256),
])
def test_compaction_equals_plain(card, sparse_ids, E, density, bcap):
    """ids, n, blk (and, capped, g_over with and without a guard on the
    card) bit for bit in both forms."""
    bits, cand, own = block_inputs(E, density, seed=E, dev=card)
    srow = own if sparse_ids else None
    before = block_compact.compact_block_bits.launches
    got = m._compact_block_bits(bits, cand, E, srow_tbl=srow)
    want = m._compact_block_bits_plain(bits, cand, E, srow_tbl=srow)
    assert got[1] == want[1] and torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    for guard in (torch.tensor(3, dtype=torch.int32, device=card), None):
        got = m._compact_block_bits(bits, cand, E, srow_tbl=srow, bcap=bcap,
                                    guard=guard)
        want = m._compact_block_bits_plain(bits, cand, E, srow_tbl=srow,
                                           bcap=bcap, guard=guard)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert block_compact.compact_block_bits.launches == before + 3


@pytest.mark.cuda
def test_fixed_forms_wait_for_nothing(card):
    """tau, the fixed-size cull and the capped compaction queue their work
    under set_sync_debug_mode("error"), as the speculative dispatch runs
    them."""
    vol = torch.from_numpy(grid("lattice", 65)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    bits, cand, own = block_inputs(257, 0.06, seed=1, dev=card)
    guard = torch.zeros((), dtype=torch.int32, device=card)
    cfg = Config()
    args = (vol, sp, 65, 1.5, cfg)
    want = (sparse._band_tau_plain(*args),
            m._compact_block_bits_plain(bits, cand, 257, own, 16384, guard))
    sparse._band_tau(*args)  # the builds and loads, outside the gate
    m._compact_block_bits(bits, cand, 257, own, 16384, guard)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tau = sparse._band_tau(*args)
        ids, count = sparse._active_cells(vol, tau, max_cells=65536)
        got = m._compact_block_bits(bits, cand, 257, own, 16384, guard)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert same_bits(tau, want[0])
    want_ids, want_n = sparse._active_cells_plain(vol, tau, max_cells=65536)
    assert torch.equal(ids, want_ids) and torch.equal(count, want_n)
    for a, b in zip(got, want[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_versions(card, monkeypatch):
    """The dispatchers send a CUDA tensor to the kernels, never to a plain
    version; phase_a's cull on the card is one tau and one cull call."""
    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    vol = torch.from_numpy(grid("random", 17)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    bits, cand, own = block_inputs(65, 0.5, seed=2, dev=card)
    for name in ("_band_tau_plain", "_active_cells_plain"):
        monkeypatch.setattr(sparse, name, refuse)
    monkeypatch.setattr(m, "_compact_block_bits_plain", refuse)
    tau = sparse._band_tau(vol, sp, 17, 1.5, Config())
    sparse._active_cells(vol, tau, "band")
    sparse._active_cells(vol, tau, "sign", max_cells=100)
    m._compact_block_bits(bits, cand, 65)
    m._compact_block_bits(bits, cand, 65, srow_tbl=own, bcap=1024)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    vol = torch.from_numpy(grid("random", 17)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    with pytest.raises(TypeError):
        band_cull.band_tau(vol.double(), sp, 17, 1.5, True)
    with pytest.raises(ValueError):
        band_cull.band_tau(vol.transpose(0, 2), sp, 17, 1.5, True)
    with pytest.raises(ValueError):
        band_cull.band_tau(vol, sp.double(), 17, 1.5, True)
    for tau in (torch.zeros(2, device=card), torch.tensor(0.15), 0.15,
                torch.tensor(0.15, dtype=torch.float64, device=card)):
        with pytest.raises(ValueError):
            band_cull.active_cells(vol, tau)
    bits, cand, _ = block_inputs(65, 0.5, seed=3, dev=card)
    with pytest.raises(TypeError):
        block_compact.compact_block_bits(bits, cand, 65, bcap=1024, guard=5)
    with pytest.raises(ValueError):
        block_compact.compact_block_bits(bits, cand, 61)
    with pytest.raises(ValueError):
        block_compact.compact_block_bits(bits, cand.int(), 65)


def launch_calls(fn) -> dict:
    """The runtime's kernel launch and copy calls in one fn(), by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if "LaunchKernel" in e.name or "Memcpy" in e.name:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def launches(calls: dict) -> int:
    return sum(n for k, n in calls.items() if "LaunchKernel" in k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "lattice", "zeros", "nan"])
@pytest.mark.parametrize("rc", [3, 9, 33, 100, 129])
@pytest.mark.parametrize("mode", ["band", "sign"])
def test_band_cull_equals_the_plain_pair(card, kind, rc, mode):
    """The fused entry (tau and the cull in one launch) against
    _band_tau_plain then _active_cells_plain, bit for bit: tau, ids and
    count in the exact form and the fixed form with room and past its cap,
    with and without autocal, on grids from 3^3 up to 129^3 (past the main
    path's 65^3), ragged at 100^3."""
    vol = torch.from_numpy(grid(kind, rc, seed=rc + 7)).to(card)
    sp = torch.tensor(BOXES["skewed"], dtype=torch.float32, device=card)
    c = rc - 1
    for autocal in (True, False):
        cfg = Config(band_autocal=autocal)
        want = sparse._band_cull_plain(vol, sp, rc, 1.5, cfg, mode)
        before = band_cull.band_cull.launches
        got = sparse._band_cull(vol, sp, rc, 1.5, cfg, mode)
        assert band_cull.band_cull.launches == before + 1
        assert same_bits(got[0], want[0])
        assert got[2] == want[2] and torch.equal(got[1], want[1])
        for cap in (c ** 3, max(1, want[2] // 2)):
            want_f = sparse._band_cull_plain(vol, sp, rc, 1.5, cfg, mode, cap)
            got_f = sparse._band_cull(vol, sp, rc, 1.5, cfg, mode, cap)
            assert same_bits(got_f[0], want_f[0])
            assert torch.equal(got_f[1], want_f[1])
            assert got_f[2].dtype == torch.int32 and got_f[2].dim() == 0
            assert torch.equal(got_f[2], want_f[2])


@pytest.mark.cuda
def test_one_launch_a_call(card):
    """The fused call (both forms), tau alone, the fixed-form cull and the
    capped compaction each make one kernel launch; the exact compaction at
    most two, and no copy call: its (b, n) come through mapped host
    memory."""
    vol = torch.from_numpy(grid("lattice", 65)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    cfg = Config()
    tau = sparse._band_tau(vol, sp, 65, 1.5, cfg)
    bits, cand, own = block_inputs(257, 0.06, seed=4, dev=card)
    guard = torch.zeros((), dtype=torch.int32, device=card)
    one = {
        "fused fixed": lambda: sparse._band_cull(vol, sp, 65, 1.5, cfg,
                                                 "band", 65536),
        "fused exact": lambda: sparse._band_cull(vol, sp, 65, 1.5, cfg),
        "fused sign": lambda: sparse._band_cull(vol, sp, 65, 1.5, cfg,
                                                "sign", 65536),
        "tau": lambda: sparse._band_tau(vol, sp, 65, 1.5, cfg),
        "cull fixed": lambda: sparse._active_cells(vol, tau, "band", 65536),
        "compact capped": lambda: m._compact_block_bits(
            bits, cand, 257, own, 16384, guard)}
    for name, fn in one.items():
        fn()
        calls = launch_calls(fn)
        assert launches(calls) == 1, (name, calls)
        assert not any("Memcpy" in k for k in calls), (name, calls)
    calls = launch_calls(lambda: m._compact_block_bits(bits, cand, 257))
    assert 1 <= launches(calls) <= 2, calls
    assert not any("Memcpy" in k for k in calls), calls


@pytest.mark.cuda
@pytest.mark.parametrize("sparse_ids", [False, True])
@pytest.mark.parametrize("case", ["b2 exactly", "b2 past by one",
                                  "no change bit", "every block"])
def test_compaction_edges_equal_plain(card, sparse_ids, case):
    """The capped compaction at its b2 boundary (exactly b2 selected
    blocks, and one more), with no change bit, and with every block
    selected with every bit; the exact form beside it; bit for bit."""
    E = 129
    bits, cand, own = block_inputs(E, 0.3, seed=5, dev=card)
    nb = bits.shape[0]
    sel = cand & ((bits[:, 0] | bits[:, 1]) != 0)
    bcap = 1024  # b2 = 512 rows
    if case.startswith("b2"):
        keep = torch.nonzero(sel)[:, 0][:512 + (case == "b2 past by one")]
        cand = torch.zeros_like(cand)
        cand[keep] = True
    elif case == "no change bit":
        bits = torch.zeros_like(bits)
    else:
        bits = torch.full_like(bits, -1)
        cand = torch.ones_like(cand)
        bcap = 2 * nb
    srow = own if sparse_ids else None
    guard = torch.tensor(2, dtype=torch.int32, device=card)
    got = m._compact_block_bits(bits, cand, E, srow, bcap, guard)
    want = m._compact_block_bits_plain(bits, cand, E, srow, bcap, guard)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got = m._compact_block_bits(bits, cand, E, srow)
    want = m._compact_block_bits_plain(bits, cand, E, srow)
    assert got[1] == want[1] and torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_same_bits_over_repeats(card):
    """Ten repeats of the fused cull (fixed form) and of the capped
    compaction give the same output bits: no atomics, nothing carried from
    one launch to the next."""
    vol = torch.from_numpy(grid("random", 65, seed=3)).to(card)
    sp = torch.tensor(BOXES["unit"], dtype=torch.float32, device=card)
    bits, cand, own = block_inputs(257, 0.06, seed=6, dev=card)
    guard = torch.zeros((), dtype=torch.int32, device=card)
    first = None
    for _ in range(10):
        tau, ids, n = sparse._band_cull(vol, sp, 65, 1.5, Config(), "band",
                                        65536)
        out = (tau.view(torch.int32).clone(), ids.clone(), n.clone(),
               *(t.clone() for t in m._compact_block_bits(
                   bits, cand, 257, own, 16384, guard)))
        if first is None:
            first = out
        assert all(torch.equal(a, b) for a, b in zip(out, first))
