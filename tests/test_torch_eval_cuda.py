"""K6a-K6d (csrc/metrics.cu) against their plain PyTorch versions on the
card, at small and ragged shapes. Needs an NVIDIA GPU and nvcc; skips
without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.eval import metrics as mt
from disn_tpu_torch.eval import referee

EPS32 = 2.0 ** -23
NN_ULPS = 8           # a.b and the Gram sum rounded in another order
EMD_REL_TOL = 1e-3    # the level -16384 amplification of those roundings
MARGINAL_TOL = 1e-3
SUM_REL_TOL = 1e-4    # n * eps of the sums of |terms| for n <= 2048
SHAPES = [(1, 1, 1), (2, 5, 3), (3, 256, 100), (3, 100, 256), (2, 257, 191),
          (4, 512, 512), (1, 1000, 2047)]


def clouds(b, n, m, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.RandomState(seed + 7 * n + m)
    return (torch.from_numpy((0.5 * rng.randn(b, n, 3)).astype(np.float32)
                             ).cuda(),
            torch.from_numpy((0.5 * rng.randn(b, m, 3)).astype(np.float32)
                             ).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SHAPES)
def test_nn_distance_kernel_matches_plain(b, n, m):
    x, y = clouds(b, n, m)
    before = mt.nn_distance.launches
    got, want = mt.nn_distance(x, y), mt.nn_distance_plain(x, y)
    assert mt.nn_distance.launches == before + 1
    tol = NN_ULPS * EPS32 * float((x * x).sum(-1).max()
                                  + (y * y).sum(-1).max())
    for k in (0, 2):
        assert float((got[k] - want[k]).abs().max()) <= tol
    for k, (a, c) in ((1, (x, y)), (3, (y, x))):
        assert got[k].dtype == torch.int32
        # an index may differ only where the two candidates are a near-tie
        rows = torch.nonzero(got[k] != want[k], as_tuple=True)
        if len(rows[0]):
            p = a[rows].double()
            da = ((p - c[rows[0], got[k][rows].long()].double()) ** 2).sum(-1)
            dp = ((p - c[rows[0], want[k][rows].long()].double()) ** 2).sum(-1)
            assert float((da - dp).abs().max()) <= tol


@pytest.mark.cuda
def test_nn_distance_kernel_ties_take_the_lowest_index():
    x, y = clouds(2, 64, 48)
    y[:, 30] = y[:, 4]
    y[:, 47] = y[:, 4]
    got = mt.nn_distance(x, y)
    want = mt.nn_distance_plain(x, y)
    assert torch.equal(got[1], want[1])
    assert not ((got[1] == 30) | (got[1] == 47)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SHAPES)
def test_approx_match_kernel_matches_plain(b, n, m):
    x, y = clouds(b, n, m, seed=1)
    before = mt.approx_match.launches
    got, want = mt.approx_match(x, y), mt.approx_match_plain(x, y)
    assert mt.approx_match.launches == before + 1
    assert got.shape == (b, m, n) and bool((got >= 0).all())
    ck, cp = mt.match_cost_plain(x, y, got), mt.match_cost_plain(x, y, want)
    assert float(((ck - cp).abs() / cp.abs().clamp_min(1e-30)).max()) \
        <= EMD_REL_TOL
    assert float((got.sum(1) - want.sum(1)).abs().max()) <= MARGINAL_TOL
    assert float((got.sum(2) - want.sum(2)).abs().max()) <= MARGINAL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SHAPES)
def test_match_cost_kernel_and_gradient_match_plain(b, n, m):
    x, y = clouds(b, n, m, seed=2)
    match = mt.approx_match(x, y)
    before = (mt.match_cost.launches, mt.match_cost_grad.launches)
    got = mt.match_cost(x, y, match)
    want = mt.match_cost_plain(x, y, match)
    assert float((got - want).abs().max()) <= \
        SUM_REL_TOL * float(want.abs().max()) + 1e-7
    g = torch.linspace(0.5, 1.5, b, device="cuda")
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    (mt.match_cost(xr, yr, match) * g).sum().backward()
    assert (mt.match_cost.launches, mt.match_cost_grad.launches) == \
        (before[0] + 2, before[1] + 1)
    w1, w2 = mt.match_cost_grad_plain(x, y, match, g)
    scale = float(g.max()) * max(float(match.sum(1).max()),
                                 float(match.sum(2).max()))
    assert float((xr.grad - w1).abs().max()) <= SUM_REL_TOL * scale
    assert float((yr.grad - w2).abs().max()) <= SUM_REL_TOL * scale


@pytest.mark.cuda
def test_nn_distance_backward_on_the_card_matches_the_cpu():
    """The gather and index_add_ backward (atomics in any order)."""
    x, y = clouds(3, 300, 200, seed=3)
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    d1, i1, d2, i2 = mt.nn_distance(xr, yr)
    w1 = torch.linspace(0, 1, 300, device="cuda").expand(3, -1)
    w2 = torch.linspace(1, 2, 200, device="cuda").expand(3, -1)
    ((d1 * w1).sum() + (d2 * w2).sum()).backward()
    cpu = mt.nn_distance_backward(x.cpu(), y.cpu(), i1.cpu(), i2.cpu(),
                                  w1.cpu().contiguous(), w2.cpu().contiguous())
    for got, want in zip((xr.grad, yr.grad), cpu):
        assert float((got.cpu() - want).abs().max()) <= \
            1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_chamfer_emd_and_f_score_on_the_card_match_the_cpu():
    x, y = clouds(4, 700, 650, seed=4)
    card = mt.chamfer_emd(x, y)
    cpu = mt.chamfer_emd(x.cpu(), y.cpu())
    for k in ("cd", "emd"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-3, atol=0)
    th = np.array([0.05, 0.1, 0.2], np.float32)
    fc, fh = mt.f_score(x, y, th), mt.f_score(x.cpu(), y.cpu(), th)
    for k in ("precision", "recall"):
        assert float((fc[k].cpu() - fh[k]).abs().max()) <= 1 / 650


REFEREE_CASES = ([(b, n, m, 1) for b, n, m in referee.SHAPES]
                 + [(b, n, m, s) for b, n, m in referee.SEEDED
                    for s in range(4)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m,seed", REFEREE_CASES)
def test_approx_match_kernel_against_the_float64_referee(b, n, m, seed):
    """K6b's marginals per xyz1 and per xyz2 point and its EMD no further
    from the float64 plain version than RATIO x the f32 plain version's
    distance + ABS (eval/referee.py), B = 1 with N > M and N < M among
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    x, y = referee.clouds(b, n, m, seed)
    ref = referee.referee(x, y)
    dk = referee.distance(mt.approx_match(x, y), ref)
    dp = referee.distance(mt.approx_match_plain(x, y), ref)
    assert referee.within(dk, dp), (dk, dp)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(3, 2047, 1537), (24, 2048, 2048)])
def test_approx_match_kernel_gives_the_same_bits_twice(b, n, m):
    x, y = clouds(b, n, m, seed=5)
    assert torch.equal(mt.approx_match(x, y), mt.approx_match(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("scale,n,m", [(0.5, 128, 512), (3.0, 100, 300),
                                       (1e-3, 128, 512), (40.0, 7, 5)])
def test_approx_match_d_is_gram_d(scale, n, m):
    """d as K6b's row pass, match and column pass compute it (the other
    cloud staged as -2 p) equals gram_d(dot3) of K6a and K6c bit for bit,
    with a duplicated point (d near 0, clamped) among them."""
    x, y = clouds(1, n, m, seed=int(scale * 10) + n)
    x, y = (scale * x[0]).contiguous(), (scale * y[0]).contiguous()
    y[3] = x[2]
    tile = mt.approx_match_d_tile(x, y)
    assert tile.shape == (3, min(n, 128), min(m, 512))
    assert torch.equal(tile[0], tile[2]) and torch.equal(tile[1], tile[2])


@pytest.mark.cuda
@pytest.mark.parametrize("scale,n,m", [(0.5, 128, 512), (3.0, 100, 300),
                                       (1e-3, 128, 512), (40.0, 7, 5),
                                       (0.5, 1, 1)])
def test_nn_distance_kernel_is_the_gram_d_tiles_lowest_minimum(scale, n, m):
    """K6a's dist and idx both ways equal, bit for bit, the lowest-index
    min/argmin of the kernel's own gram_d tile (approx_match_d_tile(...)[2])
    with points of xyz1 copied into xyz2 (d near 0 or clamped to it, two
    equal candidates for a row) and points of xyz2 repeated (exact ties)."""
    x, y = clouds(1, n, m, seed=int(scale * 10) + n + 11)
    x, y = (scale * x[0]).contiguous(), (scale * y[0]).contiguous()
    if n > 3 and m > 4:
        y[1], y[3] = x[2], x[2]
        y[4] = y[1]
        y[m - 1] = y[0]
    tile = mt.approx_match_d_tile(x, y)[2]
    assert tile.shape == (n, m)
    got = mt.nn_distance(x[None], y[None])
    want = (tile.min(1).values, tile.argmin(1).int(), tile.min(0).values,
            tile.argmin(0).int())
    for k in range(4):
        assert torch.equal(got[k][0].view(torch.int32),
                           want[k].view(torch.int32)), k
    if n > 3 and m > 4:  # the copies of x[2] tie: the lower index wins
        assert int(got[1][0, 2]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.5, 1.0, 40.0, 1e-3])
def test_kernel_norms_are_sq_bit_for_bit(scale):
    """K6a and K6c compute |p|^2 themselves (sq3); its bits are _sq's (the
    plain versions' torch.sum(p * p, -1) on the card), on random clouds
    and on mesh-like ones (grid points k/128 - 1)."""
    x, y = clouds(24, 2048, 2047, seed=int(scale * 100))
    grid = torch.from_numpy((np.random.RandomState(9).randint(
        0, 257, (24, 2048, 3)) / 128.0 - 1.0).astype(np.float32)).cuda()
    for c in (scale * x, scale * y, grid, (grid * 0.6).contiguous()):
        c = c.contiguous()
        assert torch.equal(mt.kernel_norms(c).view(torch.int32),
                           mt._sq(c).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(3, 2047, 1537), (24, 2048, 2048)])
def test_nn_distance_kernel_gives_the_same_bits_twice(b, n, m):
    x, y = clouds(b, n, m, seed=6)
    one, two = mt.nn_distance(x, y), mt.nn_distance(x, y)
    for u, v in zip(one, two):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(3, 2047, 1537), (24, 2048, 2048)])
def test_match_cost_kernel_gives_the_same_bits_twice(b, n, m):
    x, y = clouds(b, n, m, seed=7)
    match = mt.approx_match(x, y)
    assert torch.equal(mt.match_cost(x, y, match), mt.match_cost(x, y, match))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SHAPES + [(3, 2047, 1537),
                                            (24, 2048, 2048)])
def test_match_cost_kernel_against_float64(b, n, m):
    """K6c's total no further from match_cost_plain in float64, on the same
    match, than 2x the f32 plain version's distance + 1e-6 relative."""
    x, y = clouds(b, n, m, seed=8)
    match = mt.approx_match(x, y)
    ref = mt.match_cost_plain(x.double(), y.double(), match.double())
    dk = (mt.match_cost(x, y, match).double() - ref).abs()
    dp = (mt.match_cost_plain(x, y, match).double() - ref).abs()
    assert bool((dk <= 2.0 * dp + 1e-6 * ref.abs()).all()), (dk, dp, ref)


@pytest.mark.cuda
def test_match_cost_kernel_reads_an_unaligned_match():
    """The scalar walk: a match that does not start on 16 bytes (n % 4 ==
    0, so only the pointer decides) gives the aligned walk's cost."""
    x, y = clouds(2, 256, 100, seed=9)
    match = mt.approx_match(x, y)
    buf = torch.empty(match.numel() + 1, device="cuda")
    shifted = buf[1:].view_as(match)
    shifted.copy_(match)
    got, want = mt.match_cost(x, y, shifted), mt.match_cost(x, y, match)
    assert float((got - want).abs().max()) <= \
        SUM_REL_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["nn_distance", "match_cost",
                                    "match_cost_grad"])
def test_one_call_is_only_the_librarys_work(kernel):
    """torch.profiler over calls of the public wrapper: the device runs the
    library's work and nothing else (K6a: the keys' memset, nn_pass,
    nn_unpack; K6c: mc_pass, mc_total; K6d: mc_grad_pass, mc_grad_total),
    no PyTorch op's kernel. The profiler does not record every event of a
    window (the first is sometimes missing), so it watches 3 calls and a
    kernel need only be seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, y = clouds(3, 500, 400, seed=10)
    if kernel == "nn_distance":
        call, kerns = lambda: mt.nn_distance(x, y), ("nn_pass", "nn_unpack")
    elif kernel == "match_cost":
        match = mt.approx_match(x, y)
        call, kerns = (lambda: mt.match_cost(x, y, match),
                       ("mc_pass", "mc_total"))
    else:
        match = mt.approx_match(x, y)
        g = torch.linspace(0.5, 1.5, 3, device="cuda")
        call, kerns = (lambda: mt.match_cost_grad(x, y, match, g),
                       ("mc_grad_pass", "mc_grad_total"))
    call()  # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    names = sorted(e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    assert all(any(o in k for o in ("Memset", *kerns)) for k in names), names
    assert all(any(o in k for k in names) for o in kerns), names


def _hold_grad(x, y, match, g):
    """K6d on these inputs within SUM_REL_TOL x max|g| x max marginal of
    its plain version, and within referee.RATIO x the plain version's
    distance from the float64 referee + referee.GRAD_ULPS ulps of the
    scale (eval/referee.py); returns the kernel's gradients."""
    got = mt.match_cost_grad(x, y, match, g)
    want = mt.match_cost_grad_plain(x, y, match, g)
    scale = float(g.abs().max()) * max(float(match.sum(1).max()),
                                       float(match.sum(2).max()))
    for u, v in zip(got, want):
        assert u.shape == v.shape
        assert float((u - v).abs().max()) <= SUM_REL_TOL * scale
    ref = referee.grad_referee(x, y, match, g)
    dk, dp = (referee.grad_distance(t, ref) for t in (got, want))
    assert referee.grad_within(dk, dp, ref), (dk, dp)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SHAPES)
def test_match_cost_grad_kernel_against_the_float64_referee(b, n, m):
    x, y = clouds(b, n, m, seed=12)
    _hold_grad(x, y, mt.approx_match(x, y),
               torch.linspace(0.5, 1.5, b, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(3, 1, 300), (3, 300, 1), (2, 1, 1),
                                   (2, 1001, 64), (2, 1022, 130),
                                   (1, 3, 700), (2, 2047, 513)])
def test_match_cost_grad_kernel_single_points_and_ragged_n(b, n, m):
    """N = 1 or M = 1 (a gradient entry of a single term), and n % 4 != 0
    (rows that do not start on 16 bytes: the scalar walk)."""
    x, y = clouds(b, n, m, seed=13)
    _hold_grad(x, y, mt.approx_match(x, y),
               torch.linspace(0.5, 1.5, b, device="cuda"))


@pytest.mark.cuda
def test_match_cost_grad_kernel_coincident_points():
    """Points of xyz2 that are copies of points of xyz1: a zero difference
    gives a zero term, as in the plain version (unit(0) = 0)."""
    x, y = clouds(2, 300, 200, seed=14)
    y[:, ::7] = x[:, :29]
    y[1, 5] = x[1, 299]
    match = mt.approx_match(x, y)
    got = _hold_grad(x, y, match, torch.tensor([0.8, 1.2], device="cuda"))
    assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.mark.cuda
def test_match_cost_grad_kernel_negative_and_zero_g():
    x, y = clouds(3, 256, 100, seed=15)
    match = mt.approx_match(x, y)
    g = torch.tensor([-1.3, 0.0, 0.7], device="cuda")
    g1, g2 = _hold_grad(x, y, match, g)
    assert not bool(g1[1].any()) and not bool(g2[1].any())


@pytest.mark.cuda
def test_match_cost_grad_kernel_reads_an_unaligned_match():
    """The scalar walk: a match that does not start on 16 bytes (n % 4 ==
    0, so only the pointer decides) gives the aligned walk's bits, as both
    walks do the same arithmetic."""
    x, y = clouds(2, 256, 100, seed=16)
    match = mt.approx_match(x, y)
    buf = torch.empty(match.numel() + 1, device="cuda")
    shifted = buf[1:].view_as(match)
    shifted.copy_(match)
    g = torch.tensor([0.9, 1.1], device="cuda")
    for u, v in zip(_hold_grad(x, y, shifted, g),
                    mt.match_cost_grad(x, y, match, g)):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", [(3, 2047, 1537), (24, 2048, 2048)])
def test_match_cost_grad_kernel_gives_the_same_bits_twice(b, n, m):
    x, y = clouds(b, n, m, seed=17)
    match = mt.approx_match(x, y)
    g = torch.linspace(0.5, 1.5, b, device="cuda")
    for u, v in zip(mt.match_cost_grad(x, y, match, g),
                    mt.match_cost_grad(x, y, match, g)):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_match_cost_backward_launches_match_cost_grad_once():
    """One match_cost_grad launch a backward, whichever clouds record."""
    x, y = clouds(2, 300, 200, seed=18)
    match = mt.approx_match(x, y)
    for grads in ((True, True), (True, False), (False, True)):
        xr, yr = (c.clone().requires_grad_(r) for c, r in zip((x, y), grads))
        before = mt.match_cost_grad.launches
        mt.match_cost(xr, yr, match).sum().backward()
        assert mt.match_cost_grad.launches == before + 1
