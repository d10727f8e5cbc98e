"""disn_tpu_torch's evaluation metrics (K6a-K6d through their plain
versions, and the protocol metrics around them) against disn_tpu's, in f32
on the CPU from the same numpy-seeded clouds, and the cases of
tests/test_metrics.py on the port."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.eval import metrics as jm
from disn_tpu_torch.eval import metrics as tm
from torch_threads import few_threads  # noqa: F401  (autouse)

EPS32 = 2.0 ** -23
# nearest-neighbour distances: a.b and the Gram sum (|a|^2 - 2a.b) + |b|^2
# rounded in another order cost at most a few ulps of |a|^2 + |b|^2
NN_ULPS = 8
# approx_match: exp(level * d) at level -16384 turns a difference delta in
# d into a relative 16384 * delta in e; on top of that, the einsums' f32
# summation order (1e-5 relative)
LEVEL0 = 16384.0
SUM_REL = 1e-5


def clouds(b, n, m, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return ((scale * rng.randn(b, n, 3)).astype(np.float32),
            (scale * rng.randn(b, m, 3)).astype(np.float32))


def t(x):
    return torch.from_numpy(np.array(x))


SHAPES = [(2, 64, 48), (3, 200, 100), (3, 100, 200), (2, 127, 97),
          (4, 256, 256), (1, 1, 1)]


def _nn_tol(a, c):
    return NN_ULPS * EPS32 * float((a * a).sum(-1).max() + (c * c).sum(-1).max())


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_nn_distance_matches_jax(b, n, m):
    a, c = clouds(b, n, m, seed=n + m)
    want = [np.asarray(x) for x in jm.nn_distance(jnp.asarray(a),
                                                  jnp.asarray(c))]
    got = [x.numpy() for x in tm.nn_distance(t(a), t(c))]
    tol = _nn_tol(a, c)
    for k in (0, 2):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol)
    assert got[1].dtype == np.int32 and got[3].dtype == np.int32
    # indices: equal unless the two candidates are within the tolerance
    for k, (x, y) in ((1, (a, c)), (3, (c, a))):
        bi, ri = np.nonzero(got[k] != want[k])
        d = lambda j: ((x[bi, ri].astype(np.float64)  # noqa: E731
                        - y[bi, j].astype(np.float64)) ** 2).sum(-1)
        assert np.all(np.abs(d(got[k][bi, ri]) - d(want[k][bi, ri])) <= tol)


def test_nn_distance_oracle_and_ties():
    """The brute-force oracle of tests/test_metrics.py, and the lowest
    index on an exact tie (a duplicated point)."""
    a, c = clouds(2, 64, 48, seed=0, scale=1.0)
    c[:, 7] = c[:, 3]
    d1, i1, d2, i2 = (x.numpy() for x in tm.nn_distance(t(a), t(c)))
    full = ((a[:, :, None].astype(np.float64) - c[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(d1, full.min(-1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d2, full.min(-2), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(i1, full.argmin(-1))
    np.testing.assert_array_equal(i2, full.argmin(-2))
    assert not (i1 == 7).any()


@pytest.mark.parametrize("b,n,m", [(2, 64, 48), (1, 16, 16), (3, 50, 70)])
def test_nn_distance_gradients_match_jax(b, n, m):
    """Both directions' distances weighted by seeded cotangents: the port's
    backward (gather + index_add_) against jax.grad through the reference's
    custom VJP; f32 summation order."""
    a, c = clouds(b, n, m, seed=3 + n)
    rng = np.random.RandomState(9)
    w1, w2 = rng.rand(b, n).astype(np.float32), rng.rand(b, m).astype(
        np.float32)

    def jloss(x, y):
        d1, _, d2, _ = jm.nn_distance(x, y)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    ja, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(c))
    x, y = t(a).requires_grad_(True), t(c).requires_grad_(True)
    d1, _, d2, _ = tm.nn_distance(x, y)
    ((d1 * t(w1)).sum() + (d2 * t(w2)).sum()).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)


def test_nn_distance_gradient_numeric():
    """tests/test_metrics.py's finite-difference check on the port."""
    a, c = clouds(1, 16, 16, seed=1, scale=1.0)
    x = t(a).double().float()

    def loss(p):
        d1, _, d2, _ = tm.nn_distance(p, t(c))
        return float(d1.sum() + d2.sum())

    xr = x.clone().requires_grad_(True)
    d1, _, d2, _ = tm.nn_distance(xr, t(c))
    (d1.sum() + d2.sum()).backward()
    base = loss(x)
    for (i, j, k) in [(0, 3, 1), (0, 7, 2)]:
        xp = x.clone()
        xp[i, j, k] += 1e-3
        assert abs((loss(xp) - base) / 1e-3 - float(xr.grad[i, j, k])) < 5e-2


@pytest.mark.parametrize("b,n,m", SHAPES)
def test_approx_match_matches_jax(b, n, m):
    """The cost (the EMD) and match's row and column marginals. The
    tolerance is the einsums' summation order plus the level -16384
    amplification of the largest difference between the two packages'
    squared distances (0 when they agree bit for bit)."""
    a, c = clouds(b, n, m, seed=2 * n + m)
    ja, jc = jnp.asarray(a), jnp.asarray(c)
    want = np.asarray(jm.approx_match(ja, jc))
    got = tm.approx_match(t(a), t(c)).numpy()
    assert got.shape == (b, m, n) and (got >= 0).all()
    delta = float(np.abs(np.asarray(jm._pairwise_sqdist(ja, jc))
                         - tm._pairwise_sqdist(t(a), t(c)).numpy()).max())
    tol = SUM_REL + LEVEL0 * delta
    mass = max(1, m // n, n // m)
    np.testing.assert_allclose(got.sum(1), want.sum(1), rtol=0,
                               atol=tol * mass)
    np.testing.assert_allclose(got.sum(2), want.sum(2), rtol=0,
                               atol=tol * mass)
    cost_j = np.asarray(jm.match_cost(ja, jc, jnp.asarray(want)))
    cost_t = tm.match_cost(t(a), t(c), t(got)).numpy()
    np.testing.assert_allclose(cost_t, cost_j, rtol=tol, atol=1e-7)


def test_approx_match_mass_and_emd_sanity():
    """tests/test_metrics.py's auction checks on the port: all mass moved,
    identical clouds cost little, a translated cloud costs about n |t|."""
    x1, _ = clouds(1, 128, 128, seed=2, scale=1.0)
    mm = tm.approx_match(t(x1), t(clouds(1, 128, 128, seed=2, scale=1.0)[1])
                         ).numpy()[0]
    np.testing.assert_allclose(mm.sum(axis=0), 1.0, atol=0.05)
    np.testing.assert_allclose(mm.sum(axis=1), 1.0, atol=0.05)
    x3, _ = clouds(1, 128, 128, seed=3, scale=1.0)
    m3 = tm.approx_match(t(x3), t(x3))
    assert float(tm.match_cost(t(x3), t(x3), m3)[0]) < 0.05 * 128
    x4, _ = clouds(1, 64, 64, seed=4, scale=1.0)
    x5 = x4 + np.array([0.5, 0, 0], np.float32)
    m4 = tm.approx_match(t(x4), t(x5))
    cost = float(tm.match_cost(t(x4), t(x5), m4)[0])
    assert 64 * 0.5 * 0.9 <= cost <= 64 * 0.5 * 1.6


@pytest.mark.parametrize("b,n,m", [(2, 64, 48), (3, 100, 200), (1, 1, 1)])
def test_match_cost_and_gradients_match_jax(b, n, m):
    """The same match into both: the cost, and the gradients wrt both clouds
    against jax.grad through the reference's custom VJP (f32 summation
    order)."""
    a, c = clouds(b, n, m, seed=5 + m)
    match = np.asarray(jm.approx_match(jnp.asarray(a), jnp.asarray(c)))
    g = (np.random.RandomState(2).rand(b) + 0.5).astype(np.float32)

    def jloss(x, y):
        return jnp.sum(jm.match_cost(x, y, jnp.asarray(match)) * g)

    want = np.asarray(jm.match_cost(jnp.asarray(a), jnp.asarray(c),
                                    jnp.asarray(match)))
    ja, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(c))
    x, y = t(a).requires_grad_(True), t(c).requires_grad_(True)
    cost = tm.match_cost(x, y, t(match))
    np.testing.assert_allclose(cost.detach().numpy(), want, rtol=SUM_REL)
    (cost * t(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ja), rtol=SUM_REL,
                               atol=1e-6)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(jc), rtol=SUM_REL,
                               atol=1e-6)
    # the gradient entry point itself, as the kernel is called
    g1, g2 = tm.match_cost_grad(t(a), t(c), t(match), t(g))
    np.testing.assert_array_equal(g1.numpy(), x.grad.numpy())
    np.testing.assert_array_equal(g2.numpy(), y.grad.numpy())


def test_match_cost_gradient_numeric():
    x1, x2 = clouds(1, 12, 12, seed=5, scale=1.0)
    m = tm.approx_match(t(x1), t(x2))
    xr = t(x1).requires_grad_(True)
    tm.match_cost(xr, t(x2), m).sum().backward()
    base = float(tm.match_cost(t(x1), t(x2), m).sum())
    xp = x1.copy()
    xp[0, 4, 0] += 1e-3
    num = (float(tm.match_cost(t(xp), t(x2), m).sum()) - base) / 1e-3
    assert abs(num - float(xr.grad[0, 4, 0])) < 5e-2


@pytest.mark.parametrize("b,n,m", [(2, 32, 32), (3, 100, 60)])
def test_chamfer_emd_matches_jax(b, n, m):
    pred, gt = clouds(b, n, m, seed=6 + n)
    want = jm.chamfer_emd(jnp.asarray(pred), jnp.asarray(gt))
    got = tm.chamfer_emd(t(pred), t(gt))
    for k in ("cd", "emd"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5)
    d1, _, d2, _ = tm.nn_distance(t(pred), t(gt))
    np.testing.assert_allclose(got["cd"].numpy(),
                               (d1.mean(-1) + d2.mean(-1)).numpy() * 1000.0,
                               rtol=1e-6)


def test_f_score_matches_jax():
    pred, gt = clouds(3, 150, 120, seed=8, scale=0.3)
    th = np.asarray([0.5, 1, 2, 5, 10, 20], np.float32) * 0.01 * 2.5
    want = jm.f_score(jnp.asarray(pred), jnp.asarray(gt), th)
    got = tm.f_score(t(pred), t(gt), th)
    # the same counts of points within each threshold (the means may round
    # differently)
    for k, n in (("precision", 150), ("recall", 120)):
        np.testing.assert_array_equal(np.rint(got[k].numpy() * n),
                                      np.rint(np.asarray(want[k]) * n))
    np.testing.assert_allclose(got["f1"].numpy(), np.asarray(want["f1"]),
                               rtol=1e-6)


def test_f_score_formula():
    """tests/test_metrics.py's lattice case on the port."""
    g = np.stack(np.meshgrid(*[np.arange(3) * 0.5] * 3, indexing="ij"),
                 -1).reshape(1, 27, 3).astype(np.float32)
    out = tm.f_score(t(g), t(g + np.float32(0.05)),
                     np.array([0.05, 0.1], np.float32))
    assert float(out["precision"][0, 0]) == 0.0
    assert float(out["f1"][1, 0]) == pytest.approx(1.0)


def test_iou_volumes_matches_jax():
    rng = np.random.RandomState(4)
    a, b = rng.rand(2, 9, 9, 9) > 0.6, rng.rand(2, 9, 9, 9) > 0.5
    b[1] = False
    a[1] = False
    want = np.asarray(jm.iou_volumes(jnp.asarray(a), jnp.asarray(b)))
    got = tm.iou_volumes(a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == 0.0


def _mesh(seed):
    rng = np.random.RandomState(seed)
    verts = rng.randn(300, 3).astype(np.float32)
    faces = rng.randint(0, 300, (500, 3)).astype(np.int32)
    return verts, faces


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [64, 2048])
def test_samplers_bit_for_bit(seed, n):
    """The same RandomState gives the same points in both packages (with
    and without replacement for the vertex sampler)."""
    verts, faces = _mesh(seed)
    for fn_j, fn_t, args in (
            (jm.sample_mesh_surface, tm.sample_mesh_surface, (verts, faces)),
            (jm.sample_mesh_vertices, tm.sample_mesh_vertices, (verts,))):
        want = fn_j(*args, n, np.random.RandomState(seed))
        got = fn_t(*args, n, np.random.RandomState(seed))
        assert got.dtype == np.float32 and got.shape == (n, 3)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.sample_mesh_vertices(verts, 100),
                                  jm.sample_mesh_vertices(verts, 100))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a, c = clouds(2, 8, 6, seed=0)
    with pytest.raises(TypeError):
        tm.nn_distance(t(a).double(), t(c).double())
    with pytest.raises(ValueError, match="contiguous"):
        tm.approx_match(t(a).transpose(0, 1).contiguous().transpose(0, 1),
                        t(c))
    with pytest.raises(ValueError, match="clouds"):
        tm.approx_match(t(a), t(c[:1]))
    with pytest.raises(ValueError, match="match must be"):
        tm.match_cost(t(a), t(c), torch.zeros(2, 8, 6))
    # no fallback: a device that is neither the CPU nor a card raises
    meta = torch.empty(2, 8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tm.nn_distance(meta, meta)
