"""K6d (match_cost_grad) on the CPU: the port's gradient against disn_tpu's
(jax.grad through match_cost's custom VJP, _mc_bwd) with coincident points
and negative or zero g at ragged shapes; its float64 referee
(disn_tpu_torch/eval/referee.py) is float64 throughout and its gate says
what it should; and the sources hold K6d to that referee on the card
(chip_smoke.py, tests/test_torch_eval_cuda.py) with one read of match."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from disn_tpu.eval import metrics as jm
from disn_tpu_torch import kernels
from disn_tpu_torch.eval import metrics as tm
from disn_tpu_torch.eval import referee
from torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
# the gradient's entries sum up to M (or N) match-weighted unit vectors in
# another f32 order than XLA's: 1e-5 relative, and 1e-6 absolute for the
# entries whose terms cancel (tests/test_torch_eval.py's gradient tolerance)
SUM_REL = 1e-5
SUM_ABS = 1e-6


def inputs(b, n, m, case, seed):
    """Clouds (0.5 randn), the JAX auction's match on them, and g."""
    rng = np.random.RandomState(seed)
    a = (0.5 * rng.randn(b, n, 3)).astype(np.float32)
    c = (0.5 * rng.randn(b, m, 3)).astype(np.float32)
    if "coincident" in case:  # every third point of xyz2 a point of xyz1
        k = min(len(range(0, m, 3)), n)
        c[:, :3 * k:3] = a[:, :k]
    g = (rng.rand(b) + 0.5).astype(np.float32)
    if "negative" in case:
        g[::2] *= -1
    if "zero" in case:
        g[-1] = 0.0
    match = np.asarray(jm.approx_match(jnp.asarray(a), jnp.asarray(c)))
    return a, c, match, g


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,n,m,case", [
    (2, 45, 23, "coincident"), (1, 23, 45, "coincident"),
    (3, 70, 31, "negative g"), (2, 31, 70, "coincident, negative g"),
    (3, 37, 53, "coincident, zero g"), (2, 1, 9, "negative g"),
    (2, 9, 1, "coincident, negative g")])
def test_match_cost_grad_matches_jax(b, n, m, case):
    a, c, match, g = inputs(b, n, m, case, seed=n + 5 * m)

    def jloss(x, y):
        return jnp.sum(jm.match_cost(x, y, jnp.asarray(match)) * g)

    ja, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(c))
    g1, g2 = tm.match_cost_grad(t(a), t(c), t(match), t(g))
    for got, want in ((g1, ja), (g2, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SUM_REL, atol=SUM_ABS)
    if "coincident" in case:  # the zero differences gave zero terms
        assert np.isfinite(g1.numpy()).all() and np.isfinite(g2.numpy()).all()
    if "zero" in case:
        assert not g1[-1].any() and not g2[-1].any()


class _Dtypes(TorchFunctionMode):
    """Records the dtype of every floating tensor a torch function returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                self.seen.append((getattr(func, "__name__", str(func)),
                                  x.dtype))
        return out


@pytest.mark.parametrize("b,n,m", [(2, 30, 17), (1, 17, 30)])
def test_grad_referee_is_float64_and_agrees_with_jax(b, n, m):
    a, c, match, g = inputs(b, n, m, "coincident, negative g", seed=3)
    with _Dtypes() as mode:
        ref = referee.grad_referee(t(a), t(c), t(match), t(g))
    assert len(mode.seen) > 10
    assert {dt for _, dt in mode.seen} == {torch.float64}, \
        [s for s in mode.seen if s[1] != torch.float64][:5]
    assert ref["g1"].shape == (b, n, 3) and ref["g2"].shape == (b, m, 3)
    np.testing.assert_allclose(
        ref["scale"].numpy(),
        np.abs(g) * np.maximum(match.astype(np.float64).sum(1).max(-1),
                               match.astype(np.float64).sum(2).max(-1)),
        rtol=1e-12)
    want = jm._mc_bwd((jnp.asarray(a), jnp.asarray(c), jnp.asarray(match)),
                      jnp.asarray(g))
    for k, w in zip(referee.GRAD_KEYS, want):
        np.testing.assert_allclose(ref[k].numpy(), np.asarray(w),
                                   rtol=SUM_REL, atol=SUM_ABS)


def test_grad_distance_and_within():
    """The referee's own gradient is at distance 0; the f32 plain version
    is within its own gate; a gradient moved by 10x the plain version's
    distance (g1 or g2 of every batch entry) is not."""
    x, y = referee.clouds(3, 300, 200, seed=4, device="cpu")
    match = tm.approx_match_plain(x, y)
    g = torch.tensor([0.7, -1.2, 1.4])
    ref = referee.grad_referee(x, y, match, g)
    zero = referee.grad_distance((ref["g1"], ref["g2"]), ref)
    assert all(not bool(zero[k].any()) for k in referee.GRAD_KEYS)
    plain = tm.match_cost_grad_plain(x, y, match, g)
    dp = referee.grad_distance(plain, ref)
    assert all(d.shape == (3,) and bool((d > 0).all()) for d in dp.values())
    assert referee.grad_within(dp, dp, ref)
    for i, k in enumerate(referee.GRAD_KEYS):
        moved = list(plain)
        moved[i] = plain[i] + (10 * dp[k]).float()[:, None, None]
        dm = referee.grad_distance(moved, ref)
        assert not referee.grad_within(dm, dp, ref), k
    # the gate itself: RATIO x the plain distance + GRAD_ULPS ulps of scale
    tol = referee.GRAD_ULPS * 2.0 ** -23 * ref["scale"]
    edge = {k: referee.RATIO * dp[k] + tol for k in referee.GRAD_KEYS}
    assert referee.grad_within(edge, dp, ref)
    over = dict(edge, g2=edge["g2"] * (1 + 1e-9))
    assert not referee.grad_within(over, dp, ref)


def _functions(path: Path) -> dict:
    src = path.read_text()
    return {f.name: ast.get_source_segment(src, f)
            for f in ast.walk(ast.parse(src))
            if isinstance(f, ast.FunctionDef)}


def test_k6d_is_held_to_the_referee_on_the_card():
    """chip_smoke.py's hold_k6d gates K6d on the float64 referee beside the
    GRAD_REL_TOL hold, on every [eval hold] shape and the farm's clouds; the
    GPU tests gate it on SHAPES and on the edge cases."""
    smoke = _functions(ROOT / "chip_smoke.py")
    hold = smoke["hold_k6d"]
    assert "referee.grad_within(dk, dp, ref)" in hold
    assert re.search(r"check\(ok,", hold)
    assert re.search(r"check\(err_d <= GRAD_REL_TOL \* scale_g,", hold)
    assert "hold_k6d(tag, gt, pred, mk, g)" in smoke["hold_k6"]
    assert "hold_k6d(" in smoke["phase_eval_farm"]
    assert 'PARENT_K6["match_cost_grad"]' in hold
    assert '"match_cost_grad"' in smoke["time_k6_turns"]
    assert '"match_cost_grad"' in smoke["k6_runners"]
    cuda = _functions(ROOT / "tests" / "test_torch_eval_cuda.py")
    assert "referee.grad_within(dk, dp, ref)" in cuda["_hold_grad"]
    for name in ("test_match_cost_grad_kernel_against_the_float64_referee",
                 "test_match_cost_grad_kernel_single_points_and_ragged_n",
                 "test_match_cost_grad_kernel_coincident_points",
                 "test_match_cost_grad_kernel_negative_and_zero_g",
                 "test_match_cost_grad_kernel_reads_an_unaligned_match"):
        assert "_hold_grad(" in cuda[name], name


def test_k6d_reads_match_once_without_atomics():
    """csrc/metrics.cu's K6d is one pass over match and one summing kernel,
    launched by match_cost_grad_launch, with no float atomics (two runs give
    the same bits) and no fast-math flag in the build."""
    src = (kernels.CSRC / "metrics.cu").read_text()
    k6d = re.sub(r"//[^\n]*", "", src[src.index(" K6d ----"):])
    assert "mc_grad1" not in src and "mc_grad2" not in src
    launch = k6d[k6d.index("int match_cost_grad_launch"):]
    assert launch.count("<<<") == 3  # the pass (two walks) and the total
    assert launch.count("mc_grad_pass<") == 2
    assert launch.count("mc_grad_total<<<") == 1
    assert "atomic" not in k6d
    assert k6d.count("rsqrtf(") == 1
    assert not any("fast" in f or "ftz" in f for f in kernels.NVCC_FLAGS)
