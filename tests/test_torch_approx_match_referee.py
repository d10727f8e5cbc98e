"""The float64 referee of K6b (disn_tpu_torch/eval/referee.py) on the CPU:
approx_match_plain run on float64 clouds is float64 in every intermediate,
agrees with the float32 plain version and with disn_tpu's approx_match
within the parity tolerance of tests/test_torch_eval.py, and the distance
helpers measure what they say. Also holds csrc/metrics.cu's K6b to exact
exps (expf alone) by reading its source."""
import re

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from disn_tpu.eval import metrics as jm
from disn_tpu_torch import kernels
from disn_tpu_torch.eval import metrics as tm
from disn_tpu_torch.eval import referee

# tests/test_torch_eval.py's approx_match tolerance: exp(level * d) at level
# -16384 turns a difference delta in d into a relative 16384 * delta in e,
# on top of the f32 sums' order (1e-5 relative)
LEVEL0 = 16384.0
SUM_REL = 1e-5
RAGGED = [(1, 45, 23), (1, 23, 45), (2, 70, 31), (2, 31, 70), (3, 64, 64)]


def clouds(b, n, m, seed):
    return referee.clouds(b, n, m, seed, device="cpu")


class _Dtypes(TorchFunctionMode):
    """Records the dtype of every floating tensor a torch function returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.seen.append((getattr(func, "__name__", str(func)),
                                  t.dtype))
        return out


@pytest.mark.parametrize("b,n,m", [(2, 30, 17), (1, 17, 30)])
def test_float64_plain_is_float64_throughout(b, n, m):
    x, y = clouds(b, n, m, seed=0)
    with _Dtypes() as mode:
        match = tm.approx_match_plain(x.double(), y.double())
    assert match.dtype == torch.float64
    assert len(mode.seen) > 10 * len(tm.LEVELS)
    assert {dt for _, dt in mode.seen} == {torch.float64}, \
        [s for s in mode.seen if s[1] != torch.float64][:5]


@pytest.mark.parametrize("b,n,m", RAGGED)
def test_referee_agrees_with_float32_plain_and_jax(b, n, m):
    """The referee against the f32 plain version and disn_tpu's auction:
    marginals within (SUM_REL + LEVEL0 * delta) x the larger starting mass,
    the cost within that relative, delta the largest difference of the two
    sides' squared distances."""
    x, y = clouds(b, n, m, seed=n + 3 * m)
    ref = tm.approx_match_plain(x.double(), y.double())
    d64 = tm._pairwise_sqdist(x.double(), y.double())
    mass = max(1, m // n, n // m)
    cost64 = tm.match_cost_plain(x.double(), y.double(), ref).numpy()
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    sides = {"f32 plain": (tm.approx_match_plain(x, y).numpy(),
                           tm._pairwise_sqdist(x, y).numpy()),
             "disn_tpu": (np.array(jm.approx_match(jx, jy)),
                          np.array(jm._pairwise_sqdist(jx, jy)))}
    for name, (got, d) in sides.items():
        tol = SUM_REL + LEVEL0 * float(np.abs(d - d64.numpy()).max())
        for ax in (1, 2):
            np.testing.assert_allclose(got.sum(ax), ref.numpy().sum(ax),
                                       rtol=0, atol=tol * mass, err_msg=name)
        cost = tm.match_cost_plain(x.double(), y.double(),
                                   torch.from_numpy(got).double()).numpy()
        np.testing.assert_allclose(cost, cost64, rtol=tol, atol=1e-7,
                                   err_msg=name)


def test_distance_and_within():
    """The referee's own match is at distance 0; a match scaled by 1 + eps
    moves each marginal by eps x its size and the cost by eps relative; the
    gate is RATIO x the plain version's distance + ABS."""
    x, y = clouds(2, 40, 25, seed=7)
    ref = referee.referee(x, y)
    m64 = tm.approx_match_plain(x.double(), y.double())
    assert referee.distance(m64, ref) == {"n": 0.0, "m": 0.0, "emd": 0.0}
    eps = 1e-3
    got = referee.distance(m64 * (1 + eps), ref)
    assert got["n"] == pytest.approx(eps * float(ref["n"].abs().max()),
                                     rel=1e-6)
    assert got["m"] == pytest.approx(eps * float(ref["m"].abs().max()),
                                     rel=1e-6)
    assert got["emd"] == pytest.approx(eps, rel=1e-6)
    plain = {"n": 1e-4, "m": 2e-4, "emd": 0.0}
    assert referee.within({"n": 2e-4, "m": 4e-4, "emd": 1e-7}, plain)
    assert not referee.within({"n": 2.1e-4, "m": 1e-4, "emd": 0.0}, plain)
    assert not referee.within({"n": 0.0, "m": 0.0, "emd": 1.1e-7}, plain)


def test_referee_inputs_cover_the_gpu_tests_shapes():
    ins = referee.referee_inputs(seeds=16)
    assert [(b, n, m) for lab, b, n, m, _ in ins if lab == "shapes"] == \
        list(referee.SHAPES)
    seeded = [(b, n, m) for lab, b, n, m, _ in ins if lab == "seeded"]
    for shape in ((1, 1500, 777), (1, 777, 1500), (3, 2047, 1537)):
        assert seeded.count(shape) == 16
    assert ins[-1][1:4] == referee.PROTOCOL


def test_k6b_takes_its_exps_from_expf_alone():
    """K6b's kernels (the K6b section of csrc/metrics.cu) compute every exp
    with expf: no fast intrinsic, no exp2 or PTX ex2, and the build has no
    fast-math flag."""
    src = (kernels.CSRC / "metrics.cu").read_text()
    k6b = re.sub(r"//[^\n]*", "", src[src.index(" K6b ----"):
                                        src.index(" K6c ----")])
    assert k6b.count("expf(") >= 4
    for bad in ("__expf", "exp2", "ex2", "__powf", "powf", "asm"):
        assert bad not in k6b, bad
    assert not re.search(r"\bexp\(", k6b)
    assert not any("fast" in f for f in kernels.NVCC_FLAGS)
