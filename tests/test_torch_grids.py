"""disn_tpu_torch.core.grids against disn_tpu's: the same numpy inputs
through both, float32 on the CPU, at the reference tests' shapes
(tests/test_codecs_grids.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disn_tpu.core import grids as jgrids
from disn_tpu_torch.core import grids

PARAMS = [np.array([-1, -2, -3, 1, 2, 3], np.float32),
          np.array([-1.2, -1, -0.8, 1.2, 1, 0.8], np.float32),
          np.array([-1, -1, -1, 1, 1, 1], np.float32)]


@pytest.mark.parametrize("res", [5, 9, 33])
@pytest.mark.parametrize("k", range(len(PARAMS)))
def test_dense_grid_np_is_jaxs(res, k):
    """The host grid is numpy in both packages: equal bits."""
    np.testing.assert_array_equal(grids.dense_grid_np(PARAMS[k], res),
                                  jgrids.dense_grid_np(PARAMS[k], res))


@pytest.mark.parametrize("res", [5, 9, 33])
@pytest.mark.parametrize("k", range(len(PARAMS)))
def test_dense_grid_matches_jax(res, k):
    """Device grid, x fastest: within the reference test's tolerance of
    the JAX grid (linspace in f32 may round an ulp apart) and of the
    float64 meshgrid."""
    sp = PARAMS[k]
    want = np.asarray(jgrids.dense_grid(jnp.asarray(sp), res))
    got = grids.dense_grid(torch.from_numpy(sp), res).numpy()
    assert got.shape == (res ** 3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jgrids.dense_grid_np(sp, res),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("res,start,block", [(9, 100, 50), (9, 0, 729),
                                             (257, 16_000_000, 4096),
                                             (65, 274_600, 100)])
def test_grid_block_matches_jax(res, start, block):
    """Flat indices past the grid (the reference's padded last block) map
    on as the JAX version maps them; the IEEE divide by float32(res - 1)
    gives the reference's bits."""
    sp = PARAMS[1]
    want = np.asarray(jgrids.grid_block(jnp.asarray(sp), res,
                                        jnp.int32(start), block))
    got = grids.grid_block(torch.from_numpy(sp), res, start, block).numpy()
    np.testing.assert_array_equal(got, want)
    if start + block <= res ** 3:
        np.testing.assert_allclose(
            got, jgrids.dense_grid_np(sp, res)[start:start + block],
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R", [7, 17])
def test_trilinear_sample_matches_jax_and_scipy(R):
    from scipy.interpolate import RegularGridInterpolator
    rng = np.random.default_rng(3)
    sp = PARAMS[2]
    vol = rng.normal(size=(R, R, R)).astype(np.float32)
    pts = rng.uniform(-0.99, 0.99, size=(40, 3)).astype(np.float32)
    # and points outside the box, clamped to it
    pts = np.concatenate([pts, [[-1.5, 0.2, 0.3], [1.2, 1.7, -3.0]]]
                         ).astype(np.float32)
    want = np.asarray(jgrids.trilinear_sample(
        jnp.asarray(vol), jnp.asarray(sp), jnp.asarray(pts)))
    got = grids.trilinear_sample(torch.from_numpy(vol), torch.from_numpy(sp),
                                 torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = np.linspace(sp[0], sp[3], R)
    interp = RegularGridInterpolator((x, x, x), vol)
    np.testing.assert_allclose(got[:40], interp(pts[:40, ::-1]), rtol=1e-4,
                               atol=1e-5)
