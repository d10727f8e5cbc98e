"""The port's device weld (ops/marching.weld_device,
extract_mesh_device_sorted) against the JAX package's
extract_mesh_device_sorted and against the port's host weld, on the five
volumes of tests/test_marching.py's owned-vs-sorted hold: a sphere, a
sphere cut by the box, a plane, noise and a sphere at another iso."""
import numpy as np
import pytest
import torch

from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.ops import marching as jmarching
from disn_tpu_torch.ops import marching

PARAMS = np.array([-1, -1, -1, 1, 1, 1], np.float32)
CASES = ["sphere", "boundary", "plane", "random", "iso"]


def _sphere(R, r=0.6):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    return jsynthetic.sdf_sphere(np.stack([xx, yy, zz], -1), r=r).astype(
        np.float32)


def _volume(case):
    if case == "sphere":
        return _sphere(17), 0.0
    if case == "boundary":
        return _sphere(17, r=1.3), 0.0  # larger than the box
    if case == "plane":
        lin = np.linspace(-1, 1, 17, dtype=np.float32)
        zz, _, _ = np.meshgrid(lin, lin, lin, indexing="ij")
        return (zz - 0.1).astype(np.float32), 0.0
    if case == "random":
        return np.random.RandomState(3).randn(9, 9, 9).astype(np.float32), 0.0
    return _sphere(17), 0.07


@pytest.mark.parametrize("case", CASES)
def test_weld_device_equals_host_weld(case):
    """Bit for bit: the same vertices in the same order, the same faces."""
    vol, iso = _volume(case)
    tri_pos, tri_keys, count = marching.marching_tets(
        torch.from_numpy(vol), torch.from_numpy(PARAMS), iso=iso)
    hv, hf = marching.weld(tri_pos.numpy(), tri_keys.numpy(), count)
    dv, df = marching.weld_device(tri_pos, tri_keys, count)
    assert len(hf) > 0
    np.testing.assert_array_equal(dv.numpy(), hv)
    np.testing.assert_array_equal(df.numpy(), hf)


@pytest.mark.parametrize("case", CASES)
def test_device_sorted_matches_jax(case):
    """extract_mesh_device_sorted against the JAX package's: the same
    faces, in order (both name the vertices in edge-key order), and the
    vertices within f32 rounding of an interpolation on a tet edge."""
    vol, iso = _volume(case)
    jv, jf = jmarching.extract_mesh_device_sorted(vol, PARAMS, iso=iso)
    v, f = marching.extract_mesh_device_sorted(vol, PARAMS, iso=iso,
                                               device="cpu")
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-6)


def test_weld_device_empty():
    vol = np.ones((9, 9, 9), np.float32)
    v, f = marching.extract_mesh_device_sorted(vol, PARAMS, device="cpu")
    assert v.shape == (0, 3) and f.shape == (0, 3)
