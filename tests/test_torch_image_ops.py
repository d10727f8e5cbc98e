"""disn_tpu_torch.ops.image and core.camera against disn_tpu's: the same
numpy inputs through both, float32 on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disn_tpu.core import camera as jcamera
from disn_tpu.ops import image as jimage
from disn_tpu_torch.core import camera
from disn_tpu_torch.ops import image


@pytest.mark.parametrize("shape,out", [((1, 137, 137, 3), (224, 224)),
                                       ((1, 7, 7, 16), (137, 137)),
                                       ((2, 28, 28, 8), (137, 137))])
def test_resize_bilinear_matches_jax(shape, out):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), *out))
    got = image.resize_bilinear(torch.from_numpy(x), *out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_interp_matrix_is_tf1_legacy():
    np.testing.assert_array_equal(image._interp_matrix(137, 7),
                                  jimage._interp_matrix(137, 7))


def test_resampler_matches_jax_including_outside():
    """Coords reach past the image on every side: taps outside get zero."""
    rng = np.random.RandomState(1)
    data = rng.randn(2, 17, 23, 5).astype(np.float32)
    coords = np.stack([rng.uniform(-2, 25, (2, 300)),
                       rng.uniform(-2, 19, (2, 300))], -1).astype(np.float32)
    coords[0, :4] = [[0, 0], [22, 16], [22.5, 3], [-0.5, 16.25]]
    want = np.asarray(jimage.resampler(jnp.asarray(data),
                                       jnp.asarray(coords)))
    got = image.resampler(torch.from_numpy(data),
                          torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_project_points_matches_jax_behind_camera():
    """The test_fused camera puts its w=0 plane through the box: points
    behind it divide by a negative w and clamp, as in the JAX projector."""
    trans = np.vstack([np.eye(3) * 60, [68.0, 68.0, 2.0]]).astype(np.float32)
    pts = np.random.RandomState(2).uniform(-1, 1, (2, 500, 3)
                                           ).astype(np.float32)
    want = np.asarray(jcamera.project_points(
        jnp.asarray(pts), jnp.asarray(np.stack([trans, trans]))))
    got = camera.project_points(torch.from_numpy(pts),
                                torch.from_numpy(np.stack([trans, trans])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_view_params_to_trans_mat_matches_jax():
    for az, el, d in ((45.0, 20.0, 1.1), (200.0, -10.0, 0.8)):
        want = jcamera.view_params_to_trans_mat(az, el, d, np.zeros(3), 1.0)
        got = camera.view_params_to_trans_mat(az, el, d, np.zeros(3), 1.0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,out", [((1, 137, 137, 1), (224, 224)),
                                       ((2, 7, 9, 3), (20, 13)),
                                       ((1, 224, 224, 2), (137, 137))])
def test_resize_nearest_matches_jax(shape, out):
    """Legacy TF1 nearest: a copy of source pixels, so equal bits."""
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = np.asarray(jimage.resize_nearest(jnp.asarray(x), *out))
    got = image.resize_nearest(torch.from_numpy(x), *out).numpy()
    np.testing.assert_array_equal(got, want)


def _coords(rng, b, n, hi_x, hi_y, lo=0.0):
    return np.stack([rng.uniform(lo, hi_x, (b, n)),
                     rng.uniform(lo, hi_y, (b, n))], -1).astype(np.float32)


def test_resampler_clamped_matches_jax():
    """Edge-clamped taps, coords past every edge included (the reference
    test's edge cases first)."""
    rng = np.random.RandomState(5)
    data = rng.randn(2, 11, 13, 4).astype(np.float32)
    coords = _coords(rng, 2, 200, 14.0, 12.0, lo=-2.0)
    coords[0, :3] = [[-1.0, 0.0], [5.0, 3.0], [1.5, 1.5]]
    want = np.asarray(jimage.resampler_clamped(jnp.asarray(data),
                                               jnp.asarray(coords)))
    got = image.resampler_clamped(torch.from_numpy(data),
                                  torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resampler_clamped_lerps_a_bf16_map_in_bf16():
    """The tap weights take the map's type: a bf16 map gives a bf16 result
    (the resampler promotes to f32 instead). bf16 lerps round at each op
    in both packages, XLA's fusions may keep some in f32: within 2 bf16
    ulps of the result's scale."""
    rng = np.random.RandomState(6)
    data = rng.randn(1, 28, 28, 8).astype(np.float32)
    coords = _coords(rng, 1, 300, 27.0, 27.0)
    jd = jnp.asarray(data, jnp.bfloat16)
    want = np.asarray(jimage.resampler_clamped(jd, jnp.asarray(coords)),
                      np.float32)
    got = image.resampler_clamped(torch.from_numpy(data).bfloat16(),
                                  torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2 ** -8 * scale)


@pytest.mark.parametrize("hw", [(7, 7), (28, 28), (56, 56), (137, 137)])
def test_sample_native_matches_jax(hw):
    """Each VGG endpoint scale (and 137 itself): 4 taps at the TF1-scaled
    coordinates, 0..136 and the corners."""
    rng = np.random.RandomState(7)
    feat = rng.randn(2, *hw, 5).astype(np.float32)
    coords = _coords(rng, 2, 256, 136.0, 136.0)
    coords[1, :4] = [[0, 0], [136, 136], [0, 136], [135.999, 0.5]]
    want = np.asarray(jimage.sample_native(jnp.asarray(feat),
                                           jnp.asarray(coords), 137, 137))
    got = image.sample_native(torch.from_numpy(feat),
                              torch.from_numpy(coords), 137, 137).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 56, 56, 8), (1, 14, 14, 3),
                                   (1, 7, 7, 16), (2, 112, 112, 4)])
def test_resize_then_sample_matches_jax(shape):
    """The 16-tap composition (reference shapes of tests/test_image_ops.py
    and the VGG scales), with the boundary coords: within f32 rounding of
    the JAX version, and of the materialising resize + resampler."""
    rng = np.random.RandomState(8)
    feat = rng.randn(*shape).astype(np.float32)
    coords = _coords(rng, shape[0], 64, 136.0, 136.0)
    coords[0, :5] = [[136.0, 136.0], [0.0, 136.0], [136.0, 0.0], [0.0, 0.0],
                     [135.999, 135.999]]
    fj, cj = jnp.asarray(feat), jnp.asarray(coords)
    want = np.asarray(jimage.resize_then_sample(fj, cj, 137, 137))
    ft, ct = torch.from_numpy(feat), torch.from_numpy(coords)
    got = image.resize_then_sample(ft, ct, 137, 137).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    materialised = image.resampler(image.resize_bilinear(ft, 137, 137), ct)
    np.testing.assert_allclose(got, materialised.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_resize_then_sample_keeps_a_bf16_maps_type():
    """Gathers in f32, casts back: the bf16 result rounds the f32 one."""
    rng = np.random.RandomState(9)
    feat = rng.randn(1, 28, 28, 6).astype(np.float32)
    coords = _coords(rng, 1, 128, 136.0, 136.0)
    fb = torch.from_numpy(feat).bfloat16()
    got = image.resize_then_sample(fb, torch.from_numpy(coords), 137, 137)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jimage.resize_then_sample(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(coords), 137, 137),
        np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_native_and_tf1_sampling_agree_on_linear_maps():
    """Both schemes reproduce a globally linear map exactly (the reference
    test's property), so the port's two samplers agree there."""
    h = w = 28
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    lin = torch.from_numpy((0.3 + 0.05 * xx - 0.02 * yy).astype(
        np.float32)[None, :, :, None])
    coords = np.random.RandomState(0).uniform(2.0, 128.0, (1, 256, 2)
                                              ).astype(np.float32)
    a = image.resize_then_sample(lin, torch.from_numpy(coords), 137, 137)
    b = image.sample_native(lin, torch.from_numpy(coords), 137, 137)
    want = 0.3 + 0.05 * coords[0, :, 0] * (w / 137) \
        - 0.02 * coords[0, :, 1] * (h / 137)
    np.testing.assert_allclose(a[0, :, 0].numpy(), want, atol=1e-5)
    np.testing.assert_allclose(b[0, :, 0].numpy(), want, atol=1e-5)
