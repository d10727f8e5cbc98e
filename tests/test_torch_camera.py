"""disn_tpu_torch.core.camera's camera-net helpers against disn_tpu's, on
the CPU from the same seeded numpy inputs: K_137, POSENET_T_BIAS,
compose_trans_mat, ortho6d_to_rotation (with near-zero and parallel
columns, where its 1e-8 norm clamp acts), geodesic_distance (with
identical and opposite rotations, where its clip acts) and the projector's
unclamped and shifted forms."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from disn_tpu.core import camera as jcamera
from disn_tpu_torch.core import camera

# float32 on both sides; the cross products and norms round in another
# order (XLA fuses, torch does not): a few ulp of the unit-scale entries
ROT_ATOL = 1e-6


def _poses(seed: int) -> np.ndarray:
    """Random 6D vectors, then the clamp's cases: a zero first column, a
    second column parallel (and anti-parallel) to the first, a tiny first
    column (norm 1e-9, under the clamp) and a huge one."""
    rng = np.random.RandomState(seed)
    p = rng.randn(8, 6).astype(np.float32)
    x = rng.randn(3).astype(np.float32)
    special = np.stack([
        np.r_[np.zeros(3), rng.randn(3)],
        np.r_[x, 2.5 * x],
        np.r_[x, -x],
        np.r_[1e-9 * x / np.linalg.norm(x), rng.randn(3)],
        np.r_[1e6 * x, rng.randn(3)],
        np.zeros(6),
    ]).astype(np.float32)
    return np.concatenate([p, special])


def test_constants_match_jax():
    np.testing.assert_array_equal(camera.K_137, jcamera.K_137)
    np.testing.assert_array_equal(camera.POSENET_T_BIAS,
                                  jcamera.POSENET_T_BIAS)
    assert camera.K_137.dtype == camera.POSENET_T_BIAS.dtype == np.float32


@pytest.mark.parametrize("view", [(45.0, 20.0, 1.1, (0, 0, 0), 1.0),
                                  (130.0, -15.0, 0.8, (0.1, -0.2, 0.05),
                                   0.7)])
def test_compose_trans_mat_matches_jax(view):
    """Host numpy in float64 on both sides: the same bits. The port's
    view_params_to_trans_mat goes through it, with the JAX package's bits."""
    az, el, dist, centroid, m = view
    K, RT = jcamera.blender_proj(az, el, dist)
    rot = jcamera.rotate_matrix(-np.pi / 2)
    nm = jcamera.norm_matrix(np.asarray(centroid), m)
    got = camera.compose_trans_mat(K, RT, rot, nm)
    want = jcamera.compose_trans_mat(K, RT, rot, nm)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    for g, w in zip(camera.view_params_to_trans_mat(az, el, dist,
                                                    np.asarray(centroid), m),
                    jcamera.view_params_to_trans_mat(az, el, dist,
                                                     np.asarray(centroid),
                                                     m)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_ortho6d_to_rotation_matches_jax(seed):
    poses = _poses(seed)
    got = camera.ortho6d_to_rotation(torch.from_numpy(poses)).numpy()
    want = np.asarray(jcamera.ortho6d_to_rotation(jnp.asarray(poses)))
    assert got.shape == (len(poses), 3, 3)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROT_ATOL)
    # the generic ones are rotations with x along the first column
    r = got[:8].astype(np.float64)
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-6)
    x = poses[:8, :3] / np.linalg.norm(poses[:8, :3], axis=1, keepdims=True)
    np.testing.assert_allclose(got[:8, :, 0], x, atol=1e-6)


def test_ortho6d_gradients_match_jax():
    """The clamp's gradient too: d/dposes of a fixed weighting of R, on
    the generic vectors and the tiny-column one (norm under 1e-8). Relative
    to each row's largest entry: the tiny column's gradient is ~1e8."""
    import jax
    poses = _poses(2)[[0, 1, 2, 11, 12]]
    w = np.random.RandomState(3).randn(len(poses), 3, 3).astype(np.float32)
    p = torch.from_numpy(poses).requires_grad_(True)
    (camera.ortho6d_to_rotation(p) * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax.grad(lambda q: jnp.sum(
        jcamera.ortho6d_to_rotation(q) * w))(jnp.asarray(poses)))
    got = p.grad.numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)


def test_geodesic_distance_matches_jax():
    """Random rotation pairs, each against itself (cos rounds to just over
    1 and is clipped: 0, not NaN) and against its turn by pi (cos -1)."""
    rng = np.random.RandomState(4)
    a = np.asarray(jcamera.ortho6d_to_rotation(jnp.asarray(
        rng.randn(6, 6).astype(np.float32))))
    b = np.asarray(jcamera.ortho6d_to_rotation(jnp.asarray(
        rng.randn(6, 6).astype(np.float32))))
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    m1 = np.concatenate([a, a, a])
    m2 = np.concatenate([b, a, a @ flip])
    got = camera.geodesic_distance(torch.from_numpy(m1),
                                   torch.from_numpy(m2)).numpy()
    want = np.asarray(jcamera.geodesic_distance(jnp.asarray(m1),
                                                jnp.asarray(m2)))
    assert np.isfinite(got).all()
    # arccos near +-1 turns an ulp of the cosine into ~5e-4 rad
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:6], want[:6], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[6:12], 0.0, atol=1e-3)
    np.testing.assert_allclose(got[12:], np.pi, atol=1e-3)


@pytest.mark.parametrize("clamp", [True, False])
@pytest.mark.parametrize("shift", [False, True])
def test_project_points_forms_match_jax(clamp, shift):
    """Points inside and outside the image, with and without the camera
    net's shift: f32 with the terms in another order, so within a few ulp
    of the ~100 px coordinates."""
    from disn_tpu_torch.data import synthetic
    rng = np.random.RandomState(5)
    pts = rng.uniform(-2.5, 2.5, (2, 64, 3)).astype(np.float32)
    trans = np.stack([synthetic.demo_trans_mat()] * 2)
    xyshift = (rng.uniform(-0.3, 0.3, (2, 2)).astype(np.float32)
               if shift else None)
    got = camera.project_points(
        torch.from_numpy(pts), torch.from_numpy(trans), clamp=clamp,
        xyshift=None if xyshift is None else torch.from_numpy(xyshift))
    want = np.asarray(jcamera.project_points(
        jnp.asarray(pts), jnp.asarray(trans), clamp=clamp,
        xyshift=None if xyshift is None else jnp.asarray(xyshift)))
    if not clamp:
        assert (np.abs(want) > 137).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-4)


def test_project_points_keeps_float64():
    pts = torch.rand(3, 5, 3, dtype=torch.float64)
    trans = torch.from_numpy(camera.K_137.T.copy()).double()
    trans = torch.cat([trans, torch.tensor([[0.0, 0.0, 2.0]],
                                           dtype=torch.float64)])
    assert camera.project_points(pts, trans).dtype == torch.float64
    assert camera.project_points(pts.float(), trans.float()).dtype == \
        torch.float32
