"""disn_tpu_torch's voxelization for the IoU protocol against disn_tpu's on
the same meshes: the exact surface voxelizer (both packages' bindings of
native/voxelsat.cpp), the sampled one, the solid fill, the mesh IoU, and
the device-sampled occupancy on the CPU."""
import numpy as np
import pytest
import torch

from disn_tpu.ops import voxelize as jv
from disn_tpu_torch import native
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.ops import marching
from disn_tpu_torch.ops import voxelize as tv
from torch_threads import few_threads  # noqa: F401  (autouse)

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


def _mesh(fn, R, **kw):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = fn(np.stack([x, y, z], -1), **kw).astype(np.float32)
    return marching.extract_mesh(torch.from_numpy(vol), BOX)


@pytest.fixture(scope="module")
def meshes():
    return {"sphere": _mesh(synthetic.sdf_sphere, 33),
            "sphere55": _mesh(synthetic.sdf_sphere, 33, r=0.55),
            "torus": _mesh(synthetic.sdf_torus, 65),
            "octa257": _mesh(lambda p: np.abs(p).sum(-1) - 0.6, 257),
            "octa129": _mesh(lambda p: np.abs(p).sum(-1) - 0.6, 129)}


@pytest.mark.parametrize("name", ["sphere", "torus"])
@pytest.mark.parametrize("dim", [32, 110])
def test_voxelize_surface_and_sampled_equal_jax(meshes, name, dim):
    v, f = meshes[name]
    np.testing.assert_array_equal(tv.voxelize_surface(v, f, dim=dim),
                                  jv.voxelize_surface(v, f, dim=dim))
    np.testing.assert_array_equal(tv.voxelize_sampled(v, f, dim=dim),
                                  jv.voxelize_sampled(v, f, dim=dim))


def test_voxelize_surface_random_triangles_and_empty():
    """Slivers and triangles across many cells, an offset grid, no faces."""
    rng = np.random.RandomState(7)
    verts = rng.rand(60, 3).astype(np.float32) * 2.0 - 1.0
    faces = np.arange(60, dtype=np.int32).reshape(-1, 3)
    for dim, offset, span in ((16, 1.1, 2.4), (23, 0.7, 1.9)):
        got = tv.voxelize_surface(verts, faces, dim=dim, offset=offset,
                                  span=span)
        want = jv.voxelize_surface(verts, faces, dim=dim, offset=offset,
                                   span=span)
        assert got.dtype == bool and got.shape == (dim,) * 3
        np.testing.assert_array_equal(got, want)
    empty = np.zeros((0, 3), np.int32)
    assert not tv.voxelize_surface(verts, empty, dim=8).any()
    assert not tv.voxelize_sampled(verts, empty, dim=8).any()


@pytest.mark.parametrize("solid", [False, True])
def test_fill_solid_and_iou_meshes_equal_jax(meshes, solid):
    m1, m2 = meshes["sphere"], meshes["sphere55"]
    occ = tv.voxelize_surface(*m1, dim=64)
    np.testing.assert_array_equal(tv.fill_solid(occ), jv.fill_solid(occ))
    got = tv.iou_meshes(m1, m2, dim=64, solid=solid)
    assert got == jv.iou_meshes(m1, m2, dim=64, solid=solid)
    assert tv.iou_meshes(m1, m1, dim=64, solid=solid) == pytest.approx(1.0)
    if solid:  # nested spheres: the volume ratio (0.55/0.6)^3
        assert got == pytest.approx((0.55 / 0.6) ** 3, abs=0.08)
    else:
        assert 0.0 < got < 0.35


def test_device_occupancy_cpu_within_the_reference_bound(meshes):
    """tests/test_metrics.py's device-voxelization case on the port with
    device='cpu': within 0.05 IoU of the host protocol, self-IoU 1."""
    m1, m2 = meshes["sphere"], meshes["sphere55"]
    host = tv.iou_meshes(m1, m2, dim=48)
    assert tv.iou_meshes_device(m1, m2, dim=48, device="cpu") == \
        pytest.approx(host, abs=0.05)
    assert tv.iou_meshes_device(m1, m1, dim=48, device="cpu") == \
        pytest.approx(1.0, abs=0.02)


@pytest.mark.parametrize("dim", [48, 110])
def test_device_occupancy_samples_like_jax(meshes, dim):
    """The same design as the JAX package's occupancy_device (sample
    count, triangle choice by area, corners): the draws differ
    (torch.Generator against jax.random), so the counts of cells outside
    the exact ones (rounding where the octahedron's corners lie on cell
    faces, as at dim 48) and of exact cells missed agree within 2% of the
    exact count, and so does the sampled IoU of two meshes of one surface
    (at dim 110 well below the host's 1 in both packages). The meshes are
    the evaluation farm's pair: the octahedron at 257^3 and 129^3."""
    a, b = meshes["octa257"], meshes["octa129"]
    exact = tv.voxelize_surface(*a, dim=dim)
    got = tv.occupancy_device(*a, dim=dim, device="cpu")
    want = jv.occupancy_device(*a, dim=dim)
    n = int(exact.sum())
    for part in (lambda o: o & ~exact, lambda o: exact & ~o):
        assert abs(int(part(got).sum()) - int(part(want).sum())) <= 0.02 * n
    host = tv.iou_meshes(a, b, dim=dim)
    assert host == jv.iou_meshes(a, b, dim=dim) and host > 0.99
    dev = tv.iou_meshes_device(a, b, dim=dim, device="cpu")
    assert dev == pytest.approx(jv.iou_meshes_device(a, b, dim=dim), abs=0.02)


def test_device_iou_seeds_follow_jax(meshes):
    """The seed picks the draws (0 by default, as in the JAX package), and
    over 8 seeds the port's sampled IoU of the spheres follows the JAX
    package's: the two means within 4 standard errors of their
    difference (the draws differ, torch.Generator against jax.random)."""
    m1, m2 = meshes["sphere"], meshes["sphere55"]
    occ = [tv.occupancy_device(*m1, dim=48, seed=s, device="cpu")
           for s in (0, 0, 1)]
    np.testing.assert_array_equal(occ[0], occ[1])
    np.testing.assert_array_equal(
        occ[0], tv.occupancy_device(*m1, dim=48, device="cpu"))
    assert (occ[0] != occ[2]).any()
    seeds = range(8)
    got = np.array([tv.iou_meshes_device(m1, m2, dim=48, seed=s,
                                         device="cpu") for s in seeds])
    want = np.array([tv.occupancy_iou(jv.occupancy_device(*m1, dim=48,
                                                          seed=s),
                                      jv.occupancy_device(*m2, dim=48,
                                                          seed=s))
                     for s in seeds])
    se = np.sqrt((got.var(ddof=1) + want.var(ddof=1)) / len(seeds))
    assert abs(got.mean() - want.mean()) <= 4 * se


def test_occupancy_device_needs_a_device_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    v = np.zeros((3, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.occupancy_device(v, np.array([[0, 1, 2]], np.int32), dim=8)


def test_voxelize_surface_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No quiet switch to sampling: a failed build of the native library
    reaches the caller."""
    native._eval_lib.cache_clear()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "nowhere")
    monkeypatch.setenv("CXX", "false")
    try:
        with pytest.raises(RuntimeError, match="voxelsat.cpp"):
            tv.voxelize_surface(np.zeros((3, 3), np.float32),
                                np.array([[0, 1, 2]], np.int32), dim=8)
    finally:
        native._eval_lib.cache_clear()
