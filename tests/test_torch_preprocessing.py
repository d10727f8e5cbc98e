"""disn_tpu_torch's offline tools (preprocessing.sdf_gen and img_gen, the
distance-field binding, postprocessing.clean_mesh_file, codecs.read_dist)
against disn_tpu's, on the CPU from the same meshes and seeds.

Tolerances: the host numpy steps (normalisation, band sampling, camera
composition) and the distance field are the same code and compare
exactly; the ground-truth mesh's faces exactly and its vertices within
1e-5 (the JAX extraction is jitted XLA, the port's is PyTorch ops)."""
import numpy as np
import pytest
import torch

from disn_tpu import native as jnative
from disn_tpu import postprocessing as jpost
from disn_tpu.core import codecs as jcodecs
from disn_tpu.preprocessing import img_gen as jimg_gen
from disn_tpu.preprocessing import sdf_gen as jsdf_gen
from disn_tpu_torch import native, postprocessing
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.ops import marching
from disn_tpu_torch.preprocessing import img_gen, sdf_gen

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


def sphere_mesh(R=33, r=0.6, twin=False):
    """A sphere's mesh; with twin, two spheres of radius r at x = +-0.5,
    whose centroid (the grid's centre after normalisation) is outside."""
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    p = np.stack([xx, yy, zz], -1)
    if twin:
        vol = np.minimum(
            synthetic.sdf_sphere(p - np.float32([0.5, 0, 0]), r=r),
            synthetic.sdf_sphere(p + np.float32([0.5, 0, 0]), r=r))
    else:
        vol = synthetic.sdf_sphere(p, r=r)
    return marching.extract_mesh(torch.from_numpy(vol.astype(np.float32)),
                                 BOX)


def _grid(res1=65):
    lin = np.linspace(-1, 1, res1, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    return synthetic.sdf_sphere(np.stack([xx, yy, zz], -1)).astype(
        np.float32)


def test_normalize_mesh_matches_jax():
    verts, faces = sphere_mesh()
    shifted = verts * 3.0 + np.array([1.0, -2.0, 0.5], np.float32)
    want = jsdf_gen.normalize_mesh(shifted, faces, seed=3)
    got = sdf_gen.normalize_mesh(shifted, faces, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("num_sample,bandwidth", [(4096, 0.1), (1000, 0.02),
                                                  (512, 0.5)])
def test_stratified_sample_grid_matches_jax(num_sample, bandwidth):
    """The same draws from the same RandomState; a narrow band (0.02 on a
    65^3 grid) leaves a band short of its quota, which spills over."""
    vol = _grid()
    want = jsdf_gen.stratified_sample_grid(
        vol, BOX, num_sample, bandwidth, 0.003, np.random.RandomState(0))
    got = sdf_gen.stratified_sample_grid(
        vol, BOX, num_sample, bandwidth, 0.003, np.random.RandomState(0))
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[:, 3] - 0.003) <= bandwidth + 1e-6).all()


@pytest.mark.parametrize("cat,sign", [("03001627", 1.0), ("02958343", 1.0),
                                      ("02958343", -1.0), ("", 1.0)])
def test_check_insideout_matches_jax(cat, sign):
    vol = sign * np.ones((5, 5, 5), np.float32)
    assert sdf_gen.check_insideout(cat, vol) == \
        jsdf_gen.check_insideout(cat, vol)


@pytest.mark.parametrize("band,votes", [(0.0, 3), (0.2, 3), (0.0, 1)])
def test_compute_distance_field_matches_jax_bit_for_bit(band, votes):
    """The port builds native/distfield.cpp alone with -pthread into
    build/native/, the JAX package builds it with four other sources by
    native/Makefile (-Wall -pthread, the same -O3 -march=native): the same
    code, so the same bits, at any thread count."""
    verts, faces = sphere_mesh(R=17)
    bbox = np.array([-0.8] * 3 + [0.8] * 3, np.float64)
    want = jnative.compute_distance_field(verts, faces, 32, bbox,
                                          sign_votes=votes, band=band)
    got = native.compute_distance_field(verts, faces, 32, bbox,
                                        sign_votes=votes, band=band)
    assert got.shape == (33, 33, 33) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.compute_distance_field(verts, faces, 32, bbox,
                                      sign_votes=votes, threads=1,
                                      band=band), want)


def test_compute_distance_field_raises_without_triangles():
    with pytest.raises(RuntimeError, match="rc=1"):
        native.compute_distance_field(np.zeros((3, 3), np.float32),
                                      np.zeros((0, 3), np.int32), 8, BOX)


def _h5_arrays(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


@pytest.mark.parametrize("cat,reduce", [("03001627", 4), ("02958343", 0)])
def test_generate_object_matches_jax(tmp_path, cat, reduce):
    """generate_object at res 32 on the CPU: every h5 array equal, the
    isosurf.obj faces equal and its vertices within 1e-5. A car whose
    centre voxel lies outside (two spheres apart) reads as inside out, and
    is flipped and flagged in both packages."""
    twin = cat == "02958343"
    verts, faces = sphere_mesh(r=0.3 if twin else 0.6, twin=twin)
    verts = verts * 2.0
    kw = dict(cat_id=cat, sdf_res=32, num_sample=2048,
              full_grid_reduce=reduce, seed=1)
    want = jsdf_gen.generate_object(verts, faces, str(tmp_path / "j"), **kw)
    stats: dict = {}
    got = sdf_gen.generate_object(verts, faces, str(tmp_path / "t"),
                                  device="cpu", stats=stats, **kw)
    assert {k: v for k, v in got.items() if k != "h5"} == \
        {k: v for k, v in want.items() if k != "h5"}
    assert set(stats) == {"distfield_s", "marching_tets_ms", "weld_ms"}
    names = ["ori_sample.h5"] + (["ori_sample_grid.h5"] if reduce else [])
    for name in names:
        a = _h5_arrays(tmp_path / "t" / name)
        b = _h5_arrays(tmp_path / "j" / name)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tv, tf_ = codecs.read_obj(str(tmp_path / "t" / "isosurf.obj"))
    jv, jf = jcodecs.read_obj(str(tmp_path / "j" / "isosurf.obj"))
    assert len(jf) > 100
    np.testing.assert_array_equal(tf_, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    flag = [(tmp_path / d / "isinsideout.txt").exists() for d in "tj"]
    assert flag == [cat == "02958343"] * 2
    again = sdf_gen.generate_object(verts, faces, str(tmp_path / "t"),
                                    device="cpu")
    assert again["skipped"]


def test_img_gen_matches_jax(tmp_path):
    """generate_object_views: every view h5 array equal to disn_tpu's."""
    metas = [(30.0, 20.0, 0.0, 0.85), (200.0, 10.0, 5.0, 0.9)]
    images = [synthetic.render_view(synthetic.sdf_sphere, az, el, d)[0]
              for az, el, _, d in metas]
    norm = np.array([0.1, -0.2, 0.05, 1.3], np.float32)
    want = jimg_gen.generate_object_views(images, metas, norm,
                                          str(tmp_path / "j"))
    got = img_gen.generate_object_views(images, metas, norm,
                                        str(tmp_path / "t"))
    assert [p.split("/")[-1] for p in got] == \
        [p.split("/")[-1] for p in want] == ["00.h5", "01.h5"]
    for g, w in zip(got, want):
        a, b = _h5_arrays(g), _h5_arrays(w)
        assert set(a) == set(b) and a["img_arr"].shape == (137, 137, 4)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    meta = tmp_path / "rendering_metadata.txt"
    meta.write_text("30.0 20.0 0.0 0.85 35\n200 10 5 0.9 35 1\nbad\n")
    assert img_gen.parse_render_metadata(str(meta)) == \
        jimg_gen.parse_render_metadata(str(meta)) == metas


def _two_parts():
    v1, f1 = sphere_mesh(R=25, r=0.6)
    v2, f2 = sphere_mesh(R=9, r=0.3)
    v2 = v2 * 0.5 + np.array([2.0, 0, 0], np.float32)
    return (np.concatenate([v1, v2]),
            np.concatenate([f1, f2 + len(v1)]).astype(np.int32), len(v1))


def test_clean_mesh_file_matches_jax(tmp_path):
    """A mesh with a small part far off the centre: the same file as
    disn_tpu's writes, the stray part gone."""
    verts, faces, n_big = _two_parts()
    src = str(tmp_path / "m.obj")
    codecs.write_obj(src, verts, faces)
    postprocessing.clean_mesh_file(src, str(tmp_path / "t.obj"))
    jpost.clean_mesh_file(src, str(tmp_path / "j.obj"))
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    v, _ = codecs.read_obj(str(tmp_path / "t.obj"))
    assert len(v) == n_big and np.abs(v).max() < 1.0


def test_read_dist_matches_jax(tmp_path):
    """read_dist of a .dist that the port's write_dist wrote, against
    disn_tpu's read_dist; a wrong resolution and a bad header raise."""
    vals = np.random.RandomState(0).randn(9, 9, 9).astype(np.float32)
    path = str(tmp_path / "g.dist")
    codecs.write_dist(path, 8, BOX, vals)
    got = codecs.read_dist(path, expect_res=8)
    want = jcodecs.read_dist(path)
    assert got.res == want.res == 8
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.values, vals)
    np.testing.assert_array_equal(got.params, want.params)
    with pytest.raises(ValueError, match="expected 16"):
        codecs.read_dist(path, expect_res=16)
    raw = bytearray(open(path, "rb").read())
    raw[0:4] = np.int32(8).tobytes()
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="inconsistent header"):
        codecs.read_dist(path)
