"""The closed-loop tools of disn_tpu_torch (tools/closed_loop,
tools/train_convergence, tools/eval_rehearsal) and the in-memory synthetic
records against the JAX package's scripts' computations, with
device='cpu', at small sizes: R = 33 for the metric protocol, width 0.125
for training, a 2-object x 2-view tree at sdf_res 16 for the rehearsal."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.core import camera as jcamera
from disn_tpu.eval import metrics as jmetrics
from disn_tpu.eval import runner as jrunner
from disn_tpu.models import posenet as jposenet
from disn_tpu.ops import marching as jmarching
from disn_tpu.ops import voxelize as jvoxelize
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import listing, pipeline, synthetic
from disn_tpu_torch.ops import marching
from disn_tpu_torch.tools import closed_loop, eval_rehearsal, train_convergence

SDFP = closed_loop.SDFP
# f32 on the CPU: the two packages sum in different orders (K6's plain
# versions against XLA's), as tests/test_torch_eval_runner.py holds them
REL = 1e-5
# the camera net in f32: tests/test_torch_posenet.py's bound
CAM_REL = 1e-4
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Torch's intra-op threads at THREADS for this module: beside the
    suite's other workers, 8 threads each oversubscribe the cores, and
    the many small ops of these paths then slow down tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def test_score_vs_analytic_matches_jax():
    """The protocol on one predicted mesh (the owned extractor's at r =
    0.63) at R = 33: the ground-truth mesh is the JAX extractor's, the
    samples are the JAX sampler's bit for bit, CD, EMD, their floor and
    F1 the JAX metrics' on them within REL (F1 within one sample of
    2048), and the IoU the JAX protocol's."""
    R = 33
    pv, pf = marching.extract_mesh_owned(closed_loop.analytic_field(R, 0.63),
                                         SDFP, device="cpu")
    got = closed_loop.score_vs_analytic(pv, pf, R=R, device="cpu")
    gv, gf = closed_loop.gt_mesh(R, device="cpu")
    jv, jf = jmarching.extract_mesh_owned(closed_loop.analytic_field(R), SDFP)
    np.testing.assert_array_equal(gf, jf)
    np.testing.assert_allclose(gv, jv, atol=2 / 65535, rtol=0)
    assert (got["gt_verts"], got["gt_faces"]) == (len(gv), len(gf))

    def sample(v, f, seed):
        return jmetrics.sample_mesh_surface(v, f, closed_loop.N_POINTS,
                                            np.random.RandomState(seed))

    ps, gs, gs0 = sample(pv, pf, 0), sample(gv, gf, 1), sample(gv, gf, 0)
    np.testing.assert_array_equal(
        ps, closed_loop.metrics.sample_mesh_surface(
            pv, pf, closed_loop.N_POINTS, np.random.RandomState(0)))
    ce = jmetrics.chamfer_emd(jnp.asarray(ps[None]), jnp.asarray(gs[None]))
    floor = jmetrics.chamfer_emd(jnp.asarray(gs0[None]),
                                 jnp.asarray(gs[None]))
    ths = np.array([0.5, 1, 2, 5, 10, 20]) * 0.01 * 2.5
    f1 = np.asarray(jmetrics.f_score(jnp.asarray(ps[None]),
                                     jnp.asarray(gs[None]), ths)["f1"])[:, 0]
    iou = jvoxelize.iou_meshes((pv, pf), (gv, gf), dim=110)
    for k, want in (("cd", ce["cd"][0]), ("emd", ce["emd"][0]),
                    ("cd_floor", floor["cd"][0]),
                    ("emd_floor", floor["emd"][0])):
        _close(got[k], float(want), REL, k)
    np.testing.assert_allclose(got["f1"], f1, rtol=0,
                               atol=1 / closed_loop.N_POINTS)
    assert got["iou"] == iou and 0.0 < iou < 1.0
    assert got["cd"] > got["cd_floor"]


def test_cam_est_camera_matches_jax():
    """The cam-est row's camera in f32: pred_trans_mat, rot3d and rot2d
    from the bundled camera net within CAM_REL of the script's JAX
    computation (posenet.apply, camera.project_points) on the same
    render."""
    cfg = Config(compute_dtype="float32", width_mult=0.25, num_classes=128)
    got = closed_loop.cam_est_camera(cfg, device="cpu")
    jcfg = JConfig(compute_dtype="float32", width_mult=0.25,
                   num_classes=128)
    donor = jcheckpoint.restore_params(closed_loop.POSENET)
    jparams = jax.tree_util.tree_map(jnp.asarray, donor.get("params", donor))
    torus = synthetic.SHAPES["torus0"]
    img8, rec = synthetic.render_view(torus, **closed_loop.CAM_VIEW)
    img = img8[..., :3].astype(np.float32) / 255.0
    np.testing.assert_array_equal(got["img"], img)
    out = jposenet.apply(jparams, jnp.asarray(img[None]), jcfg)
    pred_trans = np.asarray(out["pred_trans_mat"])[0].astype(np.float32)
    pred_rt = np.asarray(out["pred_RT"])[0]
    pc = synthetic.surface_points(torus, num=2048,
                                  rng=np.random.RandomState(7))
    homo = np.concatenate([pc, np.ones((len(pc), 1), np.float32)], axis=1)
    rot3d = float(np.mean(np.linalg.norm(
        homo @ pred_rt - homo @ rec.regress_mat, axis=-1)))
    gt_xy, pred_xy = (np.asarray(jcamera.project_points(
        jnp.asarray(pc[None]), jnp.asarray(m[None]), img_w=137, img_h=137))
        for m in (rec.trans_mat, pred_trans))
    rot2d = float(np.mean(np.linalg.norm(pred_xy - gt_xy, axis=-1)))
    _close(got["pred_trans_mat"], pred_trans, CAM_REL, "pred_trans_mat")
    _close(got["rot3d"], rot3d, CAM_REL, "rot3d")
    _close(got["rot2d"], rot2d, CAM_REL, "rot2d")


def test_memory_records_are_what_build_dataset_writes(tmp_path):
    """memory_records equal build_dataset's files read back through the
    port's h5 readers, field by field and dtype by dtype, and
    memory_dataset's batches equal SdfImageDataset's over those files."""
    synthetic.build_dataset(str(tmp_path), views=2, num_samples=1024)
    sdf, views = synthetic.memory_records(views=2, num_samples=1024)
    paths = listing.SplitPaths(str(tmp_path / "sdf"),
                               str(tmp_path / "renders"))
    cat = synthetic.SYNTH_CAT
    assert list(sdf) == list(synthetic.SHAPES)
    assert list(views) == [(o, v) for o in synthetic.SHAPES
                           for v in range(2)]
    for obj, got in sdf.items():
        want = codecs.read_sdf_h5(paths.sdf_path(cat, obj))
        for k in ("ori_pt", "sample_pt", "sample_sdf", "norm_params",
                  "sdf_params"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for (obj, v), got in views.items():
        want = codecs.read_view_h5(paths.img_path(cat, obj, v))
        for k in ("img_arr", "trans_mat", "K", "RT", "obj_rot_mat",
                  "regress_mat"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    cfg = Config(num_sample_points=64, view_num=2)
    mem = synthetic.memory_dataset(cfg, (sdf, views))
    h5 = pipeline.SdfImageDataset(cfg, paths, mem.listinfo)
    idx = np.array([0, 5, 3])
    got, ids = mem.get_batch(idx, np.random.RandomState(1))
    want, want_ids = h5.get_batch(idx, np.random.RandomState(1))
    assert ids == want_ids and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_short_convergence_run_lowers_the_loss():
    """20 steps at width 0.125 (one loader worker, so the batches repeat):
    the median of the last 5 losses is below that of the first 5, and the
    run reports the script's keys (a CD only when the reconstruction has
    a surface: 20 steps at this width need not give it one)."""
    cfg = Config(width_mult=0.125, num_classes=32, batch_size=1,
                 num_sample_points=64, sdf_res=16, view_num=4)
    out = train_convergence.run(steps=20, cfg=cfg, device="cpu",
                                num_samples=1024, n_surface=500, workers=1,
                                log=lambda m: None)
    losses = out["losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.median(losses[-5:]) < np.median(losses[:5])
    assert {"steps", "sign_acc", "cd_x1000", "tris", "steps_per_s",
            "sdf_res"} <= set(out)
    assert np.isfinite(out["cd_x1000"]) == (out["tris"] > 0)


def test_rehearsal_tree_scores_as_in_jax(tmp_path):
    """A 2-object x 2-view rehearsal tree: the port's full protocol gives
    the JAX evaluate_tree's result on the same tree within the eval
    runner test's rtol 1e-5, the JAX side run op by op
    (jax.disable_jit): a view here is a copy of the GT mesh, so most
    sampled points coincide, and on such clouds XLA's fused auction moves
    the EMD by ~2.5e-5 relative from the same computation op by op (the
    port's plain versions agree with the latter to ~4e-7). The cached
    re-run gives the filling run's overall exactly, and the host split
    covers both objects."""
    cfg = Config(sdf_res=16, width_mult=0.125, num_classes=32)
    kw = dict(num_points=256, dim=32)
    root = str(tmp_path / "rehearsal")
    out = eval_rehearsal.run(2, 2, root=root, device="cpu", cfg=cfg,
                             log=lambda m: None, **kw)
    with jax.disable_jit():
        want = jrunner.evaluate_tree(
            os.path.join(root, "pred"), os.path.join(root, "gt"),
            os.path.join(root, "lists"),
            metrics=list(eval_rehearsal.PROTOCOL), view_num=2, **kw)
    assert out["total_objects"] == want["total_objects"] == 2
    assert set(out["overall"]) == set(want["overall"])
    for k, w in want["overall"].items():
        np.testing.assert_allclose(out["overall"][k], w, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert out["cached_overall"] == out["cache_fill_overall"]
    assert out["cached_objects"] == 2 and out["host_split"]["objects"] == 2
    assert set(out["timed"]) == {"cd+emd", "fscore", "iou (host voxel)",
                                 "full protocol"}


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
