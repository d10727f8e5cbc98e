"""disn_tpu_torch.parallel against disn_tpu.parallel on the CPU: the mesh
layout, the host stripes of the loader, and, over one 2-rank gloo process
group spawned once for the module (tests/torch_parallel_ranks.py), the
data-parallel and points-split train steps, the sharded dense and sparse
passes, the striped record pass and image_to_mesh_sharded; then `train`
under torchrun on 2 ranks.

The JAX package's own tests show its sharded functions equal to its
single-device ones (tests/test_train.py:68, tests/test_infer.py:56, :65,
:240, :261, tests/test_marching.py:558), so the port's multi-rank results
are held against the port's single-process ones and against the cheaper
JAX single-device function; a JAX sharded function runs only at the
smallest grids (dense at sdf_res 8, block 128; sparse at 16), on 2 of the
8 virtual devices of tests/conftest.py."""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import torch_parallel_ranks
from disn_tpu.config import Config as JConfig
from disn_tpu.data import pipeline as jpipeline
from disn_tpu.data import synthetic as jsynthetic
from disn_tpu.infer import dense as jdense
from disn_tpu.infer import pipeline as jinfer
from disn_tpu.infer import sparse as jsparse
from disn_tpu.models import disn as jdisn
from disn_tpu.ops import marching as jmarching
from disn_tpu.parallel import mesh as jmesh
from disn_tpu.train import checkpoint as jcheckpoint
from disn_tpu.train import trainer as jtrainer
from disn_tpu_torch import convert, native, parallel
from disn_tpu_torch.config import Config
from disn_tpu_torch.data import listing, pipeline, synthetic
from disn_tpu_torch.infer import dense, sparse
from disn_tpu_torch.infer import pipeline as ipipeline
from disn_tpu_torch.ops import marching
from disn_tpu_torch.train import checkpoint, trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TRAIN = dict(num_classes=32, width_mult=0.125, sdf_res=8, batch_size=8,
             num_sample_points=64, regularization=True,
             compute_dtype="float32")
OCTA = dict(num_classes=32, width_mult=0.125, sdf_res=32,
            compute_dtype="float32", cell_cap_frac=0.9)
TRANS = np.vstack([np.eye(3) * 60, [68.0, 68.0, 2.0]]).astype(np.float32)
BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
# a train step's loss and updated parameters: the JAX package's bounds for
# its sharded step against its single one (tests/test_train.py:68)
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
# volumes: the bounds of the JAX package's sharded-vs-single inference tests
VOL_RTOL, VOL_ATOL = 1e-4, 1e-5
# vertices of the record route against the owned route's at sdf_res 32:
# the u16 edge parameter's step (tests/test_infer.py:261)
VERT_ATOL = 2e-5
SPAWN_LIMIT_S = 600


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _leaves(tree):
    return {p: np.asarray(v.detach() if torch.is_tensor(v) else v)
            for p, v in checkpoint.leaves(tree)}


@pytest.fixture(scope="module")
def setup():
    """Seeded inputs: a JAX param tree and the port's copy of it, an 8-row
    batch, an image, the sphere volume of tests/test_marching.py."""
    jcfg = JConfig(**TRAIN)
    jparams = jdisn.init(jcfg, jax.random.PRNGKey(0))
    params = _numpy(convert.params_from_jax(jax.device_get(jparams)))
    rng = np.random.RandomState(0)
    b, n = TRAIN["batch_size"], TRAIN["num_sample_points"]
    pts = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    batch = {
        "img": rng.rand(b, 137, 137, 3).astype(np.float32),
        "sdf_pt": pts,
        "sdf_pt_rot": pts[..., ::-1].copy(),
        "sdf_val": (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.5
                    + 0.05 * rng.randn(b, n, 1)).astype(np.float32),
        "trans_mat": np.stack([synthetic.demo_trans_mat()] * b),
    }
    lin = np.linspace(-1, 1, 33, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = synthetic.sdf_sphere(np.stack([xx, yy, zz], -1)).astype(
        np.float32)
    return dict(
        cfg=TRAIN, params=params, batch=batch, jparams=jparams,
        img=np.random.RandomState(1).rand(1, 137, 137, 3).astype(np.float32),
        trans=TRANS, box=BOX, sphere=sphere, octa_cfg=OCTA,
        octa_img=np.random.RandomState(0).rand(1, 137, 137, 3).astype(
            np.float32),
        octa_trans=synthetic.demo_trans_mat())


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every multi-rank check, run once in one 2-rank gloo group (spawned
    processes, one thread each, a file:// rendezvous under tmp_path) ->
    (rank 0's results, rank 1's)."""
    d = tmp_path_factory.mktemp("ranks")
    inputs = {k: v for k, v in setup.items() if k != "jparams"}
    ctx = mp.start_processes(
        torch_parallel_ranks.run,
        args=(WORLD, str(d / "rendezvous"), inputs, str(d)), nprocs=WORLD,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {SPAWN_LIMIT_S} s")
    out = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _port_step(setup, rows: int):
    """The port's single-process step on the first `rows` rows."""
    cfg = Config(**TRAIN).replace(batch_size=rows)
    state = trainer.create_state(cfg, params=_tensors(setup["params"]),
                                 device="cpu")
    state, losses = trainer.make_train_step(cfg, device="cpu")(
        state, {k: v[:rows] for k, v in setup["batch"].items()})
    return {k: float(v) for k, v in losses.items()}, _leaves(state.params)


@pytest.fixture(scope="module")
def single_step(setup):
    return _port_step(setup, TRAIN["batch_size"])


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX package's single-device step on the 8 rows."""
    jcfg = JConfig(**TRAIN)
    state = jtrainer.create_state(jcfg, None, params=setup["jparams"])
    state, losses = jtrainer.make_train_step(jcfg, donate=False)(
        state, {k: jnp.asarray(v) for k, v in setup["batch"].items()})
    return ({k: float(v) for k, v in losses.items()},
            _leaves(convert.params_from_jax(jax.device_get(state.params))))


def _hold_step(got, want, what):
    (gl, gp), (wl, wp) = got, want
    for k in ("sdf_loss", "overall_loss", "sdf_loss_realvalue",
              "regularization"):
        np.testing.assert_allclose(gl[k], wl[k], rtol=LOSS_RTOL,
                                   err_msg=f"{what}: {k}")
    assert abs(gl["accuracy"] - wl["accuracy"]) <= 1.0 / 512, what
    assert np.float32(gl["lr"]) == np.float32(wl["lr"])
    assert set(gp) == set(wp)
    for p in wp:
        np.testing.assert_allclose(gp[p], wp[p], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what}: {p}")


# ---------------------------------------------------------------------------
# The mesh and the host stripes (no process group needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_layout_matches_jax(n):
    """parallel.layout / fitting_layout lay out ranks as JAX's make_mesh /
    fitting_mesh lay out devices, and refuse the same shapes."""
    devices = jax.devices()[:n]

    def ids(m):
        return np.vectorize(lambda d: d.id)(m.devices)

    for points in [p for p in (1, 2, 4, 8) if n % p == 0]:
        for data in (None, n // points):
            got = parallel.layout(range(n), data, points)
            want = ids(jmesh.make_mesh(data, points, devices=devices))
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=f"mesh {n + 1}x1 != {n} ranks"):
        parallel.layout(range(n), n + 1, 1)
    with pytest.raises(ValueError, match=f"mesh {n + 1}x1 != {n} devices"):
        jmesh.make_mesh(n + 1, 1, devices=devices)
    for b in (1, 2, 3, 4, 6, 8, 20):
        np.testing.assert_array_equal(
            parallel.fitting_layout(b, range(n)),
            ids(jmesh.fitting_mesh(b, devices=devices)))


def test_one_process_mesh():
    """Without a process group the mesh is 1x1, its collectives do nothing
    and its shares are everything."""
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1, "points": 1} and mesh.group is None
    assert mesh.lead and mesh.index == 0
    t = torch.arange(6.0)
    assert parallel.gather(t, mesh) is t and parallel.broadcast(t, mesh) is t
    assert parallel.point_slice(6, mesh) == slice(0, 6)
    assert parallel.fitting_mesh(3).grid.tolist() == [[0]]
    assert [parallel.share(7, 3, k) for k in range(3)] == [(0, 3), (3, 5),
                                                         (5, 7)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return synthetic.build_dataset(str(tmp_path_factory.mktemp("synth")),
                                   views=2, num_samples=1024, grid_res=8)


def test_epoch_sampler_stripes_match_jax(tree):
    """EpochSampler(host_id, host_count) keeps the JAX package's stripe of
    each epoch for the same seed (tests/test_data.py:55): disjoint halves."""
    listinfo, cats_limit = listing.load_split(
        tree["lst_dir"], tree["cats"], "train", view_num=tree["views"])
    orders = []
    for hid in range(2):
        got = pipeline.EpochSampler(listinfo, cats_limit, cat_limit=64,
                                    seed=7, host_id=hid, host_count=2)
        want = jpipeline.EpochSampler(listinfo, cats_limit, cat_limit=64,
                                      seed=7, host_id=hid, host_count=2)
        for _ in range(2):
            o = got.epoch_order()
            np.testing.assert_array_equal(o, want.epoch_order())
        orders.append(o)
    assert len(orders[0]) == len(orders[1]) == 3
    assert set(orders[0].tolist()).isdisjoint(orders[1].tolist())


def test_two_host_loader_harness(tree):
    """One loader a host (tests/test_data.py:68): disjoint example sets
    that cover the epoch truncated to whole batches of each host, and the
    JAX loader's batches per epoch."""
    cfg = synthetic.tiny_config()
    listinfo, cats_limit = listing.load_split(
        tree["lst_dir"], tree["cats"], "train", view_num=tree["views"])
    paths = listing.SplitPaths(tree["sdf_dir"], tree["rendered_dir"])
    seen = []
    for hid in range(2):
        loader = pipeline.make_loader(cfg, paths, listinfo, cats_limit,
                                      epochs=1, workers=2, seed=11,
                                      device="cpu", host_id=hid,
                                      host_count=2)
        jloader = jpipeline.make_loader(
            JConfig(**{f: getattr(cfg, f) for f in ("batch_size",
                                                    "cat_limit")}),
            paths, listinfo, cats_limit, epochs=1, seed=11, host_id=hid,
            host_count=2)
        assert loader.batches_per_epoch == jloader.batches_per_epoch
        loader.drop_ids = False
        loader.start()
        try:
            seen.append({tuple(i) for _, ids in loader for i in ids})
        finally:
            loader.shutdown()
    assert seen[0] and seen[0].isdisjoint(seen[1])
    per_host = (len(listinfo) // 2 // cfg.batch_size) * cfg.batch_size
    assert len(seen[0] | seen[1]) == 2 * per_host


def test_nccl_rank_without_its_card_raises(monkeypatch, tmp_path):
    """Under torchrun a CUDA rank whose LOCAL_RANK has no card raises (no
    two NCCL ranks share a card, none moves to the CPU), in
    init_from_env and through the CLI, before any process group exists."""
    import torch.distributed as dist

    from disn_tpu_torch import cli

    cards = torch.cuda.device_count()
    monkeypatch.setenv("WORLD_SIZE", str(cards + 2))
    monkeypatch.setenv("RANK", str(cards + 1))
    monkeypatch.setenv("LOCAL_RANK", str(cards + 1))
    with pytest.raises(RuntimeError, match="one NCCL rank a card"):
        parallel.init_from_env("cuda")
    with pytest.raises(RuntimeError, match="one NCCL rank a card"):
        cli.main(["train", "--device", "cuda", "--data-root", "unused",
                  "--log-dir", str(tmp_path)])
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Training over 2 ranks
# ---------------------------------------------------------------------------

def test_train_step_sharded_matches_single(ranks, single_step, jax_step):
    """2 ranks x 4 rows: the port's single step on the 8 rows and the JAX
    package's (whose sharded step equals it, tests/test_train.py:68)."""
    _hold_step(ranks[0]["train"], single_step, "2 ranks vs the port")
    _hold_step(ranks[0]["train"], jax_step, "2 ranks vs JAX")
    _hold_step(ranks[1]["train"], ranks[0]["train"], "rank 1 vs rank 0")


def test_points_split_step_matches_single(ranks, single_step, jax_step):
    """The (data=1, points=2) step of the JAX package's 2D dry run
    (__graft_entry__.dryrun_multichip): sdf_pt, sdf_pt_rot and sdf_val
    split over the points axis."""
    _hold_step(ranks[0]["train points"], single_step, "points vs the port")
    _hold_step(ranks[0]["train points"], jax_step, "points vs JAX")


def test_fitting_mesh_of_three(ranks, setup):
    """batch_size 3 on 2 ranks: the fitting mesh is the first rank; the
    second takes no step; the step equals the single one."""
    assert ranks[0]["fitting"] == [[0]] and ranks[1]["fitting"] is None
    assert "train 3" not in ranks[1]
    _hold_step(ranks[0]["train 3"], _port_step(setup, 3), "fitting mesh")


# ---------------------------------------------------------------------------
# Inference over 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_dense(setup):
    cfg = Config(**TRAIN)
    params = _tensors(setup["params"])
    return {key: dense.dense_sdf(params, setup["img"], TRANS, BOX, c,
                                 device="cpu").numpy()
            for key, c in (("kernel", cfg),
                           ("plain", cfg.replace(fused_kernel="off")))}


@pytest.mark.parametrize("shape", [(1, WORLD), (WORLD, 1)])
def test_dense_sharded_matches_single(ranks, setup, single_dense, shape):
    """dense_sdf(mesh=) on (1,2) and (2,1) (K1's plain version over each
    rank's cells and planes) against the port's single pass and the JAX
    package's sharded pass on the same mesh shape (tests/test_infer.py:56,
    :65)."""
    got = ranks[0][f"dense {shape}"]
    np.testing.assert_allclose(got, single_dense["kernel"], rtol=VOL_RTOL,
                               atol=VOL_ATOL)
    jm = jmesh.make_mesh(*shape, devices=jax.devices()[:WORLD])
    want = jdense.dense_sdf(setup["jparams"], setup["img"], TRANS, BOX,
                            JConfig(**TRAIN), block=128, mesh=jm)
    np.testing.assert_allclose(got, want, rtol=VOL_RTOL, atol=VOL_ATOL)
    np.testing.assert_array_equal(ranks[1][f"dense {shape}"], got)


def test_dense_sharded_plain_slabs(ranks, single_dense):
    """fused_kernel='off': each rank streams its slab of the flat grid, as
    the JAX package's workers do."""
    np.testing.assert_allclose(ranks[0]["dense plain"], single_dense["plain"],
                               rtol=VOL_RTOL, atol=VOL_ATOL)


def test_sparse_sharded_matches_single(ranks, setup):
    """sparse_volume_sharded at sdf_res 16 against the port's
    sparse_dense_sdf and the JAX package's make_sharded_sparse_fn on a
    (1,2) mesh (tests/test_infer.py:240): volume, cap, count, no escapes.
    Every coarse cell is active, so the boundary planes are decoded on
    both sides."""
    vol, count, esc, cap, _ = ranks[0]["sparse"]
    cfg = Config(**TRAIN).replace(sdf_res=16)
    single = sparse.sparse_dense_sdf(_tensors(setup["params"]), setup["img"],
                                     TRANS, BOX, cfg, device="cpu").numpy()
    np.testing.assert_allclose(vol, single, rtol=VOL_RTOL, atol=VOL_ATOL)
    jm = jmesh.make_mesh(data=1, points=WORLD, devices=jax.devices()[:WORLD])
    # the default block: the cap's rounding follows the decode block
    fn, jcap = jsparse.make_sharded_sparse_fn(JConfig(**TRAIN).replace(
        sdf_res=16), jm, stride=4)
    jvol, jcount, jesc = fn(setup["jparams"], jnp.asarray(setup["img"]),
                            jnp.asarray(TRANS), jnp.asarray(BOX))
    assert count <= cap == jcap and esc == int(jesc) == 0
    assert count == int(jcount)
    np.testing.assert_allclose(vol, np.asarray(jvol), rtol=VOL_RTOL,
                               atol=VOL_ATOL)
    np.testing.assert_array_equal(ranks[1]["sparse"][0], vol)
    # both ranks decoded fine cells, and their shares add up
    assert ranks[0]["sparse"][4] + ranks[1]["sparse"][4] == count
    assert min(ranks[0]["sparse"][4], ranks[1]["sparse"][4]) > 0


def test_record_pass_striped_matches_single(ranks, setup):
    """sharded_records on the sphere at R=33, batch 512 (the JAX test's,
    tests/test_marching.py:558): rec and tq bit for bit the single
    _extract_records' and the JAX package's; assembled, the owned
    extractor's faces."""
    ids, nc, rec, tq, slots, n_iter = ranks[0]["records"]
    assert slots == n_iter * 512 >= nc and len(rec) == len(tq) == nc
    assert nc > 512  # the second rank has a stripe
    vol = torch.from_numpy(setup["sphere"])
    ids1, nc1 = marching._active_cells_ext(vol, 0.0)
    rec1, tq1 = marching._extract_records(vol, ids1, 0.0)
    np.testing.assert_array_equal(ids, ids1.numpy())
    np.testing.assert_array_equal(rec, rec1.numpy())
    np.testing.assert_array_equal(tq, tq1.numpy())
    jvol = jnp.asarray(setup["sphere"])
    jids, jnc, _ = jmarching._active_cells_ext(
        jvol, 0.0, jmarching._norm_gcap(33, None))
    assert int(jnc) == nc
    jrec, jtq = jmarching._extract_records(jvol, jids, jnc, iso=0.0,
                                           n_iter=n_iter, batch=512)
    np.testing.assert_array_equal(rec.view(np.uint16), np.asarray(jrec)[:nc])
    np.testing.assert_array_equal(tq, np.asarray(jtq)[:nc])
    r, t = marching._records_to_host(torch.from_numpy(rec),
                                     torch.from_numpy(tq))
    _, faces = native.mesh_assemble(ids, r, t, nc, 33, BOX)
    np.testing.assert_array_equal(
        faces, marching.extract_mesh_owned(vol, BOX, device="cpu")[1])


def _mesh_sets(v, f):
    tris = np.sort(np.sort(v[f].reshape(len(f), -1), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def test_image_to_mesh_sharded(ranks, setup):
    """sdf_res 32 octahedron, cell_cap_frac 0.9: faces equal to the port's
    image_to_mesh, vertices within the u16 step (tests/test_infer.py:261);
    the JAX package's image_to_mesh's vertex and triangle sets
    (tests/test_torch_pipeline.py's hold); the same mesh on both ranks."""
    v, f = ranks[0]["mesh"]
    cfg = Config(**OCTA)
    p = synthetic.analytic_octahedron_params(cfg, r=0.6, device="cpu")
    wv, wf = ipipeline.image_to_mesh(p, setup["octa_img"],
                                     setup["octa_trans"], cfg, device="cpu")
    assert len(f) > 1000
    np.testing.assert_array_equal(f, wf)
    np.testing.assert_allclose(v, wv, atol=VERT_ATOL)
    jcfg = JConfig(**OCTA)
    jv, jf = jinfer.image_to_mesh(
        jsynthetic.analytic_octahedron_params(jcfg, r=0.6),
        setup["octa_img"][0], setup["octa_trans"], jcfg)
    assert len(v) == len(jv) and len(f) == len(jf)
    for a, b in zip(_mesh_sets(v, f), _mesh_sets(jv, jf)):
        np.testing.assert_allclose(a, b, atol=VERT_ATOL)
    np.testing.assert_array_equal(ranks[1]["mesh"][0], v)
    np.testing.assert_array_equal(ranks[1]["mesh"][1], f)


# ---------------------------------------------------------------------------
# The CLI under torchrun
# ---------------------------------------------------------------------------

def test_cli_train_two_ranks(tree, tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    disn_tpu_torch train --device cpu`: 2 steps of a global batch of 2 (1
    row a rank); only the first rank writes, and its checkpoint restores."""
    log = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "disn_tpu_torch", "train",
           "--device", "cpu", "--data-root", tree["root"], "--log-dir",
           str(log), "--epochs", "1", "--workers", "1", "--log-every", "1",
           "--set", "num_classes=32", "--set", "width_mult=0.125",
           "--set", "batch_size=2", "--set", "num_sample_points=64",
           "--set", "view_num=2", "--set", "cat_limit=4"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("epoch 1 done") == 1
    assert sorted(os.listdir(log)) == ["best.npz", "config.json", "dumps",
                                       "latest.npz", "log_train.txt",
                                       "metrics_train.jsonl"]
    assert sorted(os.listdir(log / "dumps")) == [
        "step000000_gt.obj", "step000000_pred.obj", "step000000_proj.ppm"]
    with open(log / "metrics_train.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]
    latest = jcheckpoint.restore_params(str(log / "latest.npz"))
    assert int(latest["step"]) == 2
    cfg = Config(num_classes=32, width_mult=0.125, batch_size=2,
                 num_sample_points=64, view_num=2)
    state = trainer.create_state(cfg, device="cpu")
    state.load_state_tree(checkpoint.restore(str(log / "latest.npz"),
                                             state.state_tree()))
    assert state.step == 2
