"""The parallel path on the card: a 1-rank NCCL process group runs
image_to_mesh_sharded and the data-parallel train step through the same
collectives as a larger group. Needs an NVIDIA GPU and nvcc; skips
without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Faces equal to image_to_mesh's, vertices within the records' u16 step
(2e-5); the step's loss within 2e-5 of the single-process step's
(tests/test_train.py:68's bound), its gradients within 1e-4 of each
leaf's scale."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from disn_tpu_torch import parallel
from disn_tpu_torch.config import Config
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.ops import fused_decode
from disn_tpu_torch.train import checkpoint, trainer

OCTA = dict(num_classes=32, width_mult=0.125, sdf_res=32,
            compute_dtype="float32", cell_cap_frac=0.9)


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and the CUDA kernels)")
    init = tmp_path_factory.mktemp("nccl") / "rendezvous"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield parallel.make_mesh(data=1, points=1)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_image_to_mesh_sharded_equals_image_to_mesh(nccl):
    cfg = Config(**OCTA)
    params = synthetic.analytic_octahedron_params(cfg, r=0.6)
    img = np.random.RandomState(0).randint(0, 256, (137, 137, 3), np.uint8)
    trans = synthetic.demo_trans_mat()
    wv, wf = pipeline.image_to_mesh(params, img, trans, cfg)
    before = fused_decode.fused_cell_decode.launches
    v, f = pipeline.image_to_mesh_sharded(params, img, trans, cfg, nccl)
    assert fused_decode.fused_cell_decode.launches - before == 2
    assert len(f) > 1000
    np.testing.assert_array_equal(f, wf)
    np.testing.assert_allclose(v, wv, atol=2e-5)


@pytest.mark.cuda
def test_train_step_over_nccl_equals_single(nccl):
    """The loss within 2e-5 and every gradient leaf, as averaged over the
    group, within 1e-4 of the leaf's largest: the sampler's backward adds
    with float atomics, in another order on every run. (The updated
    parameters are not compared: Adam moves a leaf whose gradient is
    within rounding of 0 by up to lr either way.)"""
    cfg = Config(num_classes=32, width_mult=0.125, batch_size=2,
                 num_sample_points=64, compute_dtype="float32")
    rng = np.random.RandomState(0)
    batch = {"img": rng.rand(2, 137, 137, 3).astype(np.float32),
             "sdf_pt": rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32),
             "sdf_val": rng.uniform(-.1, .1, (2, 64, 1)).astype(np.float32),
             "trans_mat": np.stack([synthetic.demo_trans_mat()] * 2)}
    out = []
    for mesh in (None, nccl):
        state = trainer.create_state(cfg, seed=3, mesh=mesh)
        state, losses = trainer.make_train_step(cfg, mesh=mesh)(state, batch)
        out.append((float(losses["overall_loss"]),
                    {p: t.grad.cpu().numpy()
                     for p, t in checkpoint.leaves(state.params)}))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=2e-5)
    for p, want in out[0][1].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(out[1][1][p], want, rtol=0,
                                   atol=1e-4 * scale, err_msg=p)
