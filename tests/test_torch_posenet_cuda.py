"""The camera net and the estimated-camera reconstruction on the card
against the same code on the CPU. Needs an NVIDIA GPU (and nvcc for K1
and K5); skips without one. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_posenet_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from disn_tpu_torch import convert
from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.models import posenet
from disn_tpu_torch.ops import fused_decode, sparse_words
from disn_tpu_torch.train import checkpoint, trainer

CFG = Config(width_mult=0.125, num_classes=32, batch_size=2,
             num_sample_points=128, cam_shift=True, cam_loss_mode="all")
DEMO = os.path.join(os.path.dirname(os.path.dirname(__file__)), "demo")


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def batch(seed=0, b=2, n=128):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(b, 137, 137, 3).astype(np.float32),
            "sample_pc": rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32),
            "RT": np.stack([np.eye(4, 3, dtype=np.float32)] * b),
            "trans_mat": np.stack([synthetic.demo_trans_mat()] * b),
            "shifts": rng.uniform(-0.2, 0.2, (b, 2)).astype(np.float32)}


@pytest.mark.cuda
def test_forward_equals_the_cpu_run():
    """pred_trans_mat and pred_xyshift within 1e-4 of their scale (f32,
    TF32 off: cuDNN and the CPU sum the convolutions in other orders)."""
    card()
    params = posenet.init(CFG, seed=0, device="cpu")
    img = torch.from_numpy(batch()["img"])
    out = {d: posenet.apply(device_mod.tree_to(params, torch.device(d)),
                            img.to(d), CFG) for d in ("cuda", "cpu")}
    for k in ("pred_trans_mat", "pred_xyshift"):
        want = out["cpu"][k].detach()
        got = out["cuda"][k].detach().cpu()
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_cam_step_equals_the_cpu_run_in_float64():
    """Every loss entry within 1e-6 relative and every gradient leaf within
    1e-6 of its largest entry: float64 on both devices, so that no ReLU
    input within rounding of 0 lands on the other side; the leaves are
    float32 and the L2 term sums in float32."""
    card()
    cfg = CFG.replace(compute_dtype="float64")
    params = posenet.init(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        st = trainer.create_state(cfg, params=params, device=dev)
        losses = trainer.compute_gradients(
            st, {k: torch.from_numpy(v).to(dev) for k, v in batch().items()},
            trainer.cam_loss_fn)
        out[dev] = (losses, st)
    for k, v in out["cpu"][0].items():
        assert abs(out["cuda"][0][k].item() - v.item()) <= 1e-6 * max(
            abs(v.item()), 1e-3), k
    for (path, g), (_, c) in zip(checkpoint.leaves(out["cuda"][1].params),
                                 checkpoint.leaves(out["cpu"][1].params)):
        scale = c.grad.abs().max().item()
        assert (g.grad.cpu() - c.grad).abs().max().item() <= 1e-6 * scale, \
            path


@pytest.mark.cuda
def test_estimated_camera_reconstruction_equals_the_cpu_run():
    """The bundled float16 checkpoints on a rendered torus view at sdf_res
    64: the card's estimated camera within 1e-4 of the CPU's (relative to
    its scale); the CPU's route on the card with K1 twice (the trained
    net's band overflows the cell cap at this size, so the coarse pass is
    followed by the dense fallback, both through K1, and no K5); and its
    mesh within 2% of the CPU's face count with every vertex within one
    cell edge (2/64) of the other mesh's vertices (a grid value within
    rounding of the iso may take the other sign on the other device)."""
    card()
    cfg = Config(width_mult=0.25, num_classes=128, sdf_res=64)
    cam = convert.load_npz(os.path.join(DEMO, "tiny_posenet.npz"))["params"]
    sdf = convert.load_npz(os.path.join(DEMO, "tiny_synth.npz"))["params"]
    img = synthetic.render_view(synthetic.sdf_torus, 40.0, 25.0, 0.85)[0]
    img = np.ascontiguousarray(img[:, :, :3])
    k1, k5 = fused_decode.fused_cell_decode, sparse_words.sparse_cell_words
    res = {}
    for dev in ("cpu", "cuda"):
        stats: dict = {}
        before = (k1.launches, k5.launches)
        mesh = pipeline.reconstruct_image(sdf, img, cfg, cam_params=cam,
                                          device=dev, stats=stats)
        res[dev] = (mesh, stats, (k1.launches - before[0],
                                  k5.launches - before[1]))
    (cv, cf), cstats, counts = res["cuda"]
    (pv, pf), pstats, _ = res["cpu"]
    scale = np.abs(pstats["trans_mat"]).max()
    assert np.abs(cstats["trans_mat"] - pstats["trans_mat"]).max() <= \
        1e-4 * scale
    assert cstats["route"] == pstats["route"]
    assert counts == (2, int(cstats["route"] == "records_sparse"))
    assert len(pf) > 1000 and abs(len(cf) - len(pf)) <= 0.02 * len(pf)
    d = torch.cdist(torch.from_numpy(cv), torch.from_numpy(pv))
    assert max(d.min(1).values.max().item(), d.min(0).values.max().item()) \
        <= 2.0 / 64
