"""The port's training path on the card against the same code on the CPU:
the step's loss and gradients (float64, so that no ReLU input or L1
residual within rounding of 0 lands on the other side), the fused Adam
update, and the loader's pinned, non-blocking copies. Needs an NVIDIA GPU;
skips without one. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.config import Config
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data import pipeline, synthetic
from disn_tpu_torch.models import disn
from disn_tpu_torch.train import checkpoint, trainer

CFG = Config(width_mult=0.125, num_classes=32, batch_size=2,
             num_sample_points=128)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def batch(seed=0, b=2, n=128):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    return {"img": rng.rand(b, 137, 137, 3).astype(np.float32),
            "sdf_pt": pts, "sdf_pt_rot": pts,
            "sdf_val": (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.5
                        ).astype(np.float32),
            "trans_mat": np.stack([synthetic.demo_trans_mat()] * b)}


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [False, True])
def test_step_equals_the_cpu_run_in_float64(binary):
    """Every loss entry within 1e-6 relative, every gradient leaf within
    1e-6 of its largest entry: float64 on both devices, summed in other
    orders, but the leaves (and so their gradients) are float32, and the
    L2 term is summed in float32."""
    card()
    cfg = CFG.replace(compute_dtype="float64", binary=binary)
    params = disn.init(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        st = trainer.create_state(cfg, params=params, device=dev)
        losses = trainer.compute_gradients(
            st, {k: torch.from_numpy(v).to(dev) for k, v in batch().items()})
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
def test_fused_adam_equals_the_cpu_update():
    """Three updates from the same gradients: the card's fused Adam and the
    CPU's land within 1e-6 (updates are ~lr = 1e-4)."""
    card()
    params = disn.init(CFG, seed=1, device="cpu")
    states = [trainer.create_state(CFG, params=params, device=d)
              for d in ("cuda", "cpu")]
    rng = np.random.RandomState(0)
    for _ in range(3):
        for (_, a), (_, b) in zip(checkpoint.leaves(states[0].params),
                                  checkpoint.leaves(states[1].params)):
            g = torch.from_numpy(rng.randn(*b.shape).astype(np.float32))
            a.grad, b.grad = g.cuda(), g
        for s in states:
            s.apply_gradients()
    for (path, a), (_, b) in zip(checkpoint.leaves(states[0].params),
                                 checkpoint.leaves(states[1].params)):
        assert (a.detach().cpu() - b.detach()).abs().max().item() <= 1e-6, \
            path
    tree = [checkpoint._flatten(s.state_tree()) for s in states]
    assert set(tree[0]) == set(tree[1])


@pytest.mark.cuda
def test_loader_pins_and_copies_to_the_card():
    """The loader hands out card tensors equal to the host batches, in
    order, from page-locked copies."""
    card()
    cfg = synthetic.tiny_config(num_sample_points=64)
    rng = np.random.RandomState(0)
    s = synthetic.stratified_sample(synthetic.sdf_sphere, num=1024, rng=rng)
    rec = codecs.SdfSamples(ori_pt=s[:8, :3], sample_pt=s[:, :3],
                            sample_sdf=s[:, 3],
                            norm_params=np.array([0, 0, 0, 1], np.float32),
                            sdf_params=np.array([-1, -1, -1, 1, 1, 1],
                                                np.float32))
    _, view = synthetic.render_view(synthetic.sdf_sphere, 30.0, 25.0, 0.85)

    class Memory(pipeline.SdfImageDataset):
        def _load_sdf(self, cat_id, obj):
            return rec

        def _read_view(self, cat_id, obj, v):
            return view

    li = [(synthetic.SYNTH_CAT, "sphere0", v) for v in range(6)]
    mk = [pipeline.PrefetchLoader(
        Memory(cfg, None, li), pipeline.EpochSampler(
            li, {synthetic.SYNTH_CAT: 6}, cfg.cat_limit, seed=0), 2, 2,
        workers=1, seed=0, device=d).start() for d in ("cuda", "cpu")]
    try:
        got, want = list(mk[0]), list(mk[1])
    finally:
        for loader in mk:
            loader.shutdown()
    assert len(got) == len(want) == 6
    for b, w in zip(got, want):
        for k in w:
            assert b[k].is_cuda
            assert torch.equal(b[k].cpu(), w[k]), k
