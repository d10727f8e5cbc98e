"""The other heads on the card: every variant's volume on the card against
the CPU's, which decode K1 launches (Config.fused_kernel), and the binary
twostream head's dense route through K1. Needs an NVIDIA GPU and nvcc;
skips without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_variants_cuda.py

f32 with TF32 off on both devices; the volumes agree within 1e-4 of their
scale (another summation order on the card)."""
import numpy as np
import pytest
import torch

from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import fused_decode

SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32")
BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _params(cfg):
    """A seeded net of cfg's variant with head biases N(0, 0.1^2)."""
    p = disn.init(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "biases":
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))

    walk({k: v for k, v in p.items() if k != "vgg_16"})
    return p


def _volumes(cfg, sparse=True):
    p = _params(cfg)
    img = np.random.RandomState(3).randint(0, 256, (137, 137, 3), np.uint8)
    trans = synthetic.demo_trans_mat()
    k1 = fused_decode.fused_cell_decode
    before = k1.launches
    card_vol = pipeline.predict_volume(p, img, trans, BOX, cfg,
                                       device="cuda", sparse=sparse)
    torch.cuda.synchronize()
    launches = k1.launches - before
    cpu_vol = pipeline.predict_volume(p, img, trans, BOX, cfg, device="cpu",
                                      sparse=sparse)
    got, want = card_vol.cpu().numpy(), cpu_vol.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("variant,sampling,binary", [
    ("onestream", "tf1", False), ("onestream", "native", True),
    ("global", "tf1", False), ("twostream", "native", False),
    ("threedcnn", "tf1", True)])
def test_variant_volume_on_the_card_equals_the_cpu(card, variant, sampling,
                                                   binary):
    """sdf_res 48: off twostream + tf1 no K1 launch, the plain decode on
    both devices (THREEDCNN: its 65^3 forward)."""
    cfg = Config(**SMALL, sdf_res=48, variant=Variant(variant),
                 sampling=sampling, binary=binary, binary_sparse=binary,
                 tanh=binary)
    assert _volumes(cfg) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,want", [("auto", 1), ("off", 0)])
def test_fused_kernel_setting_on_the_card(card, mode, want):
    """twostream + tf1 at 49^3, the dense route: 'auto' launches K1 once
    (every cell), 'off' never; both equal the CPU's volume."""
    cfg = Config(**SMALL, sdf_res=48, fused_kernel=mode)
    assert _volumes(cfg, sparse=False) == want


@pytest.mark.cuda
def test_binary_twostream_dense_route_through_k1(card):
    """The binary twostream head's default route (exact dense, no
    binary_sparse) at 49^3: K1 once with out_dim 2, the volume the CPU's
    (its plain version)."""
    cfg = Config(**SMALL, sdf_res=48, binary=True)
    assert _volumes(cfg) == 1
