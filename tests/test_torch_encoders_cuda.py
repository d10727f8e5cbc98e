"""The alternate encoders, RGBA input and preprocess-sdf's extraction on the
card against the same code on the CPU. Needs an NVIDIA GPU and nvcc; skips
without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_encoders_cuda.py

f32 with TF32 off on both devices; encoder outputs within 1e-4 of their
scale (cuDNN sums convolutions in other orders); meshes with equal faces
and vertices within 1e-6."""
import numpy as np
import pytest
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, EncoderKind
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import fused_decode, marching
from disn_tpu_torch.preprocessing import sdf_gen

SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32")
RTOL = 1e-4


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


def _rel(got, want):
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max()
                 / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("encoder", ["alexnet", "resnet"])
def test_encode_card_matches_cpu(card, encoder, alpha):
    """The embedding and every endpoint map of two u8 images."""
    cfg = Config(encoder=EncoderKind(encoder), alpha=alpha, **SMALL)
    params = disn.init(cfg, seed=0, device="cpu")
    img = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 137, 137, cfg.img_channels), np.uint8))
    want = disn.encode(params, img, cfg)
    got = disn.encode(device_mod.tree_to(params, torch.device("cuda")),
                      img.cuda(), cfg)
    assert _rel(got[0], want[0]) <= RTOL
    for name in want[1]:
        assert _rel(got[1][name], want[1][name]) <= RTOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["alexnet", "resnet"])
def test_image_to_mesh_rgba_on_card(card, encoder):
    """image_to_mesh on an RGBA image at sdf_res 64, the octahedron head
    over the encoder: K1 runs on the card, and the mesh is the CPU's."""
    cfg = Config(encoder=EncoderKind(encoder), alpha=True, sdf_res=64,
                 cell_cap_frac=0.9, **SMALL)
    params = synthetic.analytic_octahedron_params(cfg, device="cpu")
    img = np.random.RandomState(2).randint(0, 256, (137, 137, 4), np.uint8)
    trans = synthetic.demo_trans_mat()
    want = pipeline.image_to_mesh(params, img, trans, cfg, device="cpu")
    k1 = fused_decode.fused_cell_decode
    before = k1.launches
    got = pipeline.image_to_mesh(params, img, trans, cfg, device="cuda")
    assert k1.launches - before >= 2
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_generate_object_extracts_on_card(card, tmp_path, monkeypatch):
    """generate_object's ground-truth mesh extracted on the card equals the
    CPU's marching_tets + weld of the same volume (res 64). The writers are
    replaced by in-memory stand-ins (the card's machine may lack h5py)."""
    from disn_tpu_torch.core import codecs
    written = {}
    monkeypatch.setattr(codecs, "write_sdf_h5", lambda *a, **k: None)
    monkeypatch.setattr(codecs, "write_obj",
                        lambda path, v, f: written.update(mesh=(v, f)))
    lin = np.linspace(-1, 1, 33, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = synthetic.sdf_sphere(np.stack([xx, yy, zz], -1)).astype(np.float32)
    verts, faces = marching.extract_mesh(torch.from_numpy(vol),
                                         np.array([-1, -1, -1, 1, 1, 1],
                                                  np.float32))
    field = sdf_gen.object_field(verts, faces, sdf_res=64)
    stats: dict = {}
    sdf_gen.write_object(field, str(tmp_path), device="cuda", stats=stats)
    gv, gf = written["mesh"]
    cv, cf = marching.extract_mesh(torch.from_numpy(field.vol),
                                   field.bbox.astype(np.float32), iso=0.003)
    np.testing.assert_array_equal(gf, cf)
    np.testing.assert_allclose(gv, cv, rtol=0, atol=1e-6)
    assert stats["marching_tets_ms"] > 0
