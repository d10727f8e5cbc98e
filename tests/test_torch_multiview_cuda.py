"""Multi-view fusion (infer/multiview) on the card against the same code on
the CPU, at test size (width 0.125, 32 classes, V = 3, sdf_res 16-32), f32
with TF32 off: within F32_REL of the volume's largest value (summation
order). Needs an NVIDIA GPU; skips without one. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_multiview_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import multiview, pipeline, sparse
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import fused_decode, sparse_words

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
SMALL = dict(num_classes=32, width_mult=0.125, compute_dtype="float32")
F32_REL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def views(v=3, seed=1):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (v, 137, 137, 3), dtype=np.uint8)
    trans = np.stack([np.vstack([np.eye(3) * (50 + 10 * i),
                                 [68.0, 68.0, 2.0]]) for i in range(v)]
                     ).astype(np.float32)
    return imgs, trans


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def params_of(kind, cfg):
    if kind == "random":
        return disn.init(cfg, seed=3, device="cpu")
    p = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6,
                                             device="cpu")
    last = p["sdfprediction_imgfeat"]["fold2"]["conv5_bi" if cfg.binary
                                               else "conv5"]
    last["weights"] = torch.from_numpy(0.02 * np.random.RandomState(5).randn(
        *last["weights"].shape).astype(np.float32))
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["tf1", "native"])
def test_dense_stream_on_the_card_matches_the_cpu(card, sampling):
    """The folded (tf1) and the general (native) arm."""
    cfg = Config(**SMALL, sdf_res=16, sampling=sampling)
    p = params_of("random", cfg)
    imgs, trans = views()
    got = multiview.multiview_sdf(p, imgs, trans, BOX, cfg, device=card)
    want = multiview.multiview_sdf(p, imgs, trans, BOX, cfg, device="cpu")
    assert got.device.type == card.type and got.shape == (17, 17, 17)
    assert rel(got, want) <= F32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("kind,binary,sampling", [
    ("random", False, "tf1"), ("live", False, "tf1"),
    ("live", False, "native"), ("random", True, "tf1"),
    ("live", True, "tf1")])
def test_sparse_phases_on_the_card_match_the_cpu(card, kind, binary,
                                                  sampling):
    """phase_a: the coarse grid within F32_REL and the same active cells
    (band cull, or the sign cull for a binary head) on these inputs, whose
    coarse values stay off the thresholds; finish from the same cells."""
    cfg = Config(**SMALL, sdf_res=32, binary=binary, sampling=sampling)
    p = params_of(kind, cfg)
    imgs, trans = views()
    out = {}
    for dev in (card, torch.device("cpu")):
        pd = device_mod.tree_to(p, dev)
        im, tr, sp = multiview._inputs(imgs, trans, BOX, dev)
        out[dev.type] = (pd, tr, sp, *multiview.phase_a(pd, im, tr, sp, cfg,
                                                       4))
    pg, trg, spg, state_g, vol_g, ids_g, n_g = out[card.type]
    pc, trc, spc, state_c, vol_c, ids_c, n_c = out["cpu"]
    assert rel(vol_g, vol_c) <= F32_REL
    assert n_g == n_c > 0 and torch.equal(ids_g.cpu(), ids_c)
    fine_g = multiview.finish(pg, state_g, vol_c.to(card), ids_c.to(card),
                              trg, spg, cfg, 4)
    fine_c = multiview.finish(pc, state_c, vol_c, ids_c, trc, spc, cfg, 4)
    assert rel(fine_g, fine_c) <= F32_REL


@pytest.mark.cuda
def test_tiny_cap_gives_none_on_the_card(card):
    cfg = Config(**SMALL, sdf_res=32)
    imgs, trans = views()
    stats = {}
    assert multiview.multiview_sdf_sparse(
        params_of("random", cfg), imgs, trans, BOX, cfg, block=64,
        cell_cap_frac=0.0, device=card, stats=stats) is None
    assert stats["dense_fallback"] and stats["cell_cap"] == 256


@pytest.mark.cuda
def test_sparse_mesh_equals_dense_mesh_on_the_card(card):
    """The analytic head: the sparse volume's mesh is the dense stream's
    (faces equal, vertices within 1e-6), on the surface within 1e-5, and
    multiview_to_mesh launches neither K1 nor K5."""
    cfg = Config(**SMALL, sdf_res=32)
    p = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6,
                                             device="cpu")
    imgs, trans = views()
    dv, df = pipeline.volume_to_mesh(
        multiview.multiview_sdf(p, imgs, trans, BOX, cfg, device=card), BOX)
    k1, k5 = fused_decode.fused_cell_decode, sparse_words.sparse_cell_words
    before = (k1.launches, k5.launches)
    stats = {}
    sv, sf = pipeline.multiview_to_mesh(p, imgs, trans, BOX, cfg,
                                        device=card, stats=stats)
    assert (k1.launches, k5.launches) == before
    assert not stats["dense_fallback"] and len(sf) > 1000
    np.testing.assert_array_equal(sf, df)
    np.testing.assert_allclose(sv, dv, atol=1e-6)
    assert np.abs(np.abs(sv).sum(1) - 0.6).max() < 1e-5


@pytest.mark.cuda
def test_bf16_decode_on_the_card_matches_the_cpu(card):
    """bf16 on the folded arm: tests/test_fused.py's bf16 bounds (both
    devices round to bf16 per layer, with f32 sums in other orders): max
    2% and mean 0.3% of the volume's largest value."""
    cfg = Config(**dict(SMALL, compute_dtype="bfloat16"), sdf_res=16)
    p = params_of("random", cfg)
    imgs, trans = views()
    got = multiview.multiview_sdf(p, imgs, trans, BOX, cfg,
                                  device=card).cpu()
    want = multiview.multiview_sdf(p, imgs, trans, BOX, cfg, device="cpu")
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 0.02 * scale
    assert float((got - want).abs().mean()) <= 0.003 * scale


@pytest.mark.cuda
def test_active_cells_on_the_card_equal_the_cpus(card):
    """The cull alone on one grid (values at 0 and at tau included)."""
    rng = np.random.RandomState(2)
    lin = np.linspace(-1, 1, 17)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = (np.sqrt(x * x + y * y + z * z) - 0.6
           + 0.05 * rng.randn(17, 17, 17)).astype(np.float32)
    vol[rng.rand(17, 17, 17) < 0.05] = 0.0
    vol[0, 0, :2] = [0.15, -0.15]
    for mode in ("band", "sign"):
        ids_c, n_c = sparse._active_cells(torch.from_numpy(vol),
                                          torch.tensor(0.15), mode=mode)
        ids_g, n_g = sparse._active_cells(torch.from_numpy(vol).to(card),
                                          torch.tensor(0.15, device=card),
                                          mode=mode)
        assert n_g == n_c > 0 and torch.equal(ids_g.cpu(), ids_c)
