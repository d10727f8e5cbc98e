"""K8 (csrc/mv_taps.cu: the multi-view decode's tap mean) on the card
against its plain version on the same card, bit for bit (NaN where the
plain version has NaN), in bf16 and f32 at V = 3 and 24 on seeded
[V,137,137,512] maps: a coarse 17^3 grid, the fine points of active cells
(fused_decode.cell_points), the three boundary planes, hand-made points on
the last row and column and off the image, and a NaN projection; the same
bits twice; one launch counted a call; the wrapper's refusals; the decode
step on its route; the multi-view flow launching it once a decode step.
Needs an NVIDIA GPU and nvcc; skips without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mv_taps_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.config import Config
from disn_tpu_torch.core import grids
from disn_tpu_torch.infer import fused, multiview
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import fused_decode, mv_taps
from mv_edge import EDGE_PTS, edge_cameras

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
K8 = mv_taps.mv_tap_mean


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def cameras(v: int) -> np.ndarray:
    """V cameras around the demo camera (chip_smoke.mv_cameras), C-ordered
    (np.stack keeps the transposed matrices' layout)."""
    from disn_tpu_torch.core import camera
    return np.ascontiguousarray(np.stack([camera.view_params_to_trans_mat(
        45.0 + 360.0 * i / v, 20.0, 1.1, np.zeros(3), 1.0)[0]
        for i in range(v)]), np.float32)


def maps(v: int, dt: str, dev, seed: int = 0) -> torch.Tensor:
    m = np.random.RandomState(seed).randn(v, 137, 137, 512).astype(np.float32)
    return torch.from_numpy(m).to(dev, DTYPES[dt])


def inputs(kind: str, v: int, dev):
    """(trans [V,4,3], pts [P,3]) on the card for one input of [mv taps]."""
    sp = torch.from_numpy(BOX).to(dev)
    trans = torch.from_numpy(cameras(v)).to(dev)
    if kind == "coarse":
        pts = grids.grid_block(sp, 17, 0, 17 ** 3)
    elif kind == "fine":
        ids = torch.arange(0, 512, 3, dtype=torch.int32, device=dev)
        pts, _ = fused_decode.cell_points(ids, 8, 33, sp, 4)
    elif kind == "planes":
        pts, _ = fused.plane_points(33, sp)
    else:
        trans = torch.from_numpy(edge_cameras(v)).to(dev)
        pts = torch.from_numpy(EDGE_PTS).to(dev)
    return trans, pts.contiguous()


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ, NaN against NaN counted equal."""
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(torch.int32) != b.view(torch.int32))
                & ~both_nan).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("views", [3, 24])
@pytest.mark.parametrize("kind", ["coarse", "fine", "planes", "edges"])
def test_kernel_is_the_plain_version_bit_for_bit(card, dt, views, kind):
    m = maps(views, dt, card, seed=views)
    trans, pts = inputs(kind, views, card)
    got = K8(m, trans, pts)
    want = mv_taps.mv_tap_mean_plain(m, trans, pts)
    assert got.dtype == m.dtype and got.shape == (pts.shape[0], 512)
    assert differing(got, want) == 0
    if kind == "edges":
        assert torch.isnan(got[-1].float()).all()
        assert not torch.isnan(got[:-1].float()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_same_bits_twice_and_one_launch_a_call(card, dt):
    m = maps(24, dt, card, seed=1)
    trans, pts = inputs("coarse", 24, card)
    before = K8.launches
    a = K8(m, trans, pts)
    b = K8(m, trans, pts)
    assert K8.launches == before + 2
    assert torch.equal(a.view(torch.int16 if dt == "bf16" else torch.int32),
                       b.view(torch.int16 if dt == "bf16" else torch.int32))
    empty = K8(m, trans, pts[:0])
    assert empty.shape == (0, 512) and K8.launches == before + 2


@pytest.mark.cuda
def test_events_and_inputs_hooks(card):
    m = maps(3, "bf16", card)
    trans, pts = inputs("planes", 3, card)
    K8.events, K8.inputs = [], []
    try:
        K8(m, trans, pts)
        (start, end), = K8.events
        (args, kw), = K8.inputs
    finally:
        K8.events = K8.inputs = None
    torch.cuda.synchronize()
    assert start.elapsed_time(end) > 0
    assert args[0] is m and args[2] is pts and kw == dict(img_w=137,
                                                          img_h=137)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["mixed", "shape", "misaligned"])
def test_wrapper_refuses(card, bad):
    m = maps(3, "bf16", card)
    trans, pts = inputs("coarse", 3, card)
    if bad == "mixed":
        pts = pts.cpu()
    elif bad == "shape":
        m = m[:, :, :, :256].contiguous()
    else:
        buf = torch.empty(m.numel() + 8, dtype=m.dtype, device=card)
        m = buf[1:1 + m.numel()].view(m.shape)
        assert m.is_contiguous() and m.data_ptr() % 16
    before = K8.launches
    with pytest.raises(ValueError):
        K8(m, trans, pts)
    assert K8.launches == before


@pytest.mark.cuda
def test_decode_step_on_the_kernel_route(card):
    """K8 materialises no [V,P,512] taps: the step is TAP_BYTES over a
    point's [512] f32 activations, 262,144 points at any V."""
    cfg = Config()
    for v in (3, 24):
        state = (None, torch.zeros(v, 1, 1, 1, device=card), None, None)
        assert multiview.decode_step(state, cfg) == 262144


@pytest.mark.cuda
def test_the_flow_launches_k8_once_a_decode_step(card, monkeypatch):
    """multiview_sdf at sdf_res 16 with 64-point decode steps: one K8
    launch for each _mv_decode call, no K1."""
    cfg = Config(num_classes=32, width_mult=0.125, sdf_res=16)
    p = disn.init(cfg, seed=3, device="cpu")
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (3, 137, 137, 3), dtype=np.uint8)
    monkeypatch.setattr(multiview, "TAP_BYTES", 64 * 512 * 4)
    steps = []
    real = multiview._mv_decode

    def counted(*a, **kw):
        steps.append(a[3].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(multiview, "_mv_decode", counted)
    k1, before = fused_decode.fused_cell_decode, K8.launches
    k1_before = k1.launches
    vol = multiview.multiview_sdf(p, imgs, cameras(3), BOX, cfg, device=card)
    assert vol.shape == (17, 17, 17) and bool(torch.isfinite(vol).all())
    assert len(steps) == -(-17 ** 3 // 64) and max(steps) == 64
    assert K8.launches - before == len(steps)
    assert k1.launches == k1_before
