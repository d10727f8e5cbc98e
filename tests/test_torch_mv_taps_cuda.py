"""K8 (csrc/mv_taps.cu: the multi-view decode's tap mean) on the card
against its plain version on the same card, bit for bit (NaN where the
plain version has NaN), in bf16 and f32 at V = 3 and 24 on seeded
[V,137,137,512] maps: a coarse 17^3 grid, the fine points of active cells
(fused_decode.cell_points), the three boundary planes, hand-made points on
the last row and column and off the image, and a NaN projection; the same
bits twice; one launch counted a call; the wrapper's refusals; the decode
step on its route; the multi-view flow launching it once a decode step.
The staged design (a tile's pixel box in shared memory a view) is held
bit for bit in both types at V = 1, 24 and 30 on the coarse grid in
4^3-block order, fine cells, random-order points (every tile-view
direct), cells on the image's edge, a partial last tile and NaN tiles
(tests/mv_edge.plan_tiles); a -DMV_TRACE build's staged and direct
tile-views equal ops/mv_taps.tile_plan's on the same inputs; a map of more
than 4 GiB a view is read at the right pixels on both paths.
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
from mv_edge import (CELL_STEP, EDGE_PTS, PLAN_STAGE_PX, cell, edge_cameras,
                     plan_tiles)

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


def staged_inputs(kind: str, v: int, dev):
    """(trans [V,4,3], pts [P,3]) on the card for the staged design's
    inputs: 'blocks' the first 77 4^3 blocks of the 65^3 coarse grid in
    4^3-block order (some boxes staged, some not, at every V), 'fine' the
    points of 170 cells in cell_points order, 'random' 3,000 points in
    [-1,1]^3 (every tile-view direct), 'edge' cells on the last column,
    the last row and the corner pixel and a cell past the image (clamped)
    under the edge cameras, 'nan' plan_tiles under them (NaN tiles staged
    and direct, a partial last tile of 10 points), 'partial' the fine
    points and 17 more (a partial last tile of 17)."""
    sp = torch.from_numpy(BOX).to(dev)
    trans = torch.from_numpy(cameras(v)).to(dev)
    if kind == "blocks":
        pts = grids.grid_block(sp, 65, 0, 65 ** 3)[grids.block_order(
            65, dev)[:64 * 77]]
    elif kind in ("fine", "partial"):
        ids = torch.arange(0, 512, 3, dtype=torch.int32, device=dev)
        pts, _ = fused_decode.cell_points(ids, 8, 33, sp, 4)
        if kind == "partial":
            pts = torch.cat([pts, pts[:17] * 0.5])
    elif kind == "random":
        pts = torch.from_numpy(np.random.RandomState(v).uniform(
            -1, 1, (3000, 3)).astype(np.float32)).to(dev)
    else:
        trans = torch.from_numpy(edge_cameras(v)).to(dev)
        last = 1 - 3 * CELL_STEP
        pts = torch.from_numpy(
            plan_tiles()[0] if kind == "nan" else np.concatenate([
                cell(last, 0.25, 0.0), cell(0.25, last, 0.0),
                cell(last, last, 0.0), cell(1.02, 0.5, 0.0)])).to(dev)
    return trans, pts.contiguous()


STAGED_KINDS = ["blocks", "fine", "random", "edge", "nan", "partial"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("views", [1, 24, 30])
@pytest.mark.parametrize("kind", STAGED_KINDS)
def test_staged_kernel_is_the_plain_version_bit_for_bit(card, dt, views,
                                                        kind):
    """V = 30 takes the tables of 24 views, then of 6 (csrc/mv_taps.cu's
    VCH), the ring running on across the two."""
    m = maps(views, dt, card, seed=views + 1)
    trans, pts = staged_inputs(kind, views, card)
    plan = mv_taps.tile_plan(trans, pts)
    if kind == "random":
        assert not plan.any()
    elif kind in ("blocks", "fine", "partial", "edge"):
        assert plan.any()
    before = K8.launches
    got = K8(m, trans, pts)
    assert K8.launches == before + 1
    want = mv_taps.mv_tap_mean_plain(m, trans, pts)
    assert got.shape == (pts.shape[0], 512)
    assert differing(got, want) == 0
    if kind in ("edge", "nan"):
        nan_rows = torch.isnan(got.float()).all(1)
        assert int(nan_rows.sum()) == (2 if kind == "nan" else 0)
        assert not torch.isnan(got[~nan_rows].float()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_trace_counts_are_the_tile_plan(card, dt):
    """A -DMV_TRACE build counts each launch's staged and direct
    tile-views (a tile's slice-0 CTA a view); they equal tile_plan's on
    every staged input at V = 24, and the plan of plan_tiles at 32 px a
    stage is the one tests/mv_edge.py names (at V = 3: under the edge
    cameras of higher views every tile lands clamped on a corner)."""
    lib = mv_taps.bind(mv_taps.build(("MV_TRACE",)))
    m = maps(24, dt, card, seed=2)
    for kind in STAGED_KINDS:
        trans, pts = staged_inputs(kind, 24, card)
        plan = mv_taps.tile_plan(trans, pts)
        assert mv_taps.trace_launch(lib, m, trans, pts)[:2] == \
            [int(plan.sum()), int((~plan).sum())], kind
    trans, pts = staged_inputs("nan", 3, card)
    plan = mv_taps.tile_plan(trans, pts, stage_px=PLAN_STAGE_PX)
    assert plan.tolist() == [plan_tiles()[1]] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("dt,side", [("f32", 1456), ("bf16", 2056)])
def test_a_map_past_4_gib_a_view(card, dt, side):
    """One view of side x side x 512 past 2^32 bytes: the direct path's
    byte offsets pass 32 bits. Under a camera that maps [-1,1]^2 onto the
    whole image (w = 1), a tile of 64 points at the far corner (staged)
    and 2,000 random points (every tile direct) equal the plain
    version."""
    assert side * side * 512 * (4 if dt == "f32" else 2) > 2 ** 32
    g = torch.Generator(device=card).manual_seed(side)
    m = torch.randn(1, side, side, 512, generator=g, device=card,
                    dtype=DTYPES[dt])
    half = (side - 1) / 2
    trans = torch.tensor([[[half, 0, 0], [0, half, 0], [0, 0, 0],
                           [half, half, 1]]], dtype=torch.float32,
                         device=card)
    rand = np.random.RandomState(side).uniform(-1, 1, (2000, 3))
    # 64 points on pixels side - 6 .. side - 3 of x and y: a 5 x 5 box
    u = (np.arange(side - 6, side - 2) - half) / half
    far = np.stack(np.meshgrid(u, u, [0.0, 0.1, 0.2, 0.3], indexing="ij"),
                   -1).reshape(-1, 3)
    pts = torch.from_numpy(np.concatenate([far, rand]).astype(np.float32)
                           ).to(card)
    plan = mv_taps.tile_plan(trans, pts, img_w=side, img_h=side)
    assert plan[0, 0] and not plan[0, 1:].any()
    got = K8(m, trans, pts, img_w=side, img_h=side)
    want = mv_taps.mv_tap_mean_plain(m, trans, pts, img_w=side, img_h=side)
    assert differing(got, want) == 0
