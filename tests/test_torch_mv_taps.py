"""disn_tpu_torch.ops.mv_taps (K8's plain version and wrapper: the
multi-view decode's tap mean) against disn_tpu's composition of the same
function on the CPU: camera.project_points, then image.resampler, then the
float32 mean over the views cast to the compute type
(disn_tpu/infer/multiview.py:111-119), from seeded numpy inputs; and the
folded arm of infer/multiview._mv_decode through it.

Tolerances. float32: the port sums the views in order and divides by V;
XLA reduces and divides in its own order, a few ulps of the mean apart,
so atol is 8 ulps of the largest value (8 x 2^-23 x max|want|); the
projections agree bit for bit on these inputs. bfloat16: the f32 means
round to bf16 on both sides, so where they sit a few f32 ulps apart
across a bf16 rounding boundary they differ by one bf16 ulp: 2^-8 of the
value on top of the f32 bound. The decode through the port's multi-view
module is held with tests/test_torch_multiview.py's tolerances (named
there)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from disn_tpu.config import Config as JConfig
from disn_tpu.core import camera as jcamera
from disn_tpu.infer import multiview as jmv
from disn_tpu.models import disn as jdisn
from disn_tpu.ops import image as jimage
from disn_tpu_torch import convert
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import grids
from disn_tpu_torch.infer import multiview
from disn_tpu_torch.ops import mv_taps
from mv_edge import EDGE_PTS, PLAN_STAGE_PX, edge_cameras, plan_tiles
from torch_threads import few_threads  # noqa: F401  (autouse)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -8


def ladder(v: int) -> np.ndarray:
    """tests/test_torch_multiview.py's cameras: focal 50 + 10 i, w = 50 z +
    2, so points near z = -0.04 project far off the image (clamped)."""
    return np.stack([np.vstack([np.eye(3) * (50 + 10 * i),
                                [68.0, 68.0, 2.0]]) for i in range(v)]
                    ).astype(np.float32)


def maps_of(v: int, c: int, dtype: str, seed: int) -> np.ndarray:
    """Seeded [V,137,137,C] maps as f32 values the compute type holds."""
    m = np.random.RandomState(seed).randn(v, 137, 137, c).astype(np.float32)
    return np.array(jnp.asarray(m).astype(DTYPES[dtype][1])
                    .astype(jnp.float32))


def jax_tap_mean(maps: np.ndarray, trans: np.ndarray, pts: np.ndarray,
                 dtype: str) -> np.ndarray:
    """disn_tpu's composition, as its _mv_decode's folded arm writes it."""
    jd = DTYPES[dtype][1]
    v = maps.shape[0]
    px = jcamera.project_points(
        jnp.broadcast_to(jnp.asarray(pts)[None], (v,) + pts.shape),
        jnp.asarray(trans))
    taps = jimage.resampler(jnp.asarray(maps).astype(jd), px)
    return np.asarray(jnp.mean(taps.astype(jnp.float32), axis=0).astype(jd)
                      .astype(jnp.float32))


def port_tap_mean(maps, trans, pts, dtype, fn=mv_taps.mv_tap_mean_plain):
    out = fn(torch.from_numpy(maps).to(DTYPES[dtype][0]),
             torch.from_numpy(trans), torch.from_numpy(pts))
    assert out.dtype == DTYPES[dtype][0]
    assert out.shape == (pts.shape[0], maps.shape[-1])
    return out.float().numpy()


def assert_tap_close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    """The module docstring's tolerances; NaN only where JAX has NaN."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    bound = 8 * F32_ULP * float(np.abs(want[ok]).max())
    if dtype == "bfloat16":
        bound = bound + BF16_ULP * np.abs(want[ok])
    assert (np.abs(got[ok] - want[ok]) <= bound).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("views", [1, 3, 5])
def test_plain_matches_jax(dtype, views):
    """64 channels, 3,000 points in [-1,1]^3 under the ladder cameras:
    inside the image, on and past its edges (the clamp)."""
    maps = maps_of(views, 64, dtype, seed=views)
    pts = np.random.RandomState(10 + views).uniform(
        -1, 1, (3000, 3)).astype(np.float32)
    trans = ladder(views)
    assert_tap_close(port_tap_mean(maps, trans, pts, dtype),
                     jax_tap_mean(maps, trans, pts, dtype), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("views", [1, 3, 5])
def test_plain_matches_jax_on_the_edges(dtype, views):
    """The last row and column (their +1 taps count zero), off the image,
    an infinite projection (clamped) and a NaN one (NaN in every channel,
    as in JAX)."""
    maps = maps_of(views, 64, dtype, seed=20 + views)
    trans = edge_cameras(views)
    got = port_tap_mean(maps, trans, EDGE_PTS, dtype)
    want = jax_tap_mean(maps, trans, EDGE_PTS, dtype)
    assert np.isnan(got[-1]).all() and not np.isnan(got[:-1]).any()
    assert_tap_close(got, want, dtype)
    # the last column's sample is the pixel's own value, weight 1
    px = mv_taps.camera.project_points(
        torch.from_numpy(EDGE_PTS[None, :4]).expand(views, -1, -1),
        torch.from_numpy(trans))
    assert (px[:, 0, 0] == 136).all() and (px[:, 1, 1] == 136).all()
    assert (px[:, 2] == 136).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrapper_on_the_cpu_is_the_plain_version_at_512_channels(dtype):
    """512 channels, V = 3, 300 points with the edge ones: mv_tap_mean on
    CPU tensors is mv_tap_mean_plain bit for bit and launches nothing;
    both within the tolerances of JAX."""
    maps = maps_of(3, 512, dtype, seed=7)
    rng = np.random.RandomState(8)
    pts = np.concatenate([rng.uniform(-1, 1, (289, 3)).astype(np.float32),
                          EDGE_PTS])
    trans = ladder(3)
    before = mv_taps.mv_tap_mean.launches
    got = port_tap_mean(maps, trans, pts, dtype, fn=mv_taps.mv_tap_mean)
    assert mv_taps.mv_tap_mean.launches == before
    plain = port_tap_mean(maps, trans, pts, dtype)
    np.testing.assert_array_equal(got, plain)
    assert_tap_close(got, jax_tap_mean(maps, trans, pts, dtype), dtype)
    # the edge cameras, whose last point is NaN
    trans = edge_cameras(3)
    assert_tap_close(port_tap_mean(maps, trans, pts, dtype,
                                   fn=mv_taps.mv_tap_mean),
                     jax_tap_mean(maps, trans, pts, dtype), dtype)


def test_plain_sums_in_view_order_and_divides():
    """The kernel's order: ((s0 + s1) + s2) / 3 in f32, bit for bit."""
    maps = torch.from_numpy(maps_of(3, 512, "float32", seed=9))
    trans = torch.from_numpy(ladder(3))
    pts = torch.from_numpy(np.random.RandomState(9).uniform(
        -1, 1, (200, 3)).astype(np.float32))
    px = mv_taps.camera.project_points(pts[None].expand(3, -1, -1), trans)
    s = mv_taps.image_ops.resampler(maps, px)
    want = ((s[0] + s[1]) + s[2]) / torch.tensor(3.0)
    assert torch.equal(mv_taps.mv_tap_mean_plain(maps, trans, pts), want)


@pytest.mark.parametrize("bad", ["dtype", "channels", "size", "trans",
                                 "trans_dtype", "pts", "pts_dtype",
                                 "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    maps = torch.zeros(2, 137, 137, 512)
    trans = torch.from_numpy(ladder(2))
    pts = torch.zeros(10, 3)
    if bad == "dtype":
        maps = maps.half()
    elif bad == "channels":
        maps = torch.zeros(2, 137, 137, 64)
    elif bad == "size":
        maps = torch.zeros(2, 136, 137, 512)
    elif bad == "trans":
        trans = trans[:1]
    elif bad == "trans_dtype":
        trans = trans.double()
    elif bad == "pts":
        pts = torch.zeros(10, 4)
    elif bad == "pts_dtype":
        pts = pts.double()
    else:
        pts = torch.zeros(10, 6)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        mv_taps.mv_tap_mean(maps, trans, pts)


def test_cpu_decode_steps_keep_the_per_view_rule():
    """On the CPU (the plain version's [V,P,512] taps) the step is today's:
    10,880 points at V = 24."""
    cfg = Config()
    state = (None, torch.zeros(24, 1, 1, 1), None, None)
    assert multiview.decode_step(state, cfg) == 10880


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mv_decode_takes_the_tap_mean_and_matches_jax(dtype, monkeypatch):
    """_mv_decode's folded arm at V = 5 on the JAX package's own state:
    one call of mv_taps.mv_tap_mean a decode (the state's maps, the step's
    points), and the values within tests/test_torch_multiview.py's bounds
    (f32: rtol 1e-4, atol 1e-4 of the scale; bf16: max 2% and mean 0.3% of
    the scale)."""
    kw = dict(num_classes=32, width_mult=0.125, compute_dtype=dtype,
              sdf_res=8, sampling="tf1")
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jp = jdisn.init(jcfg, jax.random.PRNGKey(4))
    p = convert.params_from_jax(jax.device_get(jp))
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (5, 137, 137, 3), dtype=np.uint8)
    trans = ladder(5)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    jstate = jmv._mv_prep(jp, jnp.asarray(imgs), jcfg)
    want = np.asarray(jmv._mv_decode(jp, jstate, jnp.asarray(trans),
                                     jnp.asarray(pts), jcfg), np.float32)
    cd = DTYPES[dtype][0]
    state = tuple(None if x is None else torch.from_numpy(
        np.array(x, np.float32)).to(DTYPES[str(x.dtype)][0]) for x in jstate)
    calls = []
    real = mv_taps.mv_tap_mean

    def spy(merged, trans_mats, pts_, **kw):
        calls.append((merged, pts_))
        return real(merged, trans_mats, pts_, **kw)

    monkeypatch.setattr(mv_taps, "mv_tap_mean", spy)
    got = multiview._mv_decode(p, state, torch.from_numpy(trans),
                               torch.from_numpy(pts), cfg)
    assert len(calls) == 1 and calls[0][0] is state[1]
    assert calls[0][1].shape == (400, 3)
    assert got.shape == (400,) and got.dtype == cd
    got = got.float().numpy()
    scale = max(1e-3, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    else:
        assert np.abs(got - want).max() <= 0.02 * scale
        assert np.abs(got - want).mean() <= 0.003 * scale


@pytest.mark.parametrize("rc", [5, 9, 17, 65])
def test_block_order_is_a_permutation_and_scatters_back(rc):
    """Every flat index once; a scatter through it writes back every value
    of a gather through it; the first (4 (rc // 4))^3 points come in runs
    of 64 that are each one 4^3 block; built once a resolution."""
    perm = grids.block_order(rc, "cpu")
    assert perm.dtype == torch.int64 and perm.shape == (rc ** 3,)
    assert torch.equal(torch.sort(perm).values, torch.arange(rc ** 3))
    vals = torch.from_numpy(np.random.RandomState(rc).randn(rc ** 3)
                            .astype(np.float32))
    back = torch.full_like(vals, float("nan"))
    back[perm] = vals[perm]
    assert torch.equal(back, vals)
    whole = 4 * (rc // 4)
    runs = perm[:whole ** 3].view(-1, 64)
    for axis in (runs % rc, runs // rc % rc, runs // (rc * rc)):
        assert (axis.amax(1) - axis.amin(1) == 3).all()
        assert (axis.amin(1) % 4 == 0).all()
    assert grids.block_order(rc, "cpu") is perm


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_phase_a_in_block_order_is_the_natural_order_and_matches_jax(
        dtype, monkeypatch):
    """The port's multi-view phase_a at sdf_res 64 (a 17^3 coarse grid)
    and V = 3 decodes in 4^3-block order: its coarse volume matches the
    natural order's and the JAX phase_a's within
    tests/test_torch_multiview.py's bounds (f32: rtol 1e-4, atol 1e-4 of
    the scale; bf16: max 2% and mean 0.3% of the scale), with the same
    active cells. Not bit for bit on the CPU: the BLAS takes the MLPs'
    rows in blocks whose edges move with the order, and a row at an edge
    rounds an ulp apart (1 of 4,913 f32 values here)."""
    kw = dict(num_classes=32, width_mult=0.125, compute_dtype=dtype,
              sdf_res=64, sampling="tf1")
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jp = jdisn.init(jcfg, jax.random.PRNGKey(6))
    p = convert.params_from_jax(jax.device_get(jp))
    imgs = np.random.RandomState(6).randint(0, 256, (3, 137, 137, 3),
                                            dtype=np.uint8)
    trans = ladder(3)
    box = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    im, tr, sp = multiview._inputs(imgs, trans, box, torch.device("cpu"))
    _, vol, ids, count = multiview.phase_a(p, im, tr, sp, cfg, 4)
    monkeypatch.setattr(grids, "block_order",
                        lambda rc, dev: torch.arange(rc ** 3, device=dev))
    _, vol_n, ids_n, count_n = multiview.phase_a(p, im, tr, sp, cfg, 4)
    assert vol.shape == (17, 17, 17)
    assert count == count_n and torch.equal(ids, ids_n)
    _, jvol, _, jcount = jmv._mv_parts(jcfg, 4, 32768, 0.25, 1.5)[1](
        jp, jnp.asarray(imgs), jnp.asarray(trans), jnp.asarray(box))
    assert count == int(jcount)
    for want in (vol_n.numpy(), np.asarray(jvol, np.float32)):
        got = vol.numpy()
        scale = max(1e-3, float(np.abs(want).max()))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * scale)
        else:
            assert np.abs(got - want).max() <= 0.02 * scale
            assert np.abs(got - want).mean() <= 0.003 * scale


@pytest.mark.parametrize("views", [1, 3])
def test_tile_plan_splits_staged_and_direct(views):
    """tests/mv_edge.plan_tiles at 32 px a stage: an interior cell, a cell
    on the image's last column and a NaN tile whose box covers pixel 0 are
    staged; the NaN point in an interior cell and random points go direct;
    a partial last tile is planned from its points alone. A stage of 3 px
    holds none of them; one of 137^2 px holds every one."""
    pts, want = plan_tiles()
    pts, trans = torch.from_numpy(pts), torch.from_numpy(edge_cameras(views))
    plan = mv_taps.tile_plan(trans, pts, stage_px=PLAN_STAGE_PX)
    assert plan.shape == (views, 6) and plan.dtype == torch.bool
    assert plan.tolist() == [want] * views
    assert not mv_taps.tile_plan(trans, pts, stage_px=3).any()
    assert mv_taps.tile_plan(trans, pts, stage_px=137 * 137).all()
    # smaller tiles: the interior cell's 16-point quarters stay staged
    quarters = mv_taps.tile_plan(trans, pts[:64], tile=16,
                                 stage_px=PLAN_STAGE_PX)
    assert quarters.shape == (views, 4) and quarters.all()
