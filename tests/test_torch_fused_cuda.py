"""K1 on the card: the CUDA kernel against its plain PyTorch twin on the same
inputs. Needs an NVIDIA GPU and nvcc; skips without them. Imports nothing of
JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.models import sdfnet
from disn_tpu_torch.ops import fused_decode

FINE_R, COARSE_C = 49, 12
# ragged cell counts: a bf16 launch is padded to whole clusters; the last is
# the 257^3 main path's fine count (17,888 on the demo image) minus one
RAGGED = [(1, 49, 12), (3, 49, 12), (5, 49, 12), (17887, 257, 64)]
CAMERAS = {
    "w0_plane_in_box": np.vstack([np.eye(3) * 60, [68.0, 68.0, 2.0]]),
    "demo": None,
}


def _inputs(dtype, cam, n_cells=200, coarse_c=COARSE_C, binary=False):
    from disn_tpu_torch.data import synthetic

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = {"sdfprediction": sdfnet.init_global_head(gen, dev, 1024,
                                                       binary),
              "sdfprediction_imgfeat": sdfnet.init_local_head(gen, dev, 1472,
                                                              binary)}
    for scope in params.values():  # seeded non-zero biases
        for layer in scope.values():
            for p in layer.values():
                p["biases"] = 0.1 * torch.randn(p["biases"].shape,
                                                generator=gen, device=dev)
    g_contrib = torch.randn(1, 512, generator=gen, device=dev)
    fmap = (0.5 * torch.randn(137, 137, 512, generator=gen, device=dev)
            ).to(dtype)
    w = fused_decode.pack_weights(params, g_contrib.to(dtype), dtype)
    trans = synthetic.demo_trans_mat() if cam is None else cam
    cells = torch.randperm(coarse_c ** 3, generator=gen, device=dev
                           )[:n_cells].sort().values.int()
    geom = torch.tensor([-1, -1, -1, 1, 1, 1.0], device=dev)
    return (fmap, w, torch.tensor(np.ascontiguousarray(trans),
                                  dtype=torch.float32, device=dev),
            geom, cells)


def _hold(args, kw, dtype):
    before = fused_decode.fused_cell_decode.launches
    got = fused_decode.fused_cell_decode(*args, **kw)
    want = fused_decode.fused_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_decode.fused_cell_decode.launches == before + 1
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    err = (got - want).abs()
    if dtype == torch.float32:  # summation order only
        assert err.max().item() <= 1e-4 * scale
    else:  # tests/test_fused.py's bf16 bounds
        assert err.max().item() <= 0.02 * scale
        assert err.mean().item() <= 0.003 * scale
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cam", list(CAMERAS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_gpu(dtype, cam):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _hold(_inputs(dtype, CAMERAS[cam]),
          dict(fine_r=FINE_R, coarse_c=COARSE_C), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", RAGGED, ids=lambda r: f"n{r[0]}")
@pytest.mark.parametrize("cam", list(CAMERAS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_ragged_counts(dtype, cam, ragged):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    n, fine_r, coarse_c = ragged
    args = _inputs(dtype, CAMERAS[cam], n, coarse_c)
    out = _hold(args, dict(fine_r=fine_r, coarse_c=coarse_c), dtype)
    assert out.shape == (n * 64, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [(200, 49, 12), *RAGGED],
                         ids=lambda r: f"n{r[0]}")
@pytest.mark.parametrize("cam", list(CAMERAS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_binary_kernel_matches_plain(dtype, cam, ragged):
    """The binary head's two logits (out_dim 2: the epilogue writes both)
    against the plain version, at the ragged counts and a 49^3 grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    n, fine_r, coarse_c = ragged
    args = _inputs(dtype, CAMERAS[cam], n, coarse_c, binary=True)
    out = _hold(args, dict(fine_r=fine_r, coarse_c=coarse_c), dtype)
    assert out.shape == (n * 64, 2)
    assert not torch.equal(out[:, 0], out[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("fine_r", [49, 65, 97, 257])
def test_cell_points_divide_exactly_on_gpu(fine_r):
    """The plain version's grid points on the card are the IEEE quotients
    the kernel computes (not a multiply by the reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    c = (fine_r - 1) // fused_decode.STRIDE
    cells = torch.arange(c ** 3, dtype=torch.int32)
    geom = torch.tensor([-1, -1, -1, 1, 1, 1.0])
    want, _ = fused_decode.cell_points(cells, c, fine_r, geom)  # CPU
    got, _ = fused_decode.cell_points(cells.cuda(), c, fine_r, geom.cuda())
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_at_one_cluster_of_cells(dtype, offset):
    """One cluster of cells, and one cell fewer or more: the wrapper pads
    to whole clusters and keeps the first n*64 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    n = fused_decode._lib().fused_decode_cluster() + offset
    out = _hold(_inputs(dtype, None, n),
                dict(fine_r=FINE_R, coarse_c=COARSE_C), dtype)
    assert out.shape == (n * 64, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_in_a_tapped_texel_reaches_the_output(dtype):
    """A NaN in one channel of a texel the first point taps: the points
    that tap it give NaN in the kernel as in the plain version (the feature
    is NaN even where the tap weighs 0, and the ReLUs keep it), and every
    other point agrees within the usual bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from disn_tpu_torch.core import camera

    fmap, w, trans, geom, cells = _inputs(dtype, None)
    pts, _ = fused_decode.cell_points(cells, COARSE_C, FINE_R, geom)
    px = camera.project_points(pts[:1], trans, 137, 137)
    x0, y0 = (int(torch.floor(px[0, i])) for i in (0, 1))
    fmap = fmap.clone()
    fmap[y0, x0, 17] = float("nan")
    args = (fmap, w, trans, geom, cells)
    kw = dict(fine_r=FINE_R, coarse_c=COARSE_C)
    got = fused_decode.fused_cell_decode(*args, **kw)
    want = fused_decode.fused_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert bool(nan[0].all()) and not bool(nan.all())
    assert torch.equal(torch.isnan(got), nan)
    err = (got[~nan] - want[~nan]).abs()
    scale = want[~nan].abs().max().item()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert err.max().item() <= 0.02 * scale
        assert err.mean().item() <= 0.003 * scale
