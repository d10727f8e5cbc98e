"""Layouts that the K1 kernels read, checked on the CPU: the weight ring
tiles of tile_weights (bf16: tile order and the 128-byte swizzle; f32:
16 KB tiles of whole weight rows; both stated here again in numpy), the
small-parameter block of small_params, the cluster padding of pad_cells,
and that the wrapper lays them out once per pack_weights result."""
import numpy as np
import pytest
import torch

from disn_tpu_torch.models import sdfnet
from disn_tpu_torch.ops import fused_decode

SHAPES = [(64, 256), (256, 512), (512, 512), (512, 256)]  # w2, w3, wp, w4
ALL_SHAPES = [(3, 64), *SHAPES, (256, 2)]


def _pack(seed: int = 0, dtype=torch.bfloat16) -> tuple:
    """A pack_weights-shaped tuple of seeded weights in `dtype`, f32
    biases."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        for k, n in ALL_SHAPES:
            out.append(torch.from_numpy(rng.randn(k, n).astype(np.float32)
                                        ).to(dtype))
            out.append(torch.from_numpy(rng.randn(n).astype(np.float32)))
    return tuple(out)


def _with_out_dim(weights: tuple, out_dim: int) -> tuple:
    """weights with each stream's last layer cut to [256, out_dim]."""
    weights = list(weights)
    for s in range(2):
        weights[s * 12 + 10] = weights[s * 12 + 10][:, :out_dim].contiguous()
        weights[s * 12 + 11] = weights[s * 12 + 11][:out_dim].contiguous()
    return tuple(weights)


def _np_position(k_dim: int, n_dim: int) -> np.ndarray:
    """[K, N] position in the tiled buffer of W[k, n]: tiles of 64 rows x
    256 columns, all row blocks of the first 256 columns before those of
    the next; in a tile, 64-column blocks of 8-row groups of 8 rows of 128
    bytes, the 16-byte chunk c of row r stored at chunk c ^ r."""
    pos = np.empty((k_dim, n_dim), np.int64)
    for k in range(k_dim):
        for n in range(n_dim):
            tile = (n // 256) * (k_dim // 64) + k // 64
            r = k % 8
            chunk = (n % 64) // 8
            byte = ((n % 256) // 64 * 8192 + (k % 64) // 8 * 1024 + r * 128
                    + (chunk ^ r) * 16 + (n % 8) * 2)
            pos[k, n] = tile * 64 * 256 + byte // 2
    return pos


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tile_weights_layout(shape):
    weights = _pack()
    tiled = fused_decode.tile_weights(weights)
    assert tiled.dtype == torch.bfloat16
    assert tiled.numel() == 2 * sum(k * n for k, n in SHAPES)
    tile_u16 = tiled.view(torch.int16).numpy().view(np.uint16)
    pos = _np_position(*shape)
    # every (k, n) has its own place in the layer's span of the buffer
    assert np.array_equal(np.sort(pos.reshape(-1)),
                          np.arange(shape[0] * shape[1]))
    layer = SHAPES.index(shape)
    for s in range(2):
        offset = (s * sum(k * n for k, n in SHAPES)
                  + sum(k * n for k, n in SHAPES[:layer]))
        w = weights[s * 12 + 2 * (layer + 1)]
        w_u16 = w.view(torch.int16).numpy().view(np.uint16)
        # the tiled buffer at (k, n) holds W[k, n] ...
        np.testing.assert_array_equal(tile_u16[offset + pos], w_u16)
        # ... and untiling gives the weights back, in bf16 and raw
        back = tiled[torch.from_numpy(offset + pos)]
        assert torch.equal(back, w)
        assert np.array_equal(back.view(torch.int16).numpy(),
                              w.view(torch.int16).numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_f32_tile_weights_layout(shape):
    """The f32 stream: per stream w2, w3, wp, w4, each cut into tiles of
    F32_TILE_ELEMS elements, tile t of a [K, N] weight holding its rows
    t * TK .. (t + 1) * TK - 1 row-major, TK = F32_TILE_ELEMS / N; every
    weight is rebuilt from its tiles bit for bit."""
    weights = _pack(1, torch.float32)
    tiled = fused_decode.tile_weights(weights)
    te = fused_decode.F32_TILE_ELEMS
    assert tiled.dtype == torch.float32
    assert tiled.numel() == 2 * sum(k * n for k, n in SHAPES)
    assert tiled.numel() % te == 0
    tiles = tiled.numpy().reshape(-1, te)
    per_stream = sum(k * n for k, n in SHAPES) // te
    layer = SHAPES.index(shape)
    k_dim, n_dim = shape
    tk = te // n_dim
    for s in range(2):
        first = s * per_stream + sum(k * n for k, n in SHAPES[:layer]) // te
        rebuilt = np.concatenate(
            [tiles[first + t].reshape(tk, n_dim) for t in range(k_dim // tk)])
        w = weights[s * 12 + 2 * (layer + 1)].numpy()
        assert np.array_equal(rebuilt.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("out_dim", [1, 2])
def test_small_params_layout(out_dim):
    _check_small_params(_with_out_dim(_pack(), out_dim), out_dim)


@pytest.mark.parametrize("out_dim", [1, 2])
def test_f32_small_params_layout(out_dim):
    """The f32 kernel reads the same block, made from f32 weights."""
    _check_small_params(_with_out_dim(_pack(2, torch.float32), out_dim),
                        out_dim)


def _check_small_params(weights: tuple, out_dim: int) -> None:
    got = fused_decode.small_params(weights).numpy()
    assert got.dtype == np.float32 and got.shape == (2 * 2308,)
    for s in range(2):
        ws = weights[s * 12:(s + 1) * 12]
        p = got[s * 2308:(s + 1) * 2308]
        biases = np.concatenate([ws[i].numpy() for i in (1, 3, 5, 7, 9)])
        np.testing.assert_array_equal(p[:1600], biases)
        np.testing.assert_array_equal(p[1600:1600 + out_dim],
                                      ws[11].numpy())
        assert not p[1600 + out_dim:1604].any()
        np.testing.assert_array_equal(p[1604:1796],
                                      ws[0].float().numpy().reshape(-1))
        w5 = p[1796:].reshape(256, 2)
        np.testing.assert_array_equal(w5[:, :out_dim], ws[10].float().numpy())
        assert not w5[:, out_dim:].any()


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4095, 17887])
def test_pad_cells_to_whole_clusters(n):
    ids = torch.from_numpy(np.sort(np.random.RandomState(n).choice(
        64 ** 3, n, replace=False)).astype(np.int32))
    padded = fused_decode.pad_cells(ids, 4)
    assert padded.dtype == ids.dtype
    assert padded.shape[0] % 4 == 0 and padded.shape[0] - n < 4
    assert torch.equal(padded[:n], ids)  # the kept rows come first
    assert bool((padded[n:] == ids[-1]).all())  # padding repeats a valid id


def _params(seed: int = 0) -> tuple[dict, torch.Tensor]:
    gen = torch.Generator()
    gen.manual_seed(seed)
    cpu = torch.device("cpu")
    params = {"sdfprediction": sdfnet.init_global_head(gen, cpu, 1024),
              "sdfprediction_imgfeat": sdfnet.init_local_head(gen, cpu, 1472)}
    return params, torch.randn(1, 512, generator=gen)


def _reference_pack(params: dict, g: torch.Tensor, dtype) -> list:
    """pack_weights' 24 arrays, stated again layer by layer."""
    out = []
    for scope in ("sdfprediction", "sdfprediction_imgfeat"):
        p = params[scope]
        for fold, conv in (("fold1", "conv1"), ("fold1", "conv2"),
                           ("fold1", "conv3"), ("fold2", "conv1"),
                           ("fold2", "conv2"), ("fold2", "conv5")):
            w, b = p[fold][conv]["weights"], p[fold][conv]["biases"]
            if conv == "conv1" and fold == "fold2":
                w = w[:512]
                if scope == "sdfprediction":
                    b = b + g[0]
            out += [w.to(dtype), b.float()]
    return out


@pytest.mark.parametrize("change", ["none", "weight_in_place",
                                    "bias_in_place", "new_g_contrib",
                                    "dtype"])
def test_pack_weights_reused_while_unchanged(change):
    """pack_weights gives back its last tuple for the same unchanged
    tensors, and packs afresh after any change, with the right values."""
    params, g = _params()
    first = fused_decode.pack_weights(params, g, torch.bfloat16)
    dtype = torch.bfloat16
    if change == "weight_in_place":
        params["sdfprediction"]["fold1"]["conv2"]["weights"].mul_(2)
    elif change == "bias_in_place":
        params["sdfprediction_imgfeat"]["fold2"]["conv1"]["biases"].add_(1)
    elif change == "new_g_contrib":
        g = g + 1
    elif change == "dtype":
        dtype = torch.float32
    again = fused_decode.pack_weights(params, g, dtype)
    assert (again is first) == (change == "none")
    want = _reference_pack(params, g, dtype)
    assert len(again) == len(want) == 24
    for got, ref in zip(again, want):
        assert got.dtype == ref.dtype and got.is_contiguous()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("change", ["none", "weight_in_place", "new_pack"])
def test_kernel_weights_laid_out_once_per_packing(change):
    """The wrapper's tiles and small parameters are made once per packed
    tuple and made again when a packed array changes."""
    _check_laid_out_once(change, torch.bfloat16)


@pytest.mark.parametrize("change", ["none", "weight_in_place", "new_pack"])
def test_f32_kernel_weights_laid_out_once_per_packing(change):
    _check_laid_out_once(change, torch.float32)


def _check_laid_out_once(change: str, dtype) -> None:
    weights = _pack(3, dtype)
    tiles, small = fused_decode._kernel_weights(weights)
    if change == "weight_in_place":
        weights[4].mul_(2)
    elif change == "new_pack":
        weights = tuple(w.clone() for w in weights)
    tiles2, small2 = fused_decode._kernel_weights(weights)
    assert (tiles2 is tiles) == (change == "none")
    assert (small2 is small) == (change == "none")
    assert tiles2.dtype == dtype
    assert torch.equal(tiles2, fused_decode.tile_weights(weights))
    assert torch.equal(small2, fused_decode.small_params(weights))


@pytest.mark.parametrize("n", [1, 2, 3, 4095, 17887])
def test_f32_launch_layout_from_a_pack(n):
    """What the wrapper hands the f32 kernel for a pack_weights result: the
    f32 stream and small parameters of that pack, made once and reused for
    a second launch, and the cell ids padded to whole clusters of the
    kernel's size (2), the first n unchanged."""
    params, g = _params(n)
    weights = fused_decode.pack_weights(params, g, torch.float32)
    tiles, small = fused_decode._kernel_weights(weights)
    again = fused_decode.pack_weights(params, g, torch.float32)
    assert again is weights
    assert fused_decode._kernel_weights(again)[0] is tiles
    assert tiles.dtype == torch.float32 and small.dtype == torch.float32
    flat = torch.cat([weights[s * 12 + 2 * layer].reshape(-1)
                      for s in range(2) for layer in range(1, 5)])
    assert torch.equal(tiles, flat)
    ids = torch.arange(n, dtype=torch.int32)
    padded = fused_decode.pad_cells(ids, 2)
    assert padded.shape[0] == n + n % 2
    assert torch.equal(padded[:n], ids) and int(padded[-1]) == n - 1
