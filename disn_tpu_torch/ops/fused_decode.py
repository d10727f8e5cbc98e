"""K1, the fused cell decode: wrapper, build and plain PyTorch twin.

Replaces the Pallas TPU kernel ``disn_tpu/ops/pallas_fused.py::
_fused_kernel``. For each stride-4 cell id it decodes the cell's 64 grid
points: project (divide by w, clamp), bilinearly sample the folded
[137,137,512] map, run both point MLPs, and return pred_g + pred_l raw as
f32 [n*64, out_dim]. The CUDA source is ``csrc/fused_decode.cu``; its
header note gives the bound (operations: ~2.16 MFLOP per point on the
tensor cores in bf16 or the FMA units in f32, against 19 or 38 MB of map)
and what each kernel's design does about it.

``fused_cell_decode`` launches the kernel for CUDA tensors and uses
``fused_decode_plain`` only for CPU tensors; there is no fallback from the
kernel to the plain version. ``fused_cell_decode.launches`` counts kernel
launches; when ``fused_cell_decode.events`` is a list, each launch appends
a (start, end) pair of CUDA events recorded around it, for timing, and when
``fused_cell_decode.inputs`` is a list, each launch appends its (args,
kwargs), so that a caller can hold a launch against the plain version.

Both kernels (bf16 on the tensor cores, f32 on the FMA units) stream the
GEMM weights of both streams from one buffer laid out by ``tile_weights``
(ring tiles in consumption order: bf16 already in the swizzled layout its
tensor-core instructions read, f32 the weights as they lie, concatenated)
and read the biases and the small first and last weights from
``small_params``; the wrapper builds both once per ``pack_weights`` result
(``pack_weights`` gives back the same tuple for the same unchanged
parameters, so the coarse and the fine launch of an image share them).
Both run in clusters of blocks that share each weight tile (the library's
``fused_decode_cluster()`` blocks): the wrapper pads the cell ids to a
multiple of that with ``pad_cells`` and keeps the first n*64 rows.

The kernel is built with nvcc into ``build/kernels/`` under the repository
root at first use (``build()``), named by a hash of its source, and loaded
with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import time
import weakref
from pathlib import Path

import torch

from disn_tpu_torch import kernels
from disn_tpu_torch.core import camera

STRIDE = 4
K = STRIDE ** 3  # points per cell
C_FEAT = 512
CHUNK_CELLS = 1024  # cells per step of the plain version (bounds memory)
# bf16 weight ring: a tile is 64 rows x 256 columns of one [K, N] weight
TILE_K, TILE_N = 64, 256
TILE_ELEMS = TILE_K * TILE_N
# f32 weight ring: a tile is 16 KB, F32_TILE_ELEMS / N whole rows of a
# [K, N] weight
F32_TILE_ELEMS = 4096
GEMM_SHAPES = ((64, 256), (256, 512), (512, 512), (512, 256))  # w2..w4



def cell_points(cell_ids: torch.Tensor, coarse_c: int, fine_r: int,
                sdf_params: torch.Tensor, stride: int = STRIDE
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[n] cell ids -> ([n*s^3, 3] f32 points, [n*s^3] flat fine-grid
    indices) for cells of stride s (the kernel's 4 by default), in the
    kernel's order: x fastest within a cell."""
    c = coarse_c
    dev = cell_ids.device
    k = stride ** 3
    # each id k times by an expand: repeat_interleave may size its output
    # on the host, which waits for the card
    cell = cell_ids.long()[:, None].expand(-1, k).reshape(-1)
    off = torch.arange(k, device=dev).repeat(cell_ids.shape[0])
    cz = cell // (c * c)
    cy = (cell // c) % c
    cx = cell % c
    f = torch.stack([cx * stride + off % stride,
                     cy * stride + (off // stride) % stride,
                     cz * stride + off // (stride * stride)], dim=-1)
    sp = sdf_params.float()
    lo, span = sp[0:3], sp[3:6] - sp[0:3]
    # an IEEE divide, as the kernel and the JAX reference do: on CUDA,
    # dividing by a Python float multiplies by its reciprocal instead,
    # which is off by an ulp where fine_r - 1 is not a power of two (a
    # filled device scalar: torch.tensor would copy from the host and wait)
    denom = torch.full((), float(fine_r - 1), dtype=torch.float32,
                       device=dev)
    pts = lo + f.float() / denom * span
    flat = (f[:, 2] * fine_r + f[:, 1]) * fine_r + f[:, 0]
    return pts, flat


class _LastCall:
    """One-entry memo of make(tensors, *extra): called again with the very
    same tensor objects, none changed in place since (their version
    counters), and the same extra arguments, it gives back the last value.
    It holds the tensors weakly, so that a freed tensor's id cannot stand
    for a new one. Inference-mode tensors keep no version: never memoised."""

    def __init__(self, make):
        self._make = make
        self._refs: tuple = ()
        self._key = None
        self._value = None

    def __call__(self, tensors: tuple, *extra):
        try:
            key = (extra, tuple((id(t), t._version) for t in tensors))
        except RuntimeError:
            return self._make(tensors, *extra)
        if key != self._key or any(r() is not t
                                   for r, t in zip(self._refs, tensors)):
            self._value = self._make(tensors, *extra)
            self._refs = tuple(weakref.ref(t) for t in tensors)
            self._key = key
        return self._value


def _pack(tensors: tuple, compute_dtype: torch.dtype) -> tuple:
    """pack_weights on its inputs flattened: per stream the six layers'
    (weights, biases), then g_contrib."""
    out = []
    for s in range(2):
        for layer in range(6):
            w, b = tensors[s * 12 + 2 * layer:s * 12 + 2 * layer + 2]
            b = b.float().reshape(-1)
            if layer == 3:  # fold2/conv1: the point part of W, + g_contrib
                w = w[:512]
                if s == 0:
                    b = b + tensors[24][0].float()
            out.append(w.to(compute_dtype).contiguous())
            out.append(b.contiguous())
    return tuple(out)


_pack_last = _LastCall(_pack)


def pack_weights(params: dict, g_contrib: torch.Tensor,
                 compute_dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """The two point-MLP param trees -> the kernel's 24 arrays: per stream
    (global, local) w1 b1 w2 b2 w3 b3 wp bp w4 b4 w5 b5. The per-image
    global contribution g_contrib [1,512] is folded into the global
    stream's fold2/conv1 bias. Weights in the compute type, biases f32.
    Packing the same unchanged tensors again gives back the same tuple, so
    that the bf16 wrapper lays out the weights once for both launches of
    an image; the arrays may be shared, so do not modify them in place."""
    srcs = []
    for scope in ("sdfprediction", "sdfprediction_imgfeat"):
        p = params[scope]
        last = "conv5_bi" if "conv5_bi" in p["fold2"] else "conv5"
        for fold, conv in (("fold1", "conv1"), ("fold1", "conv2"),
                           ("fold1", "conv3"), ("fold2", "conv1"),
                           ("fold2", "conv2"), ("fold2", last)):
            srcs += [p[fold][conv]["weights"], p[fold][conv]["biases"]]
    return _pack_last((*srcs, g_contrib), compute_dtype)


def tile_layout(k: int, n: int) -> torch.Tensor:
    """[k*n] int64: position in the tiled buffer of W[k, n] (flattened
    row-major) for a [k, n] weight, in the order the kernel consumes it:
    for each 256-column half h, for each 64-row block t, one tile. A tile
    is [4 column blocks][8 row groups][8 rows][64 columns], each 8x64
    block a 1 KB atom in the 128-byte swizzle: the 16-byte chunk c of row
    r sits at chunk c ^ r."""
    kk = torch.arange(k)[:, None]
    nn = torch.arange(n)[None, :]
    tile = (nn // TILE_N) * (k // TILE_K) + kk // TILE_K
    kg, r = (kk % TILE_K) // 8, kk % 8
    nb, chunk, e = (nn % TILE_N) // 64, (nn % 64) // 8, nn % 8
    pos = (tile * TILE_ELEMS + nb * (TILE_K * 64) + kg * 512 + r * 64
           + (chunk ^ r) * 8 + e)
    return pos.reshape(-1)


@functools.lru_cache(maxsize=None)
def _tile_index(device: torch.device) -> torch.Tensor:
    """Gather index from the 8 GEMM weights, flattened and concatenated in
    stream order, to tile_weights' layout (one per device)."""
    parts, offset = [], 0
    for _ in range(2):
        for k, n in GEMM_SHAPES:
            src = torch.empty(k * n, dtype=torch.int64)
            src[tile_layout(k, n)] = torch.arange(offset, offset + k * n)
            parts.append(src)
            offset += k * n
    return torch.cat(parts).to(device)


def tile_weights(weights: tuple) -> torch.Tensor:
    """pack_weights' output -> the kernel's weight stream: w2, w3, wp, w4 of
    the global stream then of the local one. bf16: each laid out by
    tile_layout, concatenated ([2 * 33 * TILE_ELEMS]), with one gather.
    f32: each as it lies (row-major [K, N]), concatenated, so that the
    kernel's tile t of a layer, F32_TILE_ELEMS contiguous elements, holds
    its rows t * TK .. (t + 1) * TK - 1 with TK = F32_TILE_ELEMS / N."""
    flat = torch.cat([weights[s * 12 + 2 * layer].reshape(-1)
                      for s in range(2) for layer in range(1, 5)])
    if flat.dtype == torch.float32:
        return flat
    return flat[_tile_index(flat.device)]


def small_params(weights: tuple) -> torch.Tensor:
    """pack_weights' output -> the kernel's small parameters, f32 [2 *
    2308] in either compute type: per stream (global, local) the biases
    b1..b6 (b6 padded to 4), w1 [3, 64] and w5 [256, out] padded to [256,
    2]."""
    parts = []
    for s in range(2):
        ws = weights[s * 12:(s + 1) * 12]
        w5 = ws[10].float()
        parts += [*(b.float() for b in ws[1:10:2]),
                  torch.nn.functional.pad(ws[11].float(), (0, 4 - w5.shape[1])),
                  ws[0].float().reshape(-1),
                  torch.nn.functional.pad(w5, (0, 2 - w5.shape[1])
                                          ).reshape(-1)]
    return torch.cat(parts)


# the kernel's weight stream and small parameters, once per packing
_kernel_weights = _LastCall(lambda w: (tile_weights(w), small_params(w)))


def pad_cells(cell_ids: torch.Tensor, multiple: int) -> torch.Tensor:
    """cell_ids padded to a multiple of `multiple` by repeating its last id,
    so that every block of a cluster decodes a valid cell; the rows of the
    padding follow the first len(cell_ids)*64 rows of the output."""
    extra = -cell_ids.shape[0] % multiple
    if extra == 0:
        return cell_ids
    return torch.cat([cell_ids, cell_ids[-1:].expand(extra)])


def _plain_chunk(fmap, weights, trans_mat, geom, cells, fine_r, coarse_c,
                 img_w, img_h):
    cd = fmap.dtype
    pts, _ = cell_points(cells, coarse_c, fine_r, geom)
    px = camera.project_points(pts, trans_mat, img_w, img_h)
    x, y = px[:, 0], px[:, 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    vx1 = x0f + 1 <= img_w - 1
    vy1 = y0f + 1 <= img_h - 1
    x0 = torch.nan_to_num(x0f).long()
    y0 = torch.nan_to_num(y0f).long()
    base = y0 * img_w + x0
    taps = [
        (base, (1 - wx) * (1 - wy)),
        (torch.where(vx1, base + 1, base),
         torch.where(vx1, wx * (1 - wy), 0.0)),
        (torch.where(vy1, base + img_w, base),
         torch.where(vy1, (1 - wx) * wy, 0.0)),
        (torch.where(vx1 & vy1, base + img_w + 1, base),
         torch.where(vx1 & vy1, wx * wy, 0.0)),
    ]
    flat = fmap.reshape(-1, C_FEAT)
    feat = torch.zeros(pts.shape[0], C_FEAT, device=fmap.device)
    for idx, wt in taps:
        feat += wt.to(cd).float()[:, None] * flat[idx].float()
    feat = feat.to(cd).float()

    def lin(h, w, b):  # compute-type operands, f32 accumulation
        return h.to(cd).float() @ w.float() + b

    def stream(ws, extra):
        w1, b1, w2, b2, w3, b3, wp, bp, w4, b4, w5, b5 = ws
        h = torch.relu(lin(pts, w1, b1)).to(cd)
        h = torch.relu(lin(h, w2, b2)).to(cd)
        h = torch.relu(lin(h, w3, b3)).to(cd)
        pre = lin(h, wp, bp)
        if extra is not None:
            pre = pre + extra
        h = torch.relu(pre).to(cd)
        h = torch.relu(lin(h, w4, b4)).to(cd)
        return lin(h, w5, b5)

    return stream(weights[:12], None) + stream(weights[12:], feat)


def fused_decode_plain(fmap: torch.Tensor, weights: tuple, trans_mat:
                       torch.Tensor, geom: torch.Tensor,
                       cell_ids: torch.Tensor, *, fine_r: int, coarse_c: int,
                       img_w: int = 137, img_h: int = 137) -> torch.Tensor:
    """K1 in plain PyTorch, with the kernel's rounding: [n*64, out] f32."""
    outs = [_plain_chunk(fmap, weights, trans_mat, geom,
                         cell_ids[i:i + CHUNK_CELLS], fine_r, coarse_c,
                         img_w, img_h)
            for i in range(0, cell_ids.shape[0], CHUNK_CELLS)]
    if not outs:
        return torch.zeros(0, weights[10].shape[1], device=fmap.device)
    return torch.cat(outs)


def build() -> Path:
    """Compile csrc/fused_decode.cu (once per source hash) and return the
    shared library's path. The compiler's register/shared-memory report is
    kept beside it as ``<lib>.log``."""
    return _build(())


def _build(defines: tuple[str, ...]) -> Path:
    """build() with preprocessor defines, e.g. ("K1_TRACE",)."""
    return kernels.nvcc_build("fused_decode", defines)


def bind(path) -> ctypes.CDLL:
    """Load a build of csrc/fused_decode.cu and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_decode_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci,
                                        ci, ci, ci, ci, vp, vp]
    lib.fused_decode_launch.restype = ci
    lib.fused_decode_cluster.argtypes = []
    lib.fused_decode_cluster.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def _lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    return bind(_build(defines))


def build_seconds() -> float:
    """Build (or find) the kernel and load it; returns the seconds taken."""
    t0 = time.perf_counter()
    _lib()
    return time.perf_counter() - t0


def _check(fmap, weights, trans_mat, geom, cell_ids, fine_r, coarse_c,
           img_w, img_h):
    dev = fmap.device
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"map must be float32 or bfloat16, got {fmap.dtype}")
    if tuple(fmap.shape) != (img_h, img_w, C_FEAT):
        raise ValueError(f"map must be [{img_h},{img_w},{C_FEAT}], got "
                         f"{tuple(fmap.shape)}")
    if len(weights) != 24:
        raise ValueError(f"expected 24 weight arrays, got {len(weights)}")
    out_dim = weights[10].shape[-1]
    if out_dim not in (1, 2):
        raise ValueError(f"out_dim must be 1 or 2, got {out_dim}")
    shapes = [(3, 64), (64, 256), (256, 512), (512, 512), (512, 256),
              (256, out_dim)]
    for s in range(2):
        for layer, (kin, n) in enumerate(shapes):
            w = weights[s * 12 + 2 * layer]
            b = weights[s * 12 + 2 * layer + 1]
            if tuple(w.shape) != (kin, n) or w.dtype != fmap.dtype:
                raise ValueError(f"weight {s * 12 + 2 * layer}: want "
                                 f"{(kin, n)} {fmap.dtype}, got "
                                 f"{tuple(w.shape)} {w.dtype}")
            if tuple(b.shape) != (n,) or b.dtype != torch.float32:
                raise ValueError(f"bias {s * 12 + 2 * layer + 1}: want "
                                 f"({n},) float32, got {tuple(b.shape)} "
                                 f"{b.dtype}")
    if tuple(trans_mat.shape) != (4, 3) or trans_mat.dtype != torch.float32:
        raise ValueError("trans_mat must be [4,3] float32")
    if tuple(geom.shape) != (6,) or geom.dtype != torch.float32:
        raise ValueError("geom must be [6] float32")
    if cell_ids.dim() != 1 or cell_ids.dtype != torch.int32:
        raise ValueError("cell_ids must be a 1-D int32 tensor")
    if fine_r - 1 != STRIDE * coarse_c:
        raise ValueError(f"fine_r - 1 ({fine_r - 1}) must be {STRIDE} x "
                         f"coarse_c ({coarse_c})")
    for t in (fmap, *weights, trans_mat, geom, cell_ids):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    # the kernel reads the map in 16-byte vectors
    if dev.type == "cuda" and fmap.data_ptr() % 16:
        raise ValueError("the map must be 16-byte aligned")
    return out_dim


def fused_cell_decode(fmap: torch.Tensor, weights: tuple,
                      trans_mat: torch.Tensor, geom: torch.Tensor,
                      cell_ids: torch.Tensor, *, fine_r: int, coarse_c: int,
                      img_w: int = 137, img_h: int = 137) -> torch.Tensor:
    """Decode every stride^3 point of `cell_ids` -> raw [n*64, out] f32.

    fmap [137,137,512] f32|bf16 (the fold137 map without its batch axis);
    weights: pack_weights(...); trans_mat [4,3] f32; geom [6] f32 bbox;
    cell_ids [n] int32, each < coarse_c**3. CUDA tensors launch the kernel
    on the current stream; CPU tensors take fused_decode_plain."""
    out_dim = _check(fmap, weights, trans_mat, geom, cell_ids, fine_r,
                     coarse_c, img_w, img_h)
    if fmap.device.type == "cpu":
        return fused_decode_plain(fmap, weights, trans_mat, geom, cell_ids,
                                  fine_r=fine_r, coarse_c=coarse_c,
                                  img_w=img_w, img_h=img_h)
    if fmap.device.type != "cuda":
        raise ValueError(f"unsupported device {fmap.device}")
    n = cell_ids.shape[0]
    if n == 0:
        return torch.empty((0, out_dim), dtype=torch.float32,
                           device=fmap.device)
    if fused_cell_decode.inputs is not None:
        fused_cell_decode.inputs.append(
            ((fmap, weights, trans_mat, geom, cell_ids),
             dict(fine_r=fine_r, coarse_c=coarse_c, img_w=img_w,
                  img_h=img_h)))
    cur = torch.cuda.current_stream(fmap.device)
    timed = fused_cell_decode.events is not None
    if timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(cur)
    out = _launch(_lib(), fmap, weights, trans_mat, geom, cell_ids,
                  fine_r, coarse_c, img_w, img_h)
    if timed:
        end.record(cur)
        fused_cell_decode.events.append((start, end))
    fused_cell_decode.launches += 1
    return out


def _launch(lib: ctypes.CDLL, fmap, weights, trans_mat, geom, cell_ids,
            fine_r, coarse_c, img_w, img_h) -> torch.Tensor:
    """One launch of `lib`'s kernel on checked, non-empty CUDA inputs, on
    the current stream: [n*64, out_dim] f32."""
    tiles, params = _kernel_weights(weights)
    cells = pad_cells(cell_ids, lib.fused_decode_cluster())
    out_dim = weights[10].shape[-1]
    out = torch.empty((cells.shape[0] * K, out_dim), dtype=torch.float32,
                      device=fmap.device)
    err = lib.fused_decode_launch(
        int(fmap.dtype == torch.bfloat16), fmap.data_ptr(), tiles.data_ptr(),
        params.data_ptr(), trans_mat.data_ptr(), geom.data_ptr(),
        cells.data_ptr(), cells.shape[0], fine_r, coarse_c, img_w, img_h,
        out_dim, out.data_ptr(),
        torch.cuda.current_stream(fmap.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_decode kernel launch failed: CUDA error "
                           f"{err}")
    return out[:cell_ids.shape[0] * K]


fused_cell_decode.launches = 0
fused_cell_decode.events = None
fused_cell_decode.inputs = None
