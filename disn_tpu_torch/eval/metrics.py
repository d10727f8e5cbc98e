"""Evaluation metrics: Chamfer, approximate EMD, F-score, voxel IoU (port of
disn_tpu/eval/metrics.py).

K6, the point-cloud metrics, run as hand-written CUDA kernels
(``csrc/metrics.cu``, built with nvcc at first use and loaded with ctypes;
its header note gives what bounds each, each design's floor and what the
design does about it):

* ``nn_distance`` (K6a): squared distance to the nearest point of the
  other cloud and its index, both ways, from one pass that computes d once
  a pair (partial minima merged as 64-bit (d, index) keys), with the
  reference op's gradient (a gather and an ``index_add_`` scatter in
  PyTorch ops on both devices);
* ``approx_match`` (K6b): the auction's soft matching [B, M, N], 10
  temperature levels -4^j for j = 7..-1 then 0, three phases a level;
* ``match_cost`` (K6c): sum of match x Euclidean distance [B], one
  streaming read of match with the per-batch total in the same call, with
  its gradient ``match_cost_grad`` (K6d) wrt both clouds, likewise one
  read of match for both, their totals in the same call.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``<wrapper>.launches`` (one a call: a call's kernels share one entry
point, which also does the call's memset); it uses the plain PyTorch
version beside it (``*_plain``, the JAX package's arithmetic: Gram
distances (|a|^2 - 2 a.b) + |b|^2 clamped at 0, einsums) only for CPU
tensors, and raises on any other device. On the card K6a and K6c compute
|p|^2 themselves, with the bits of ``_sq`` (``kernel_norms`` shows them to
a test); K6b takes ``_sq`` from its wrapper. The wrappers allocate their
outputs and scratch with one ``empty`` each and run no other PyTorch op on
the device. ``f_score``, ``chamfer_emd`` and ``iou_volumes`` are PyTorch
ops around them; the samplers are numpy on the host, drawing from
``RandomState`` exactly as the JAX package does.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from disn_tpu_torch import kernels

LEVELS = [-float(4.0 ** j) for j in range(7, -2, -1)] + [0.0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build())


def bind(path) -> ctypes.CDLL:
    """Load a build of csrc/metrics.cu and declare its entry points. A
    build of an older checkout lacks the newer ones (match_cost_grad_parts
    and the scratch argument of match_cost_grad_launch): only
    match_cost_grad_parts is checked for, and without it the caller
    declares match_cost_grad_launch itself."""
    lib = ctypes.CDLL(str(path))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    sigs = {
        "nn_distance_launch": [vp, ci, vp, ci, ci, vp, vp, vp, vp, vp, vp],
        "cloud_norms": [vp, ci, vp, vp],
        "approx_match_launch": [vp, vp, ci, vp, vp, ci, ci, cd, cd, vp, vp,
                                vp, vp, vp, vp],
        "approx_match_d_tile": [vp, vp, ci, vp, vp, ci, vp, vp],
        "match_cost_parts": [ci, ci],
        "match_cost_launch": [vp, ci, vp, ci, ci, vp, vp, vp, vp],
    }
    if hasattr(lib, "match_cost_grad_parts"):
        sigs["match_cost_grad_parts"] = [ci, ci]
        sigs["match_cost_grad_launch"] = [vp, ci, vp, ci, ci, vp, vp, vp, vp,
                                          vp, vp]
    for name, args in sigs.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ci
    return lib


def build():
    """Compile csrc/metrics.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("metrics")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device, without building
    a torch.cuda.Stream object (host time that a small call would show)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _device_of(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _clouds(xyz1: torch.Tensor, xyz2: torch.Tensor) -> tuple[int, int, int]:
    if (xyz1.dim() != 3 or xyz2.dim() != 3 or xyz1.shape[-1] != 3
            or xyz2.shape[-1] != 3 or xyz1.shape[0] != xyz2.shape[0]):
        raise ValueError(f"clouds must be [B,N,3] and [B,M,3], got "
                         f"{tuple(xyz1.shape)} and {tuple(xyz2.shape)}")
    b, n, m = xyz1.shape[0], xyz1.shape[1], xyz2.shape[1]
    if min(b, n, m) < 1:
        raise ValueError("empty cloud or batch")
    return b, n, m


def _sq(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis, as _pairwise_sqdist computes it."""
    return torch.sum(x * x, dim=-1).contiguous()


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[.., N, 3] x [.., M, 3] -> [.., N, M] squared distances (Gram)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    ab = torch.einsum("...nc,...mc->...nm", a, b)
    return torch.clamp_min(a2 - 2.0 * ab + b2.transpose(-1, -2), 0.0)


# -- K6a: nearest neighbours -------------------------------------------------

def nn_distance_plain(xyz1: torch.Tensor, xyz2: torch.Tensor):
    d = _pairwise_sqdist(xyz1, xyz2)
    return (d.min(-1).values, d.argmin(-1).int(), d.min(-2).values,
            d.argmin(-2).int())


def _nn_forward(xyz1: torch.Tensor, xyz2: torch.Tensor):
    if _device_of(xyz1, xyz2).type == "cpu":
        _clouds(xyz1, xyz2)
        return nn_distance_plain(xyz1, xyz2)
    out = _nn_run(_lib(), xyz1, xyz2)
    nn_distance.launches += 1
    return out


def _nn_run(lib: ctypes.CDLL, xyz1: torch.Tensor, xyz2: torch.Tensor):
    """One nn_distance_launch of `lib` on checked CUDA clouds: the keys'
    memset, the pass and the unpack, in one call."""
    b, n, m = _clouds(xyz1, xyz2)
    dev = xyz1.device
    keys = torch.empty((b * (n + m),), dtype=torch.int64, device=dev)
    dist1 = torch.empty((b, n), dtype=torch.float32, device=dev)
    dist2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    idx1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    idx2 = torch.empty((b, m), dtype=torch.int32, device=dev)
    _raise_on(lib.nn_distance_launch(
        xyz1.data_ptr(), n, xyz2.data_ptr(), m, b, keys.data_ptr(),
        dist1.data_ptr(), idx1.data_ptr(), dist2.data_ptr(), idx2.data_ptr(),
        _stream(xyz1)), "nn_distance")
    return dist1, idx1, dist2, idx2


def kernel_norms(xyz: torch.Tensor) -> torch.Tensor:
    """For tests: |p|^2 of each point of a CUDA cloud [.., 3] as K6a and K6c
    compute it (sq3), to hold against _sq's bits."""
    dev = _device_of(xyz)
    if dev.type != "cuda" or xyz.shape[-1] != 3:
        raise ValueError("want a CUDA cloud [.., 3]")
    out = torch.empty(xyz.shape[:-1], device=dev)
    _raise_on(_lib().cloud_norms(xyz.data_ptr(), out.numel(),
                                 out.data_ptr(), _stream(xyz)),
              "cloud_norms")
    return out


def nn_distance_backward(xyz1, xyz2, idx1, idx2, g1, g2):
    """The reference op's gradient (tf_nndistance_g.cu:132-160, the JAX
    package's _nn_bwd): d(dist1)/d(xyz1) = 2 (x1 - x2[idx1]), scattered
    back into the other cloud with the opposite sign; both directions.
    PyTorch ops on either device; on the card index_add_ sums with atomics,
    in no fixed order."""
    b, n, m = _clouds(xyz1, xyz2)
    g1 = torch.zeros((b, n), device=xyz1.device) if g1 is None else g1
    g2 = torch.zeros((b, m), device=xyz1.device) if g2 is None else g2
    i1, i2 = idx1.long(), idx2.long()
    n1 = torch.gather(xyz2, 1, i1[..., None].expand(-1, -1, 3))
    n2 = torch.gather(xyz1, 1, i2[..., None].expand(-1, -1, 3))
    grad1 = 2.0 * g1[..., None] * (xyz1 - n1)
    grad2 = 2.0 * g2[..., None] * (xyz2 - n2)
    rows = torch.arange(b, device=xyz1.device)[:, None]
    back1 = torch.zeros((b * n, 3), device=xyz1.device).index_add_(
        0, (rows * n + i2).reshape(-1),
        (2.0 * g2[..., None] * (n2 - xyz2)).reshape(-1, 3))
    back2 = torch.zeros((b * m, 3), device=xyz1.device).index_add_(
        0, (rows * m + i1).reshape(-1),
        (2.0 * g1[..., None] * (n1 - xyz1)).reshape(-1, 3))
    return grad1 + back1.reshape(b, n, 3), grad2 + back2.reshape(b, m, 3)


class _NNDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        out = _nn_forward(xyz1, xyz2)
        ctx.save_for_backward(xyz1, xyz2, out[1], out[3])
        ctx.mark_non_differentiable(out[1], out[3])
        return out

    @staticmethod
    def backward(ctx, g1, _gi1, g2, _gi2):
        return nn_distance_backward(*ctx.saved_tensors, g1, g2)


def _recording(*ts: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs: only then do the
    wrappers go through their autograd.Function (its host time is most of
    a small call's)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """Chamfer components (dist1 [B,N] f32, idx1 [B,N] i32, dist2 [B,M],
    idx2 [B,M]): squared distances to the nearest point of the other cloud
    and its index (the lowest on ties). xyz1 [B,N,3], xyz2 [B,M,3] f32."""
    if _recording(xyz1, xyz2):
        return _NNDistance.apply(xyz1, xyz2)
    return _nn_forward(xyz1, xyz2)


nn_distance.launches = 0


# -- K6b: the auction --------------------------------------------------------

def _masses(n: int, m: int) -> tuple[float, float]:
    """Starting masses remain_l, remain_r: integer ratios like the CUDA
    reference (max(1, m//n), max(1, n//m))."""
    return float(max(1, m // n)), float(max(1, n // m))


def approx_match_plain(xyz1: torch.Tensor, xyz2: torch.Tensor
                       ) -> torch.Tensor:
    """The auction in PyTorch ops, in the inputs' dtype throughout: float32
    is the kernel's plain version, float64 its referee."""
    _, n, m = _clouds(xyz1, xyz2)
    multi_l, multi_r = _masses(n, m)
    d = _pairwise_sqdist(xyz1, xyz2)  # [B,N,M]
    remain_l = torch.full(xyz1.shape[:-1], multi_l, dtype=xyz1.dtype,
                          device=xyz1.device)
    remain_r = torch.full(xyz2.shape[:-1], multi_r, dtype=xyz1.dtype,
                          device=xyz1.device)
    match = torch.zeros_like(d)
    for level in LEVELS:
        e = torch.exp(level * d)
        # phase 1: row ratios
        suml = 1e-9 + torch.einsum("bnm,bm->bn", e, remain_r)
        ratio_l = remain_l / suml
        # phase 2: column consumption
        sumr = torch.einsum("bnm,bn->bm", e, ratio_l) * remain_r
        consumption = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0)
        ratio_r = consumption * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        # phase 3: transported mass
        w = e * ratio_l[..., :, None] * ratio_r[..., None, :]
        match = match + w
        remain_l = torch.clamp_min(remain_l - w.sum(-1), 0.0)
    return match.transpose(-1, -2).contiguous()


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Auction-style soft matching [B,M,N] f32: match[l, k] is the mass
    moved from xyz1[k] to xyz2[l]. xyz1 [B,N,3] (the GT cloud in the
    protocol), xyz2 [B,M,3]."""
    dev = _device_of(xyz1, xyz2)
    _clouds(xyz1, xyz2)
    if dev.type == "cpu":
        return approx_match_plain(xyz1, xyz2)
    match = _approx_match_run(_lib(), xyz1, xyz2)
    approx_match.launches += 1
    return match


def _approx_match_run(lib: ctypes.CDLL, xyz1: torch.Tensor,
                      xyz2: torch.Tensor) -> torch.Tensor:
    """One approx_match_launch of `lib` (this checkout's library, or another
    build of the same entry point) on checked CUDA clouds; the auction's
    remainders and ratios are float64 scratch."""
    b, n, m = _clouds(xyz1, xyz2)
    dev = xyz1.device
    multi_l, multi_r = _masses(n, m)
    f64 = dict(dtype=torch.float64, device=dev)
    remain_l, remain_r = torch.empty((b, n), **f64), torch.empty((b, m), **f64)
    ratio_l = torch.empty((len(LEVELS), b, n), **f64)
    ratio_r = torch.empty((len(LEVELS), b, m), **f64)
    match = torch.empty((b, m, n), device=dev)
    sq1, sq2 = _sq(xyz1), _sq(xyz2)
    _raise_on(lib.approx_match_launch(
        xyz1.data_ptr(), sq1.data_ptr(), n, xyz2.data_ptr(), sq2.data_ptr(),
        m, b, multi_l, multi_r, remain_l.data_ptr(), remain_r.data_ptr(),
        ratio_l.data_ptr(), ratio_r.data_ptr(), match.data_ptr(),
        _stream(xyz1)), "approx_match")
    return match


def approx_match_d_tile(xyz1: torch.Tensor, xyz2: torch.Tensor
                        ) -> torch.Tensor:
    """For tests: [3, min(N, 128), min(M, 512)] f32 on the card, the squared
    distances of the first points of one cloud pair (xyz1 [N,3], xyz2
    [M,3]) as K6b's row pass and match (0) and its column pass (1) compute
    them, and as gram_d(dot3) of K6a and K6c (2)."""
    if xyz1.dim() != 2 or xyz2.dim() != 2:
        raise ValueError("want one cloud pair [N,3], [M,3]")
    dev = _device_of(xyz1, xyz2)
    if dev.type != "cuda":
        raise ValueError("the d tile is computed by the kernel on the card")
    n, m = xyz1.shape[0], xyz2.shape[0]
    out = torch.empty((3, min(n, 128), min(m, 512)), device=dev)
    sq1, sq2 = _sq(xyz1), _sq(xyz2)
    _raise_on(_lib().approx_match_d_tile(
        xyz1.data_ptr(), sq1.data_ptr(), n, xyz2.data_ptr(), sq2.data_ptr(),
        m, out.data_ptr(), _stream(xyz1)), "approx_match_d_tile")
    return out


approx_match.launches = 0


# -- K6c / K6d: transport cost and its gradient ------------------------------

def match_cost_plain(xyz1, xyz2, match) -> torch.Tensor:
    d = torch.sqrt(_pairwise_sqdist(xyz2, xyz1))  # [B,M,N]
    return torch.sum(match * d, dim=(-1, -2))


def match_cost_grad_plain(xyz1, xyz2, match, g):
    """Gradient wrt xyz1 and xyz2 (match held constant), from the direct
    difference x1 - x2 as the reference's MatchCostGrad computes it."""
    diff = xyz1[:, None, :, :] - xyz2[:, :, None, :]      # [B,M,N,3]
    dist = torch.sqrt(torch.sum(diff * diff, -1, keepdim=True))
    unit = diff / torch.clamp_min(dist, 1e-12)
    w = match[..., None] * unit
    g1 = g[:, None, None] * torch.sum(w, dim=1)             # [B,N,3]
    g2 = -g[:, None, None] * torch.sum(w, dim=2)            # [B,M,3]
    return g1, g2


def _check_match(xyz1, xyz2, match) -> tuple[torch.device, int, int, int]:
    dev = _device_of(xyz1, xyz2, match)
    b, n, m = _clouds(xyz1, xyz2)
    if tuple(match.shape) != (b, m, n):
        raise ValueError(f"match must be [{b},{m},{n}], got "
                         f"{tuple(match.shape)}")
    return dev, b, n, m


def _match_cost_forward(xyz1, xyz2, match) -> torch.Tensor:
    dev, _, _, _ = _check_match(xyz1, xyz2, match)
    if dev.type == "cpu":
        return match_cost_plain(xyz1, xyz2, match)
    cost = _match_cost_run(_lib(), xyz1, xyz2, match)
    match_cost.launches += 1
    return cost


def _match_cost_run(lib: ctypes.CDLL, xyz1, xyz2, match) -> torch.Tensor:
    """One match_cost_launch of `lib` on checked CUDA inputs: the pass and
    the per-batch total, the blocks' f64 shares in scratch."""
    b, n, m = _clouds(xyz1, xyz2)
    dev = xyz1.device
    part = torch.empty((b, lib.match_cost_parts(n, m)), dtype=torch.float64,
                       device=dev)
    cost = torch.empty((b,), device=dev)
    _raise_on(lib.match_cost_launch(
        xyz1.data_ptr(), n, xyz2.data_ptr(), m, b, match.data_ptr(),
        part.data_ptr(), cost.data_ptr(), _stream(xyz1)), "match_cost")
    return cost


def match_cost_grad(xyz1, xyz2, match, g):
    """(grad1 [B,N,3], grad2 [B,M,3]) of sum_b g[b] * match_cost[b]."""
    dev, b, n, m = _check_match(xyz1, xyz2, match)
    g = g.contiguous()
    if tuple(g.shape) != (b,) or g.device != dev or g.dtype != torch.float32:
        raise ValueError(f"g must be [{b}] float32 on {dev}")
    if dev.type == "cpu":
        return match_cost_grad_plain(xyz1, xyz2, match, g)
    grads = _match_cost_grad_run(_lib(), xyz1, xyz2, match, g)
    match_cost_grad.launches += 1
    return grads


def _match_cost_grad_run(lib: ctypes.CDLL, xyz1, xyz2, match, g):
    """One match_cost_grad_launch of `lib` on checked CUDA inputs: the pass
    and the totals, the blocks' f32 shares in scratch."""
    b, n, m = _clouds(xyz1, xyz2)
    dev = xyz1.device
    part = torch.empty((b, lib.match_cost_grad_parts(n, m)), device=dev)
    grad1 = torch.empty((b, n, 3), device=dev)
    grad2 = torch.empty((b, m, 3), device=dev)
    _raise_on(lib.match_cost_grad_launch(
        xyz1.data_ptr(), n, xyz2.data_ptr(), m, b, match.data_ptr(),
        g.data_ptr(), part.data_ptr(), grad1.data_ptr(), grad2.data_ptr(),
        _stream(xyz1)), "match_cost_grad")
    return grad1, grad2


match_cost_grad.launches = 0


class _MatchCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, match):
        ctx.save_for_backward(xyz1, xyz2, match)
        return _match_cost_forward(xyz1, xyz2, match)

    @staticmethod
    def backward(ctx, g):
        g1, g2 = match_cost_grad(*ctx.saved_tensors, g)
        return g1, g2, None


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor,
               match: torch.Tensor) -> torch.Tensor:
    """[B] transport cost sum(match[l,k] * |x1_k - x2_l|), Euclidean (not
    squared). The forward takes distances in the Gram form, the gradient
    (match held constant) the direct difference, as the reference does."""
    if _recording(xyz1, xyz2, match):
        return _MatchCost.apply(xyz1, xyz2, match)
    return _match_cost_forward(xyz1, xyz2, match)


match_cost.launches = 0


# -- protocol metrics --------------------------------------------------------

def chamfer_emd(pred: torch.Tensor, gt: torch.Tensor) -> dict:
    """The reference evaluation pair: cd = (mean d_fwd + mean d_bwd) x 1000
    on squared distances, emd = match_cost x 0.01. pred [B,N,3], gt
    [B,M,3]. The auction is asymmetric in its arguments and the reference
    feeds GT as xyz1."""
    d1, _, d2, _ = nn_distance(pred, gt)
    cd = (d1.mean(-1) + d2.mean(-1)) * 1000.0
    m = approx_match(gt, pred)
    emd = match_cost(gt, pred, m) * 0.01
    return {"cd": cd, "emd": emd}


def f_score(pred: torch.Tensor, gt: torch.Tensor, thresholds) -> dict:
    """Precision, recall and F1 [T,B] at Euclidean distance thresholds."""
    d1, _, d2, _ = nn_distance(pred, gt)
    d1, d2 = torch.sqrt(d1), torch.sqrt(d2)
    th = torch.as_tensor(np.asarray(thresholds, np.float32),
                         device=pred.device)[:, None, None]
    precision = (d1[None] < th).float().mean(-1)
    recall = (d2[None] < th).float().mean(-1)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-9)
    return {"precision": precision, "recall": recall, "f1": f1}


def iou_volumes(occ1, occ2) -> torch.Tensor:
    """|A and B| / |A or B| over boolean occupancy grids [..,D,D,D]."""
    a, b = torch.as_tensor(occ1).bool(), torch.as_tensor(occ2).bool()
    inter = (a & b).flatten(-3).sum(-1)
    union = (a | b).flatten(-3).sum(-1)
    return inter / torch.clamp_min(union, 1)


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        rng: np.random.RandomState | None = None
                        ) -> np.ndarray:
    """Area-weighted uniform surface sampling [n,3]."""
    from disn_tpu_torch.core.meshes import sample_surface
    return sample_surface(verts, faces, n, rng)


def sample_mesh_vertices(verts: np.ndarray, n: int,
                         rng: np.random.RandomState | None = None
                         ) -> np.ndarray:
    """The reference protocol: n vertices without replacement when the mesh
    has that many, with replacement otherwise."""
    rng = rng or np.random.RandomState(0)
    if len(verts) >= n:
        idx = rng.choice(len(verts), size=n, replace=False)
    else:
        idx = rng.randint(len(verts), size=n)
    return verts[idx].astype(np.float32)
