"""Image -> mesh reconstruction (port of the synchronous core of
disn_tpu/infer/pipeline.py) and the reconstruction farm over a split.

One call: encode + fold the image, decode the SDF (two-level sparse when
the grid allows, else the exact dense path) and extract the welded mesh,
returned as numpy (verts, faces). On the sparse path with
cfg.sparse_words (the default) the fine pass's rows become record words
(K5) and the host assembles the mesh from them, with no [R^3] volume; in
the volume flow the fine pass ends in the extractor's candidate scan and
the owned-edge extractor builds the welded mesh on the device, so one copy
brings it to the host; the dense paths scan the whole volume for that
extractor. image_to_mesh is _fused_dispatch (all device work and copies)
followed by _fused_collect (the host half, a closure that touches no
device). On both sparse flows the dispatch is speculative, as the JAX
package's: once a first image of a (cfg, iso) has seeded _SPEC_CACHE
with the buckets it needed (the words flow's block and record buckets;
the volume flow's block and slot buckets, vertex and face counts and
whether the boundary planes were due), later images queue their whole
chain at the predicted buckets without waiting for the card, and
_fused_collect reads one flags vector and re-runs only a stage whose
bucket fell short. The volume flow extracts with the owned-edge route
where the JAX package speculates through its dense record stage. The
rest of the JAX package's remote-link machinery (optimistic background
assembly, chunked fetch streams, its block assembler) is not ported.

``reconstruct_split`` runs every (category, object, view) of a split into
the reference's output tree as the JAX package's farm does: a reader
thread prefetches the records, the calling thread owns all device work
and dispatches image k before it hands image k - depth's host half and
OBJ write to a bounded writer pool.

Multi-view fusion: ``multiview_to_mesh`` fuses V views of one object into
one volume (infer/multiview: the sparse flow, the dense stream on a cap
overflow) and extracts its mesh with volume_to_mesh;
``reconstruct_multiview`` does so for every object of a split
(`create-sdf --multi-view`).

The estimated-camera path: ``reconstruct_image`` is image_to_mesh with the
camera net's camera when the image has none (the `demo` subcommand), and
``estimate_cameras`` replaces a stream of view records' cameras by the
net's, a batch of views a forward (`train-cam --mode create`, whose tree
``reconstruct_split(cam_est=True)`` reads).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from threading import Event, Thread
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import codecs
from disn_tpu_torch.infer import dense as dense_mod
from disn_tpu_torch.infer import multiview
from disn_tpu_torch.infer import sparse as sparse_mod
from disn_tpu_torch.models import disn, posenet
from disn_tpu_torch.ops import marching
from disn_tpu_torch.postprocessing import clean_small_parts

Params = dict[str, Any]

UNIT_BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
WRITERS = 4    # reconstruct_split's OBJ writer threads (at most spare cores)
PREFETCH = 4   # records its reader thread reads ahead
# (cfg, iso) whose sparse-words guard tripped: they take the volume flow
# directly, instead of a guard trip and a second fine pass every image
_SWORDS_SKIP: set = set()


def _sparse_eligible(cfg: Config) -> bool:
    """Grids that the stride-4 cells divide take the sparse flow: regress
    heads through the band cull, binary heads through the sign cull only
    with cfg.binary_sparse (a heuristic; by default binary stays on the
    exact dense path, as in the reference). THREEDCNN decodes its fixed
    volume."""
    return (cfg.variant is not Variant.THREEDCNN
            and cfg.sparse_stride == sparse_mod.STRIDE
            and cfg.sdf_res % sparse_mod.STRIDE == 0
            and (not cfg.binary or cfg.binary_sparse))


def predict_volume(params: Params, img, trans_mat, sdf_params, cfg: Config,
                   device: str | torch.device | None = None,
                   stats: dict | None = None,
                   sparse: bool = True) -> torch.Tensor:
    """Image -> [R,R,R] f32 SDF volume (z,y,x) on `device`: the sparse flow
    when `sparse` and _sparse_eligible, else the exact dense path.
    THREEDCNN: one forward to its fixed 65^3 volume, scaled as the point
    heads are (R is 65 whatever cfg.sdf_res; sdf_params and trans_mat are
    not read)."""
    if cfg.variant is Variant.THREEDCNN:
        return threedcnn_volume(params, img, cfg, device=device)
    if sparse and _sparse_eligible(cfg):
        return sparse_mod.sparse_dense_sdf(params, img, trans_mat,
                                           sdf_params, cfg, device=device,
                                           stats=stats)
    return dense_mod.dense_sdf(params, img, trans_mat, sdf_params, cfg,
                               device=device)


def threedcnn_volume(params: Params, img, cfg: Config,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """The THREEDCNN variant's [65,65,65] f32 volume (z,y,x) of one image
    on `device`: disn.apply's forward, then dense.scale_pred."""
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    img_t = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                            else img).to(dev)
    if img_t.dim() == 3:
        img_t = img_t[None]
    with torch.no_grad():
        pred = disn.apply(params, {"img": img_t,
                                   "sample_pc": torch.zeros(1, 1, 3,
                                                            device=dev),
                                   "trans_mat": torch.zeros(1, 4, 3,
                                                            device=dev)},
                          cfg)["pred_sdf"]
        vals = dense_mod.scale_pred(pred, cfg)[0].float()
    r = round(vals.shape[0] ** (1 / 3))
    return vals.reshape(r, r, r)


def volume_to_mesh(vol: torch.Tensor, sdf_params, iso: float = 0.0,
                   clean: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """[R,R,R] volume -> welded numpy (verts, faces) by the owned-edge
    extractor on the volume's device (full-volume scan, then one copy), as
    the JAX package's volume_to_mesh runs its device extractor. That one
    retries at cfg.max_triangles when its group cap overflows; the port's
    extractor has no group cap, so there is nothing to retry. clean=True
    drops small and off-centre components."""
    verts, faces = marching.extract_mesh_owned(vol, sdf_params, iso=iso,
                                               device=vol.device)
    if clean and len(faces):
        verts, faces = clean_small_parts(verts, faces)
    return verts, faces


# The speculative bucket dispatch (port of disn_tpu/infer/pipeline.py
# :87-170 for the sparse-words flow). Per (cfg, iso) the buckets the last
# images needed: (n_blocks, n_iter, nv, low_streak, nvc). The fine pass's
# block bucket and the record pass's batch count depend on the image, but
# a bucket that is too large is always sound (the padding is masked
# against the counts on the card), so with a prediction the whole chain
# is queued without waiting for a count, and _fused_collect reads the
# counts once and re-runs only a stage whose bucket fell short.
# Predictions ratchet up at once (a short bucket costs a re-run) and
# decay only after _SHRINK_STREAK smaller images in a row (a long one
# costs padded work). nvc, the JAX package's per-chunk vertex counts for
# its chunked record streams, stays None: the port has one record stream.
_SPEC_CACHE: dict = {}
_SHRINK_STREAK = 12
SPEC_BLOCK = 32768  # points of a fine-pass block on the JAX fast path
SPEC_BATCH = 4096   # record slots a batch on the JAX fast path
_NVCAP_MARGIN = 1.25  # headroom on a predicted vertex or face count
# how each speculative image ended, by kind (see _fused_collect)
spec_counts: Counter = Counter()


def _merge_nvc(nvc_p, nvc):
    """Elementwise-ratcheted per-chunk vertex counts; the chunking (n_iter,
    batch, bounds) must match, else the newest stands."""
    if nvc_p is None or nvc is None or nvc_p[:3] != nvc[:3]:
        return nvc
    return (*nvc[:3], tuple(max(a, b) for a, b in zip(nvc_p[3], nvc[3])))


def _ratchet(new, old):
    """The larger of two counts; None (not known) when either is."""
    return new if (old is None or new is None) else max(new, old)


def _update_pred(key, nb: int, ni: int, nv: int | None, nvc=None) -> None:
    """Fold this image's exact-needed buckets into the prediction for
    `key`: upward at once, downward after _SHRINK_STREAK smaller images."""
    _fold_pred(key, (nb, ni, nv, nvc), ())


def _update_vpred(key, nb: int, ni: int, nv: int, ntri: int,
                  planes: bool) -> None:
    """_update_pred for the volume flow's entries, (nb, ni, nv, streak,
    None, ntri, planes): the face count ratchets as the vertex count
    does; whether the boundary planes were due follows the last image."""
    _fold_pred(key, (nb, ni, nv, None), (ntri, planes))


def _fold_pred(key, new: tuple, tail: tuple) -> None:
    """The ratchet of _update_pred on `new` = (nb, ni, nv, nvc) and an
    entry's extra fields `tail` (a count that ratchets, then a flag)."""
    nb, ni, nv, nvc = new
    prev = _SPEC_CACHE.get(key)
    if prev is None:
        _SPEC_CACHE[key] = (nb, ni, nv, 0, nvc, *tail)
        return
    nb_p, ni_p, nv_p, streak, nvc_p = prev[:5]
    nb_n, ni_n = max(nb, nb_p), max(ni, ni_p)
    nv_n = _ratchet(nv, nv_p)
    nvc_n = _merge_nvc(nvc_p, nvc)
    tail_n = (_ratchet(tail[0], prev[5]), tail[1]) if tail else ()
    if (nb_n, ni_n, nv_n, nvc_n, *tail_n) != (nb, ni, nv, nvc, *tail):
        if streak + 1 >= _SHRINK_STREAK:
            _SPEC_CACHE[key] = (nb, ni, nv, 0, nvc, *tail)
            return
        _SPEC_CACHE[key] = (nb_n, ni_n, nv_n, streak + 1, nvc_n, *tail_n)
        return
    _SPEC_CACHE[key] = (nb, ni, nv, 0, nvc, *tail)


def _spec_sizes(cfg: Config) -> dict:
    """The fine pass's cells a block, at most max_blocks of them, and the
    cell cap: disn_tpu/infer/sparse.py _sparse_parts at SPEC_BLOCK points
    a block, with the port's cap (sparse.cell_cap, the dense fallback's
    threshold on every route; the same at the default Config and wherever
    cfg.cell_cap_frac of the coarse cells is at most 1,024 or a multiple
    of 1,024) and as many blocks as cover it."""
    cap0 = max(256, int((cfg.sdf_res // sparse_mod.STRIDE) ** 3
                        * cfg.cell_cap_frac))
    k = sparse_mod.STRIDE ** 3
    cpb = max(k, min(SPEC_BLOCK, cap0 * k) // k * k) // k
    cap = sparse_mod.cell_cap(cfg)
    return dict(cells_per_block=cpb, max_blocks=-(-cap // cpb),
                cell_cap=cap)


def _fused_bcap(n_blocks: int, sizes: dict) -> int:
    """The compaction's candidate-block cap at a block bucket: the bucket's
    cells plus a margin for the blocks beside them."""
    n_kcells = n_blocks * sizes["cells_per_block"]
    return -(-(n_kcells + max(1024, n_kcells // 16)) // 256) * 256


def _exact_blocks(c: int, sizes: dict) -> int:
    return min(sizes["max_blocks"], max(1, -(-c // sizes["cells_per_block"])))


def _needed_blocks(c: int, sizes: dict) -> int:
    """The block bucket for c active cells (eighth-power-of-two steps)."""
    return min(sizes["max_blocks"], marching._ebucket(_exact_blocks(c,
                                                                    sizes)))


def _ids_len(n_blocks: int, sizes: dict) -> int:
    """Slots of the capped compaction's id buffer at a block bucket."""
    return marching._b2cap(_fused_bcap(n_blocks, sizes)) * marching.LANES


def _host_box(sdf_params) -> np.ndarray:
    """A copy of sdf_params as the host's f32 box (from a card tensor, a
    copy that waits for the card)."""
    if torch.is_tensor(sdf_params):
        sdf_params = sdf_params.detach().cpu()
    return np.array(sdf_params, np.float32).reshape(-1)


def _extraction(vol, scan, sdf_params, iso: float, dev: torch.device,
                stats: dict | None) -> dict:
    """The volume flow's and the dense paths' extraction on `vol`: route
    tets without a scan, else owned_ids, or owned_scan when the scan's
    guard fired. Returns _fused_collect's context."""
    t0 = None
    if stats is not None:  # extraction_ms: from here to the closure's end
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
    if scan is None:
        route = "tets"
        fin = marching.extract_mesh_owned_deferred(vol, sdf_params, iso=iso,
                                                   device=vol.device)
    else:
        ids, n_cells, guard, blk = scan
        if guard == 0:
            route = "owned_ids"
            fin = marching.extract_mesh_from_ids_deferred(
                vol, sdf_params, ids, iso=iso, device=dev, stats=stats,
                blk=blk)
        else:
            route = "owned_scan"
            fin = marching.extract_mesh_owned_deferred(
                vol, sdf_params, iso=iso, device=dev, stats=stats)
    if stats is not None:
        stats["route"] = route
        if scan is not None:
            stats.update(fine_cells=n_cells, guard=guard)
    return {"fin": fin, "stats": stats, "t0": t0}


def _records_ctx(ctx: dict, words, sids, n: int, blk) -> dict:
    """The record route over the sparse words (route records_sparse) on
    the first n slots of `sids`."""
    stats, dev = ctx["stats"], ctx["dev"]
    t0 = None
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stats.update(route="records_sparse", fine_cells=n, guard=0)
    fin = marching.extract_mesh_records_deferred_sparse(
        words, ctx["cfg"].grid_resolution, ctx["box"], sids[:n], n, blk,
        join=ctx["join"], stats=stats)
    return {"fin": fin, "stats": stats, "t0": t0}


def _volume_ctx(ctx: dict, count: int) -> dict:
    """The words flow's guard tripped: pin (cfg, iso) to the volume flow
    (_SWORDS_SKIP) and run this image through its synchronous form from
    the same phase_a outputs (_volume_exact)."""
    _SWORDS_SKIP.add((ctx["cfg"], ctx["iso"]))
    return _volume_exact(ctx, count)


def _vkey(cfg: Config, iso: float) -> tuple:
    """The volume flow's key in _SPEC_CACHE: apart from the words flow's
    (cfg, iso), whose entries have other fields."""
    return (cfg, float(iso), "volume")


def _volume_exact(ctx: dict, count: int) -> dict:
    """The volume flow synchronously on exactly the `count` active cells
    (the flow before the speculation): phase_b_mesh, the candidate scan,
    then the owned-edge extraction (route owned_ids, or owned_scan when
    the scan's guard fired), which seeds the volume flow's prediction for
    (cfg, iso) (_volume_tail)."""
    embedding, endpoints, vol_c, cell_ids, _ = ctx["pa"]
    cells = cell_ids[:count]
    vol, *scan = sparse_mod.phase_b_mesh(
        ctx["params"], endpoints, vol_c, cells, ctx["trans"], ctx["sdfp"],
        ctx["cfg"], ctx["iso"], ctx["stats"], embedding=embedding)
    planes = int(sparse_mod.boundary_cells(cells, vol_c.shape[0] - 1)) > 0
    return _volume_tail(ctx, vol, _needed_blocks(count, ctx["sizes"]),
                        planes, count, tuple(scan))


def _volume_tail(ctx: dict, vol, nb: int, planes: bool, count: int,
                 scan: tuple | None) -> dict:
    """The volume flow's extraction on `vol` (the exact candidate scan
    over the `count` active cells first when `scan` is None), then the
    volume flow's prediction for (cfg, iso) updated from its counts: the
    block bucket nb, the slots the scan's cells need, the vertex and face
    counts, and whether the planes were due."""
    stats, sizes = ctx["stats"], ctx["sizes"]
    if scan is None:
        with device_mod.stage(stats, "scan_ms", ctx["dev"]):
            scan = marching._active_cells_from_coarse(
                vol, ctx["pa"][3][:count], ctx["iso"],
                stride=sparse_mod.STRIDE)
    out = _extraction(vol, scan, ctx["sdf_params"], ctx["iso"], ctx["dev"],
                      stats)
    # the owned routes' closures hold the fetched mesh: no device work
    verts, faces = out["fin"]()
    _update_vpred(_vkey(ctx["cfg"], ctx["iso"]), nb,
                  marching.records_n_iter(_ids_len(nb, sizes), scan[1],
                                          SPEC_BATCH)[0],
                  len(verts), len(faces), planes)
    return out


def _dense_fallback(ctx: dict) -> dict:
    """More active cells than the cap: the exact dense volume from the same
    phase_a outputs, through the owned-edge extractor (route tets)."""
    stats, dev = ctx["stats"], ctx["dev"]
    embedding, endpoints = ctx["pa"][:2]
    with device_mod.stage(stats, "dense_fallback_ms", dev):
        vol = dense_mod.dense_volume(
            ctx["params"], endpoints, embedding, ctx["trans"], ctx["sdfp"],
            ctx["cfg"], sparse_mod._folds(ctx["cfg"])[0])
    return _extraction(vol, None, ctx["sdf_params"], ctx["iso"], dev, stats)


def _words_exact(ctx: dict, count: int, seed: bool) -> dict:
    """The words flow synchronously on exactly the `count` active cells
    (the flow before the speculation): K1, K5, the uncapped compaction,
    then the record route, or the volume flow when the guard trips. With
    `seed`, the prediction for (cfg, iso) is seeded from the counts."""
    stats, cfg, sizes = ctx["stats"], ctx["cfg"], ctx["sizes"]
    _, endpoints, vol_c, cell_ids, _ = ctx["pa"]
    words, sids, n, guard, blk = sparse_mod.phase_b_mesh_sparse(
        ctx["params"], endpoints, vol_c, cell_ids[:count], ctx["trans"],
        ctx["sdfp"], cfg, ctx["iso"], stats)
    if stats is not None:
        stats["swords_guard"] = guard
    if seed:
        nb = _needed_blocks(count, sizes)
        _update_pred(ctx["key"], nb, marching.records_n_iter(
            _ids_len(nb, sizes), n, SPEC_BATCH)[0], None)
    if guard:
        return _volume_ctx(ctx, count)
    return _records_ctx(ctx, words, sids, n, blk)


def _words_dispatch(params: Params, img, trans_mat, sdf_params, cfg: Config,
                    iso: float, dev: torch.device, stats: dict | None,
                    join: bool) -> dict:
    """The sparse-words flow's device half: phase_a with the fixed-size
    cull; then, with a prediction for (cfg, iso), the whole chain at its
    buckets with no host synchronisation (K1 over the predicted block
    bucket, K5 with the count on the card, the capped compaction, the
    record pass at the predicted batch count, and non-blocking copies of
    the records, the block rows and the flags into page-locked buffers,
    then one event); without one, the synchronous flow (_words_exact),
    which seeds the prediction."""
    key = (cfg, float(iso))
    sizes = _spec_sizes(cfg)
    params = device_mod.tree_to(params, dev)
    img_t, trans, sdfp = dense_mod.as_inputs(img, trans_mat, sdf_params, dev)
    pa = sparse_mod.phase_a(
        params, img_t, trans, sdfp, cfg, stats,
        max_cells=sizes["max_blocks"] * sizes["cells_per_block"])
    ctx = dict(params=params, trans=trans, sdfp=sdfp, sdf_params=sdf_params,
               box=_host_box(sdf_params), cfg=cfg, iso=float(iso), key=key,
               sizes=sizes, pa=pa, stats=stats, join=join, dev=dev)
    pred = _SPEC_CACHE.get(key)
    if pred is None:
        count = int(pa[4])
        if stats is not None:
            stats.update(active_cells=count, spec="seed",
                         dense_fallback=count > sizes["cell_cap"])
        spec_counts["seed"] += 1
        if count > sizes["cell_cap"]:
            return _dense_fallback(ctx)
        return _words_exact(ctx, count, seed=True)
    nb_p, ni_p = min(pred[0], sizes["max_blocks"]), pred[1]
    _, endpoints, vol_c, cell_ids, count = pa
    # the chain's stage times go to stats only if its result is used
    spec_stats = None if stats is None else {}
    words, sids, n, gov, blk, guard = sparse_mod.phase_b_mesh_sparse(
        params, endpoints, vol_c, cell_ids, trans, sdfp, cfg, float(iso),
        spec_stats, count=count, n_kcells=nb_p * sizes["cells_per_block"],
        bcap=_fused_bcap(nb_p, sizes))
    ni, batch = marching.records_n_iter(sids.shape[0], ni_p * SPEC_BATCH,
                                        SPEC_BATCH)
    t0 = None
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
    with device_mod.stage(spec_stats, "extract_ms", dev):
        imask, tq, flags = marching.records_masked_sparse(
            words, sids, n, cfg.grid_resolution, ni, batch,
            scalars=(count, 0, 0, n, gov))
    with device_mod.stage(spec_stats, "fetch_ms", dev):
        host, done = marching._to_host((imask, tq, blk, flags), join=False)
    ctx.update(pred=(nb_p, ni, batch), chain=(words, sids, n, blk, guard),
               host=host, done=done, t0=t0, spec_stats=spec_stats)
    return ctx


def _nvcap_of(n: int | None, most: int) -> int:
    """Rows of a predicted vertex or face count to copy back (the JAX
    package's _nvcap_of: the count with _NVCAP_MARGIN of headroom,
    quarter-power-of-two bucketed), at most `most`; all of them when the
    count is not known."""
    if n is None:
        return most
    return min(most, marching._qbucket(max(4, int(n * _NVCAP_MARGIN))))


def _volume_dispatch(params: Params, img, trans_mat, sdf_params,
                     cfg: Config, iso: float, dev: torch.device,
                     stats: dict | None) -> dict:
    """The volume flow's device half: phase_a with the fixed-size cull;
    then, with a prediction for (cfg, iso), the whole chain at its buckets
    with no host synchronisation (phase_b_mesh's fixed form at the
    predicted block bucket and plane bit: K1 over the bucket, the planes
    if predicted, the candidate scan with the capped compaction; the
    owned-edge extractor's fixed form over the predicted slots; then
    non-blocking copies of the flags and of the first predicted rows of
    the vertices and the faces into page-locked buffers, and one event);
    without one, the synchronous flow (_volume_exact), which seeds the
    prediction."""
    key = _vkey(cfg, iso)
    sizes = _spec_sizes(cfg)
    params = device_mod.tree_to(params, dev)
    img_t, trans, sdfp = dense_mod.as_inputs(img, trans_mat, sdf_params, dev)
    pa = sparse_mod.phase_a(
        params, img_t, trans, sdfp, cfg, stats,
        max_cells=sizes["max_blocks"] * sizes["cells_per_block"])
    ctx = dict(params=params, trans=trans, sdfp=sdfp, sdf_params=sdf_params,
               cfg=cfg, iso=float(iso), key=key, sizes=sizes, pa=pa,
               stats=stats, dev=dev, flow="volume")
    pred = _SPEC_CACHE.get(key)
    if pred is None:
        count = int(pa[4])
        if stats is not None:
            stats.update(active_cells=count, spec="seed",
                         dense_fallback=count > sizes["cell_cap"])
        spec_counts["seed"] += 1
        if count > sizes["cell_cap"]:
            return _dense_fallback(ctx)
        return _volume_exact(ctx, count)
    nb_p, ni_p, nv_p, _, _, ntri_p, planes_p = pred
    nb_p = min(nb_p, sizes["max_blocks"])
    embedding, endpoints, vol_c, cell_ids, count = pa
    # the chain's stage times go to stats only if its result is used
    spec_stats = None if stats is None else {}
    vol, ids, n, guard, gov, blk, n_bd = sparse_mod.phase_b_mesh(
        params, endpoints, vol_c, cell_ids, trans, sdfp, cfg, float(iso),
        spec_stats, embedding=embedding, count=count,
        n_kcells=nb_p * sizes["cells_per_block"],
        bcap=_fused_bcap(nb_p, sizes), planes=planes_p)
    ni, batch = marching.records_n_iter(ids.shape[0], ni_p * SPEC_BATCH,
                                        SPEC_BATCH)
    t0 = None
    if stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
    with device_mod.stage(spec_stats, "extract_ms", dev):
        verts, nv, faces, ntri, missing = marching._extract_owned_fixed(
            vol, sdfp, ids, n, float(iso), ni, batch, blk=blk)
        flags = torch.stack([x.reshape(()).int() for x in (
            count, n, guard, gov, n_bd, nv, ntri, missing)])
    caps = (_nvcap_of(nv_p, verts.shape[0]), _nvcap_of(ntri_p,
                                                        faces.shape[0]))
    with device_mod.stage(spec_stats, "fetch_ms", dev):
        host, done = marching._to_host(
            (flags, verts[:caps[0]], faces[:caps[1]]), join=False)
    ctx.update(pred=(nb_p, ni, batch, planes_p, *caps),
               chain=(vol, ids, blk),
               host=host, done=done, t0=t0, spec_stats=spec_stats)
    return ctx


def _fused_dispatch(params: Params, img, trans_mat, sdf_params,
                    cfg: Config, iso: float, sparse: bool = True,
                    device: str | torch.device | None = None,
                    stats: dict | None = None, join: bool = True) -> dict:
    """The device half of image_to_mesh (port of the JAX package's
    _fused_dispatch): encode, prep, phase_a, phase_b, the scan and the
    extraction's device work and copies, all on the calling thread, with
    image_to_mesh's route choice and _SWORDS_SKIP rule. Returns the
    context _fused_collect finishes.

    On either sparse flow with a prediction in _SPEC_CACHE for (cfg,
    iso), nothing here waits for the card (uploads through page-locked
    buffers, the fixed-shape chain, copies into page-locked buffers and
    one event; _words_dispatch, _volume_dispatch), so a farm can dispatch
    image k+1 while image k's work is still queued. With `stats` the
    stages are synchronised as they are timed. Every other route (no
    prediction yet, the dense paths) runs synchronously here, and the
    context holds the extraction's closure (host work only: it holds no
    CUDA tensor and issues no device operation). join=False makes the
    record route's final copy non-blocking there too (see
    marching.extract_mesh_records_deferred)."""
    dev = device_mod.resolve(device)
    if sparse and _sparse_eligible(cfg):
        if (cfg.sparse_words and (cfg, float(iso)) not in _SWORDS_SKIP
                and sparse_mod.words_eligible(cfg)):
            return _words_dispatch(params, img, trans_mat, sdf_params, cfg,
                                   iso, dev, stats, join)
        return _volume_dispatch(params, img, trans_mat, sdf_params, cfg, iso,
                                dev, stats)
    vol = predict_volume(params, img, trans_mat, sdf_params, cfg,
                         device=dev, sparse=False)
    return _extraction(vol, None, sdf_params, iso, dev, stats)


def _spec_resolve(ctx: dict) -> dict | None:
    """Validate a speculative chain (port of the JAX _fused_collect's
    checks): wait once for its copies, read the flags [count, esc_a, esc_b,
    nc, gov, nv] (the escapes always 0: the port's K1 has none), update the
    prediction, and end in one of these kinds:

    - ``hit``: the block bucket covered the active cells, the records
      covered nc and gov is 0: the closure assembles from the copied
      buffers;
    - ``records``: the record bucket fell short: the record pass again at
      the exact count from the chain's words;
    - ``blocks``: the block bucket fell short: phase_b, K5 and the
      compaction again at the needed bucket from phase_a's outputs (still
      on the card), the prediction re-seeded from that run, then the
      record pass at the exact count;
    - ``guard``: the words flow's guard tripped: _volume_ctx;
    - ``overflow``: gov came from the capped compaction alone (guard 0):
      the words flow again on exactly the active cells (_words_exact);
    - ``cap``: more active cells than the cap: returns None (the caller
      takes _dense_fallback).

    Each kind gives the synchronous flow's mesh bit for bit; it is counted
    in spec_counts and given as stats["spec"]. Runs on the calling thread;
    every re-run is on the card."""
    if ctx.get("flow") == "volume":
        return _vspec_resolve(ctx)
    stats, sizes, key = ctx["stats"], ctx["sizes"], ctx["key"]
    if ctx["done"] is not None:
        ctx["done"].synchronize()
    imask, tq, rows, flags = ctx["host"]
    c, _, _, nc, gov, nv = (int(x) for x in flags)
    nb_p, ni, batch = ctx["pred"]
    words, sids, _, blk, guard = ctx["chain"]

    if stats is not None:
        stats.update(active_cells=c, dense_fallback=c > sizes["cell_cap"])
    if c > sizes["cell_cap"]:
        _ends(stats, "cap")
        return None
    covered = ni * batch >= nc
    _update_pred(key, _needed_blocks(c, sizes), marching.records_n_iter(
        sids.shape[0], nc, SPEC_BATCH)[0], nv if covered else None)
    if nb_p >= _exact_blocks(c, sizes):
        if stats is not None:
            stats.update(ctx["spec_stats"], swords_guard=int(guard))
        if gov <= 0 and covered:
            _ends(stats, "hit", () if nc else ("extract_ms", "fetch_ms"))
            if stats is not None:
                stats.update(route="records_sparse", fine_cells=nc, guard=0)
            fin = marching._empty_mesh if nc == 0 else functools.partial(
                marching.assemble_blocks, imask, tq, rows, nc,
                ctx["cfg"].grid_resolution, ctx["box"], stats)
            return {"fin": fin, "stats": stats, "t0": ctx["t0"]}
        if gov <= 0:
            _ends(stats, "records", ("extract_ms", "fetch_ms"))
            return _records_ctx(ctx, words, sids, nc, blk)
    else:
        nb = _needed_blocks(c, sizes)
        _, endpoints, vol_c, cell_ids, count = ctx["pa"]
        words, sids, n_d, gov_d, blk, guard = sparse_mod.phase_b_mesh_sparse(
            ctx["params"], endpoints, vol_c, cell_ids, ctx["trans"],
            ctx["sdfp"], ctx["cfg"], ctx["iso"], stats, count=count,
            n_kcells=nb * sizes["cells_per_block"],
            bcap=_fused_bcap(nb, sizes))
        nc, gov = int(n_d), int(gov_d)
        _update_pred(key, nb, marching.records_n_iter(
            sids.shape[0], nc, SPEC_BATCH)[0], None)
        if stats is not None:
            stats["swords_guard"] = int(guard)
        if gov <= 0:
            _ends(stats, "blocks")
            return _records_ctx(ctx, words, sids, nc, blk)
    if int(guard) == 0:
        _ends(stats, "overflow", ("phase_b_ms", "scan_ms", "extract_ms",
                                  "fetch_ms"))
        return _words_exact(ctx, c, seed=False)
    _ends(stats, "guard", ("extract_ms", "fetch_ms"))
    return _volume_ctx(ctx, c)


def _ends(stats: dict | None, kind: str, drop: tuple = ()) -> None:
    """Count how a speculative chain ended, and drop from `stats` the
    chain's times of the stages that run again."""
    spec_counts[kind] += 1
    if stats is not None:
        stats["spec"] = kind
        for k in drop:
            stats.pop(k, None)


def _vspec_resolve(ctx: dict) -> dict | None:
    """_spec_resolve's volume arm (port of the JAX _fused_collect with
    swords=False, through the owned-edge extractor): wait once for the
    chain's copies, read the flags [count, n, guard, gov, n_boundary, nv,
    ntri, missing] and end in one of these kinds:

    - ``hit``: the block bucket covered the active cells, the plane bit
      was right, gov is 0, the slots covered n and the copied rows nv and
      ntri: the closure slices the copied buffers;
    - ``blocks`` / ``planes``: the block bucket fell short / the plane bit
      was wrong: phase_b_mesh's fixed form again from phase_a's outputs at
      the needed bucket with the right bit, then its extraction (the exact
      scan first if its gov is not 0);
    - ``guard``: the scan's guard fired: the exact scan of the chain's
      volume, whose guard sends the extraction through the full-volume
      scan (route owned_scan);
    - ``overflow``: gov came from the capped compaction alone: the exact
      scan of the chain's volume, then the extraction;
    - ``extract``: the slots or a copy's rows fell short: the exact
      owned-edge extractor on the chain's volume and ids;
    - ``cap``: more active cells than the cap: returns None (the caller
      takes _dense_fallback).

    Each kind gives the synchronous flow's mesh bit for bit; it is counted
    in spec_counts and given as stats["spec"]. The prediction is updated
    from the run whose mesh is returned. Runs on the calling thread; every
    re-run is on the card."""
    stats, sizes, key = ctx["stats"], ctx["sizes"], ctx["key"]
    if ctx["done"] is not None:
        ctx["done"].synchronize()
    flags, verts, faces = ctx["host"]
    c, n, guard, gov, n_bd, nv, ntri, missing = (int(x) for x in flags)
    nb_p, ni, batch, planes_p, vcap, tcap = ctx["pred"]
    vol, ids, blk = ctx["chain"]
    planes = n_bd > 0
    if stats is not None:
        stats.update(active_cells=c, dense_fallback=c > sizes["cell_cap"])
    if c > sizes["cell_cap"]:
        _ends(stats, "cap")
        return None
    nb = _needed_blocks(c, sizes)
    if nb_p < _exact_blocks(c, sizes) or planes != planes_p:
        _ends(stats, "blocks" if nb_p < _exact_blocks(c, sizes)
              else "planes")
        embedding, endpoints, vol_c, cell_ids, count = ctx["pa"]
        vol, ids, n_d, _, gov_d, blk, _ = sparse_mod.phase_b_mesh(
            ctx["params"], endpoints, vol_c, cell_ids, ctx["trans"],
            ctx["sdfp"], ctx["cfg"], ctx["iso"], stats, embedding=embedding,
            count=count, n_kcells=nb * sizes["cells_per_block"],
            bcap=_fused_bcap(nb, sizes), planes=planes)
        n, gov = int(n_d), int(gov_d)
        return _volume_tail(ctx, vol, nb, planes, c,
                            None if gov > 0 else (ids[:n], n, 0, blk))
    if stats is not None:
        stats.update(ctx["spec_stats"])
    if gov > 0:
        _ends(stats, "guard" if guard > 0 else "overflow",
              ("scan_ms", "extract_ms", "fetch_ms"))
        return _volume_tail(ctx, vol, nb, planes, c, None)
    if ni * batch < n or nv > vcap or ntri > tcap:
        _ends(stats, "extract", ("extract_ms", "fetch_ms"))
        return _volume_tail(ctx, vol, nb, planes, c, (ids[:n], n, 0, blk))
    if missing:
        raise ValueError("a triangle's edge belongs to a cell that is not "
                         "in the active-cell list")
    _ends(stats, "hit")
    _update_vpred(key, nb, marching.records_n_iter(ids.shape[0], n,
                                                   SPEC_BATCH)[0],
                  nv, ntri, planes)
    if stats is not None:
        stats.update(route="owned_ids", fine_cells=n, guard=0)
    return {"fin": lambda: (verts[:nv].copy(), faces[:ntri].copy()),
            "stats": stats, "t0": ctx["t0"]}


def _fused_collect(ctx: dict, defer: bool = False, clean: bool = False):
    """The host half of image_to_mesh (port of the JAX package's
    _fused_collect): after _spec_resolve on a speculative chain (the one
    wait, any re-run), the extraction's closure, then clean_small_parts
    when `clean`. defer=True returns it as a zero-argument closure for a
    writer pool (it touches no device); otherwise runs it and returns
    (verts, faces). A speculative context is left holding that host half
    alone (no CUDA tensor). Returns None when the active cells overflowed
    the cap on a speculative chain: the caller then takes
    _dense_fallback(ctx)."""
    if "fin" not in ctx:
        host = _spec_resolve(ctx)
        if host is None:
            return None
        # the context keeps the host half only: its device tensors go
        ctx.clear()
        ctx.update(host)
    fin, stats, t0 = ctx["fin"], ctx["stats"], ctx["t0"]

    def assemble() -> tuple[np.ndarray, np.ndarray]:
        verts, faces = fin()
        if stats is not None:
            stats["extraction_ms"] = stats.get("extraction_ms", 0.0) + (
                time.perf_counter() - t0) * 1e3
        if clean and len(faces):
            verts, faces = clean_small_parts(verts, faces)
        return verts, faces

    return assemble if defer else assemble()


def _collect_or_dense(ctx: dict, defer: bool = False, clean: bool = False):
    """_fused_collect, and on a cap overflow the dense route from the same
    phase_a outputs."""
    out = _fused_collect(ctx, defer=defer, clean=clean)
    if out is None:
        out = _fused_collect(_dense_fallback(ctx), defer=defer, clean=clean)
    return out


def image_to_mesh(params: Params, img, trans_mat, cfg: Config,
                  sdf_params=None, iso: float | None = None,
                  sparse: bool = True, clean: bool = False,
                  device: str | torch.device | None = None,
                  stats: dict | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Single image ([H,W,3] float in [0,1], or uint8 normalised on the
    device) -> (vertices [V,3] f32, faces [F,3] i32).

    sdf_params defaults to the unit box [-1,1]^3. With cfg.sparse_words on
    a grid that words_eligible allows, the sparse path takes the
    sparse-words flow: the fine rows go to K5 and the record route
    assembles the mesh on the host (route ``records_sparse``; vertices
    quantised to the cell over 510, or 131070 on grids under 129). The
    first image of a (cfg, iso) runs it synchronously and seeds
    _SPEC_CACHE; later ones run it speculatively at the predicted buckets
    (_fused_dispatch), re-running a stage whose bucket fell short; every
    way gives the same mesh, bit for bit, and clearing _SPEC_CACHE gives
    the synchronous flow. When its guard trips (active cells on the +
    boundary, a band violation) the image goes through the volume flow
    from the same coarse pass, and (cfg, iso) keeps to the volume flow
    from then on, as the JAX package's _SWORDS_SKIP does. The volume flow
    scans the fine cells inside the active coarse cells and extracts the
    welded mesh on the device (route ``owned_ids``); if the scan's guard
    finds a sign change outside those cells, the whole volume is scanned
    instead (``owned_scan``); it speculates as the words flow does, its
    prediction apart (_vkey). When the active cells overflow the cap, the
    config is not eligible for the sparse path (_sparse_eligible: binary
    heads without cfg.binary_sparse, THREEDCNN, other grids), or
    ``sparse`` is false, the dense volume (predict_volume; THREEDCNN's
    fixed 65^3 one) goes through volume_to_mesh (``tets``). Every variant
    and both sampling modes decode through infer/fused.kernel_enabled's
    choice: the kernel for twostream + tf1 on its grids, the plain decode
    otherwise.

    `stats`, when given, receives per-stage wall times in ms (each stage
    synchronised: encode, prep, phase_a, phase_b and scan or
    dense_fallback, then extraction, which covers everything after the
    volume and the scan, with its parts extract on the device and fetch to
    the host on the owned and records_sparse routes, and assemble on the
    host on records_sparse), ``active_cells``, ``route`` with, on the
    sparse path, ``fine_cells``, ``guard`` and ``spec`` (``seed``,
    ``hit``, or the re-run that _spec_resolve took: on the words flow
    ``records``, ``blocks``, ``guard``, ``overflow``, ``cap``; on the
    volume flow ``blocks``, ``planes``, ``guard``, ``overflow``,
    ``extract``, ``cap``), and on the sparse-words flow
    ``swords_guard``. The stage times are those of the run whose result
    is returned.

    The call is _fused_dispatch (the device half, with every copy) and
    _fused_collect (the host half); reconstruct_split runs the two apart."""
    if sdf_params is None:
        sdf_params = UNIT_BOX
    iso = cfg.iso if iso is None else iso
    ctx = _fused_dispatch(params, img, trans_mat, sdf_params, cfg, iso,
                          sparse=sparse, device=device, stats=stats)
    return _collect_or_dense(ctx, clean=clean)


def image_to_mesh_sharded(params: Params, img, trans_mat, cfg: Config, mesh,
                          sdf_params=None, iso: float | None = None,
                          device: str | torch.device | None = None,
                          stats: dict | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """image_to_mesh over the ranks of a points-only parallel.Mesh (port of
    the JAX package's image_to_mesh_sharded), the same (verts, faces) on
    every rank: the sparse pass striped over the ranks
    (sparse.sparse_volume_sharded: each rank's stripe of the active cells
    through the fused kernel), the striped dense pass on a cap overflow,
    the scan of the whole volume, the record pass striped over the ranks
    (marching.sharded_records) and the record route's host assembly
    (native.mesh_assemble) on the mesh's first rank, whose arrays the
    others receive. Faces equal image_to_mesh's; vertices are the record
    route's (quantised to the cell over 510 on grids of 129 and up, over
    131070 below).

    The striped record pass takes the JAX package's n_iter, per-rank and
    batch rules for its id buffer (the scan's group cap x 64 ids), and its
    two single-rank fallbacks: grids whose buffer holds fewer batches than
    ranks, and cell counts the rounded stripes would not cover (the JAX
    rule drops those slots otherwise). The JAX function also falls back to
    the owned extractor when its scan's group cap overflows; the port's
    scan (marching._active_cells_ext) has no group cap, so that case does
    not arise. `stats`, when given, receives sparse_volume_sharded's, and
    ``dense_fallback``."""
    from disn_tpu_torch import native, parallel

    dev = device_mod.resolve(device)
    if sdf_params is None:
        sdf_params = UNIT_BOX
    iso = cfg.iso if iso is None else iso
    vol, count, esc, cap = sparse_mod.sparse_volume_sharded(
        params, img, trans_mat, sdf_params, cfg, mesh, device=dev,
        stats=stats)
    if stats is not None:
        stats["dense_fallback"] = count > cap or esc > 0
    if count > cap or esc > 0:
        vol = dense_mod.dense_sdf(params, img, trans_mat, sdf_params, cfg,
                                  device=dev, mesh=mesh)
    R = cfg.grid_resolution
    ids, nc = marching._active_cells_ext(vol, float(iso))
    n_dev = mesh.shape[parallel.POINT_AXIS]
    ids_len = marching._norm_gcap(R) * marching.BLOCK ** 3
    batch = marching._fit_batch(ids_len, 8192)
    per_dev = min(marching._qbucket(max(1, -(-nc // (batch * n_dev)))),
                  ids_len // batch // n_dev)
    n_iter = n_dev * per_dev
    verts = faces = None
    if nc and (ids_len // batch < n_dev or n_iter * batch < nc):
        if mesh.lead:
            verts, faces = marching.extract_mesh_records(
                vol, sdf_params, ids, nc, iso=iso, device=dev)
    elif nc:
        rec, tq, _ = marching.sharded_records(vol, ids, nc, mesh, iso=iso,
                                              n_iter=n_iter, batch=batch)
        if mesh.lead:
            rec, tq = marching._records_to_host(rec, tq)
            bbox = torch.as_tensor(sdf_params, dtype=torch.float32)
            verts, faces = native.mesh_assemble(
                ids.cpu().numpy(), rec, tq, nc, R, bbox.cpu().numpy())
    else:
        verts = np.zeros((0, 3), np.float32)
        faces = np.zeros((0, 3), np.int32)
    out = []
    for a, dtype in ((verts, torch.float32), (faces, torch.int32)):
        t = (torch.from_numpy(a).to(dev) if mesh.lead
             else torch.empty((0, 3), dtype=dtype, device=dev))
        out.append(parallel.broadcast(t, mesh).cpu().numpy())
    return out[0], out[1]


def reconstruct_image(params: Params, img, cfg: Config, trans_mat=None,
                      cam_params: Params | None = None, sparse: bool = True,
                      clean: bool = False,
                      device: str | torch.device | None = None,
                      stats: dict | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """One image -> (verts, faces) with its camera given or estimated: the
    body of the `demo` subcommand. img [H,W,C] (uint8, or float in [0,1]);
    trans_mat [4,3], or None with `cam_params`, the camera net's params,
    whose pred_trans_mat (posenet.predict_trans_mat on the image's RGB)
    is then the camera; params are the SDF net's. Runs on `device` (the
    GPU by default; it raises without one). With `stats`, the estimated
    camera goes into stats["trans_mat"] and image_to_mesh's entries
    follow."""
    dev = device_mod.resolve(device)
    if trans_mat is None:
        if cam_params is None:
            raise ValueError("an image without a camera needs the camera "
                             "net's params (cam_params)")
        img_t = torch.as_tensor(np.asarray(img)).to(dev)
        trans_mat = posenet.predict_trans_mat(cam_params, img_t[None],
                                              cfg, device=dev)[0]
        if stats is not None:
            stats["trans_mat"] = trans_mat.cpu().numpy()
    return image_to_mesh(params, img, trans_mat, cfg, sparse=sparse,
                         clean=clean, device=dev, stats=stats)


def estimate_cameras(cam_params: Params, records: Iterable, cfg: Config,
                     batch: int = 64,
                     device: str | torch.device | None = None
                     ) -> Iterator[tuple[Any, codecs.ViewRecord]]:
    """(key, ViewRecord) pairs -> the same pairs, in order, each record's
    trans_mat replaced by the camera net's prediction from its image's
    RGB: the images go through the net BATCH at a time (the last batch
    may be shorter) on `device` (the GPU by default; it raises without
    one), and one batch's predictions are copied to the host while the
    next batch runs."""
    dev = device_mod.resolve(device)
    cam_params = device_mod.tree_to(cam_params, dev)
    inflight: deque = deque()
    keys: list = []
    recs: list = []

    def dispatch():
        imgs = torch.from_numpy(np.stack([r.img_arr[:, :, :3]
                                          for r in recs]))
        inflight.append((posenet.predict_trans_mat(cam_params, imgs, cfg,
                                                   device=dev), keys, recs))

    def collect():
        preds, ks, rs = inflight.popleft()
        for key, rec, pred in zip(ks, rs, preds.cpu().numpy()):
            yield key, dataclasses.replace(rec, trans_mat=pred)

    for key, rec in records:
        keys.append(key)
        recs.append(rec)
        if len(keys) == batch:
            dispatch()
            keys, recs = [], []
            if len(inflight) > 1:
                yield from collect()
    if keys:
        dispatch()
    while inflight:
        yield from collect()


def result_dir(log_dir: str, cfg: Config, cam_est: bool = False) -> str:
    """The reference's output root: {log_dir}/test_objs/{R}_{iso}, with
    the prefix camest_ on the tag for estimated cameras."""
    tag = f"{cfg.grid_resolution}_{cfg.iso}"
    return os.path.join(log_dir, "test_objs",
                        "camest_" + tag if cam_est else tag)


def reconstruct_split(params: Params, cfg: Config, paths, listinfo,
                      log_dir: str, cam_est: bool = False,
                      sparse: bool = True, logger: Any = None,
                      writers: int = WRITERS, prefetch: int = PREFETCH,
                      shard_index: int = 0, shard_count: int = 1,
                      depth: int = 2,
                      device: str | torch.device | None = None,
                      read_view: Callable = codecs.read_view_h5,
                      read_sdf_params: Callable = codecs.read_sdf_params
                      ) -> list[str]:
    """Reconstruct every (cat, obj, view) of `listinfo` whose position i
    has i % shard_count == shard_index into
    {result_dir}/{cat}/{cat}_{obj}_{view:02d}.obj; returns the paths, in
    list order. cam_est=True writes under the camest_ tag; the records then
    come from the estimated-camera tree that `paths` names (the camera
    net's `train-cam --mode create` writes it).

    The reader thread reads each view with ``read_view(paths.img_path(..))``
    and each object's sdf_params once with
    ``read_sdf_params(paths.sdf_path(..))`` (h5 files by default), at most
    `prefetch` records ahead. The calling thread owns all device work
    (_fused_dispatch on `device`, the GPU by default; it raises without
    one): a software pipeline `depth` images deep dispatches image k, then
    flushes image k - depth, handing its host half (_fused_collect's
    closure: the record route's C++ passes) and its OBJ write to a pool of
    `writers` threads, at most the spare cores. The calling thread waits
    when more than 4 x writers + 4 writes are pending. The record route's
    last copy is non-blocking (join=False), so it lands while the calling
    thread goes on; the closure waits for it. An exception in a closure or
    a write re-raises here; the reader is then stopped and joined, and
    the pool finishes the writes it started (no truncated file)."""
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    my_list = [t for i, t in enumerate(listinfo)
               if i % shard_count == shard_index]
    out_root = result_dir(log_dir, cfg, cam_est)
    writers = max(1, min(writers, (os.cpu_count() or 2) - 1))
    q: Queue = Queue(maxsize=max(1, prefetch))
    stop = Event()

    def reader():
        sdf_key, sdf_params = None, None
        for cat_id, obj, view in my_list:
            if stop.is_set():
                break
            try:
                rec = read_view(paths.img_path(cat_id, obj, view))
                if (cat_id, obj) != sdf_key:
                    sdf_params = read_sdf_params(paths.sdf_path(cat_id, obj))
                    sdf_key = (cat_id, obj)
                q.put((cat_id, obj, view, rec, sdf_params))
            except Exception as e:  # the calling thread re-raises it
                q.put(e)
                return
        q.put(None)

    t = Thread(target=reader, name="reconstruct_split-reader", daemon=True)
    t.start()
    pool = ThreadPoolExecutor(writers, thread_name_prefix="reconstruct_split")
    futures: deque = deque()
    pending: deque = deque()
    written = []

    def flush(ctx, out: str, tag: str) -> None:
        assemble = _collect_or_dense(ctx, defer=True)

        def write():
            codecs.write_obj(out, *assemble())

        futures.append(pool.submit(write))
        while len(futures) > 4 * writers + 4:
            futures.popleft().result()
        if logger:
            logger.log(f"reconstructed {tag}")

    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            cat_id, obj, view, rec, sdf_params = item
            # u8 straight to the device, normalised there
            img = rec.img_arr[:, :, :cfg.img_channels]
            out = os.path.join(out_root, cat_id,
                               f"{cat_id}_{obj}_{view:02d}.obj")
            written.append(out)
            pending.append((_fused_dispatch(
                params, img, rec.trans_mat, sdf_params, cfg, cfg.iso,
                sparse=sparse, device=dev, join=False), out,
                f"{cat_id}/{obj}/{view}"))
            while len(pending) > max(1, depth):
                flush(*pending.popleft())
        while pending:
            flush(*pending.popleft())
        while futures:
            futures.popleft().result()
    finally:
        stop.set()
        # unblock a reader waiting on the full queue, then join it
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except Empty:
                pass
        t.join()
        pool.shutdown(wait=True)  # no truncated files left behind
    return written


def multiview_to_mesh(params: Params, imgs, trans_mats, sdf_params,
                      cfg: Config, device: str | torch.device | None = None,
                      stats: dict | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """V views of one object ([V,H,W,C] u8, or float in [0,1]) and their
    [V,4,3] cameras -> one fused mesh (verts, faces) on `device` (the GPU
    by default; it raises without one): multiview_sdf_sparse, or
    multiview_sdf when its active cells overflow the cap, then
    volume_to_mesh at cfg.iso (the owned-edge extractor on the device).
    `stats` receives the volume's entries (see infer/multiview), with
    ``dense_fallback`` True after the dense stream, and
    ``extraction_ms``."""
    dev = device_mod.resolve(device)
    vol = multiview.multiview_sdf_sparse(params, imgs, trans_mats,
                                         sdf_params, cfg, device=dev,
                                         stats=stats)
    if vol is None:
        if stats is not None:
            stats["dense_fallback"] = True
        vol = multiview.multiview_sdf(params, imgs, trans_mats, sdf_params,
                                      cfg, device=dev, stats=stats)
    with device_mod.stage(stats, "extraction_ms", dev):
        return volume_to_mesh(vol, sdf_params, iso=cfg.iso)


def reconstruct_multiview(params: Params, cfg: Config, paths, listinfo,
                          log_dir: str, logger: Any = None,
                          device: str | torch.device | None = None
                          ) -> list[str]:
    """`create-sdf --multi-view`: per object of `listinfo`, ALL its listed
    views fused (multiview_to_mesh on `device`, the GPU by default) into
    one mesh, {result_dir}_mv/{cat}/{cat}_{obj}_fused.obj; returns the
    paths, objects in sorted order. The views and the object's
    sdf_params are read with core/codecs' h5 readers (looked up at each
    call); the u8 images go to the device as they are."""
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    by_obj: dict[tuple[str, str], list[int]] = {}
    for cat_id, obj, view in listinfo:
        by_obj.setdefault((cat_id, obj), []).append(view)
    out_root = result_dir(log_dir, cfg) + "_mv"
    written = []
    for (cat_id, obj), views in sorted(by_obj.items()):
        recs = [codecs.read_view_h5(paths.img_path(cat_id, obj, v))
                for v in sorted(views)]
        imgs = np.stack([r.img_arr[:, :, :cfg.img_channels] for r in recs])
        mats = np.stack([r.trans_mat for r in recs])
        sdf_params = codecs.read_sdf_params(paths.sdf_path(cat_id, obj))
        stats: dict = {}
        verts, faces = multiview_to_mesh(params, imgs, mats, sdf_params, cfg,
                                         device=dev, stats=stats)
        out = os.path.join(out_root, cat_id, f"{cat_id}_{obj}_fused.obj")
        codecs.write_obj(out, verts, faces)
        written.append(out)
        if logger:
            logger.log(f"fused {len(views)} views: {cat_id}/{obj}"
                       + (" (dense: the active cells overflowed the cap)"
                          if stats["dense_fallback"] else ""))
    return written
