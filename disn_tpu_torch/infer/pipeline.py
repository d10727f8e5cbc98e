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
device). The JAX package's remote-link machinery (speculative buckets,
optimistic background assembly, chunked fetch streams) is not ported.

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
import os
import time
from collections import deque
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


def _fused_dispatch(params: Params, img, trans_mat, sdf_params,
                    cfg: Config, iso: float, sparse: bool = True,
                    device: str | torch.device | None = None,
                    stats: dict | None = None, join: bool = True) -> dict:
    """The device half of image_to_mesh (named after the JAX package's
    _fused_dispatch): encode, prep, phase_a, phase_b, the scan and the
    extraction's device work and copies, all on the calling thread, with
    image_to_mesh's route choice, counts, guards and _SWORDS_SKIP rule.
    Returns the context _fused_collect finishes: the extraction's closure
    (host work only: it holds no CUDA tensor and issues no device
    operation) and what `stats` needs. join=False makes the record route's
    final copy non-blocking (see marching.extract_mesh_records_deferred),
    so the calling thread moves on before it lands; the volume flow's
    routes copy the mesh here in either case.

    The port's device work syncs where the JAX package's speculative
    dispatch does not (active-cell counts, the guards), so this returns
    once the device work up to the final copy is done; what the split
    moves off the calling thread is the host assembly."""
    dev = device_mod.resolve(device)
    scan = vol = None
    if sparse and _sparse_eligible(cfg):
        key = (cfg, float(iso))
        words = (cfg.sparse_words and key not in _SWORDS_SKIP
                 and sparse_mod.words_eligible(cfg))
        vol, scan = sparse_mod.sparse_volume(
            params, img, trans_mat, sdf_params, cfg, device=dev,
            stats=stats, scan_iso=iso, words=words)
        if words and vol is not None and scan is not None:
            _SWORDS_SKIP.add(key)
    else:
        vol = predict_volume(params, img, trans_mat, sdf_params, cfg,
                             device=dev, sparse=False)
    t0 = None
    if stats is not None:  # extraction_ms: from here to the closure's end
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
    if scan is None:
        route = "tets"
        fin = marching.extract_mesh_owned_deferred(vol, sdf_params, iso=iso,
                                                   device=vol.device)
    elif vol is None:
        route = "records_sparse"
        words_d, ids, n_cells, guard, blk = scan
        fin = marching.extract_mesh_records_deferred_sparse(
            words_d, cfg.grid_resolution, sdf_params, ids, n_cells, blk,
            join=join, stats=stats)
    else:
        ids, n_cells, guard, _ = scan
        if guard == 0:
            route = "owned_ids"
            fin = marching.extract_mesh_from_ids_deferred(
                vol, sdf_params, ids, iso=iso, device=dev, stats=stats)
        else:
            route = "owned_scan"
            fin = marching.extract_mesh_owned_deferred(
                vol, sdf_params, iso=iso, device=dev, stats=stats)
    if stats is not None:
        stats["route"] = route
        if scan is not None:
            stats.update(fine_cells=n_cells, guard=guard)
    return {"fin": fin, "stats": stats, "t0": t0}


def _fused_collect(ctx: dict, defer: bool = False, clean: bool = False):
    """The host half of image_to_mesh (named after the JAX package's
    _fused_collect): the extraction's closure, then clean_small_parts
    when `clean`. defer=True returns it as a zero-argument closure for a
    writer pool (it touches no device); otherwise runs it and returns
    (verts, faces)."""
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
    quantised to the cell over 510, or 131070 on grids under 129). When
    its guard trips (active cells on the + boundary, a band violation) the
    image goes through the volume flow from the same coarse pass, and
    (cfg, iso) keeps to the volume flow from then on, as the JAX package's
    _SWORDS_SKIP does. The volume flow scans the fine cells inside the
    active coarse cells and extracts the welded mesh on the device (route
    ``owned_ids``); if the scan's guard finds a sign change outside those
    cells, the whole volume is scanned instead (``owned_scan``). When the
    active cells overflow the cap, the config is not eligible for the
    sparse path (_sparse_eligible: binary heads without
    cfg.binary_sparse, THREEDCNN, other grids), or ``sparse`` is false,
    the dense volume (predict_volume; THREEDCNN's fixed 65^3 one) goes
    through volume_to_mesh (``tets``). Every variant and both sampling
    modes decode through infer/fused.kernel_enabled's choice: the kernel
    for twostream + tf1 on its grids, the plain decode otherwise.

    `stats`, when given, receives per-stage wall times in ms (each stage
    synchronised: encode, prep, phase_a, phase_b and scan or
    dense_fallback, then extraction, which covers everything after the
    volume and the scan, with its parts extract on the device and fetch to
    the host on the owned and records_sparse routes, and assemble on the
    host on records_sparse), ``active_cells``, ``route`` with, on the
    sparse path, ``fine_cells`` and ``guard``, and ``swords_guard`` when
    the sparse-words flow ran.

    The call is _fused_dispatch (the device half, with every copy) and
    _fused_collect (the host half); reconstruct_split runs the two apart."""
    if sdf_params is None:
        sdf_params = UNIT_BOX
    iso = cfg.iso if iso is None else iso
    ctx = _fused_dispatch(params, img, trans_mat, sdf_params, cfg, iso,
                          sparse=sparse, device=device, stats=stats)
    return _fused_collect(ctx, clean=clean)


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
        assemble = _fused_collect(ctx, defer=True)

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
