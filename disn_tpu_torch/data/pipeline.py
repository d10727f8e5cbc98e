"""Training data pipeline: h5 reading, category-balanced sampling,
multi-worker host batch assembly and one batch in flight to the device
(port of disn_tpu/data/pipeline.py).

The host side is the JAX package's, draw for draw: the same seed gives the
same epoch orders and bit-identical batches. The device side differs: a
batch's host arrays are copied into page-locked tensors and sent with
``.to(device, non_blocking=True)`` while the previous batch trains.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.core import codecs
from disn_tpu_torch.data.listing import ListInfo, SplitPaths


class EpochSampler:
    """Category-balanced epoch ordering: per-category quota = min(cat_limit,
    available); each epoch shuffles the full index list and takes entries
    first-come until every category reaches its quota. Deterministic given
    its seed. With host_count > 1 each host (a data rank) keeps its own
    contiguous stripe, host_id, of len // host_count entries: the hosts
    draw the same order from the same seed, so their stripes are disjoint
    and cover the epoch truncated to a multiple of host_count."""

    def __init__(self, listinfo: ListInfo, cats_limit: dict[str, int],
                 cat_limit: int, shuffle: bool = True, seed: int = 0,
                 host_id: int = 0, host_count: int = 1):
        self.listinfo = listinfo
        self.cats_limit = {c: min(cat_limit, n) for c, n in cats_limit.items()}
        self.epoch_amount = sum(self.cats_limit.values())
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.host_id = host_id
        self.host_count = host_count

    def epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.listinfo))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.epoch_amount < len(self.listinfo):
            quota = dict(self.cats_limit)
            picked = []
            for idx in order:
                cat_id = self.listinfo[idx][0]
                if quota.get(cat_id, 0) > 0:
                    picked.append(idx)
                    quota[cat_id] -= 1
                if len(picked) == self.epoch_amount:
                    break
            order = np.asarray(picked)
        if self.host_count > 1:
            per = len(order) // self.host_count
            order = order[self.host_id * per:(self.host_id + 1) * per]
        return order


class SdfImageDataset:
    """Per-item loading and batch assembly (numpy, host side).

    A batch holds pc [B,P,3], sdf_pt [B,N,3], sdf_pt_rot [B,N,3], sdf_val
    [B,N,1], norm_params [B,4], sdf_params [B,6], img [B,H,W,3|4] float
    /255, trans_mat [B,4,3], regress_mat [B,4,3] (and shifts [B,2] with
    cfg.cam_shift). The (cat_id, obj, view) ids come separately.

    `_load_sdf` and `_read_view` read the h5 files; a subclass may serve
    the records from elsewhere (memory) by overriding them."""

    def __init__(self, cfg: Config, paths: SplitPaths, listinfo: ListInfo,
                 seed: int = 0):
        self.cfg = cfg
        self.paths = paths
        self.listinfo = listinfo
        self.rng = np.random.RandomState(seed + 1)
        self._sdf_cache: dict[str, codecs.SdfSamples] = {}
        self._view_cache: dict[str, codecs.ViewRecord] = {}
        self._cache_lock = threading.Lock()
        self.cache_size = 8192
        self.view_cache_size = 4096

    def _cached(self, cache: dict, limit: int, key: str, read):
        with self._cache_lock:
            hit = cache.get(key)
        if hit is not None:
            return hit
        rec = read()
        with self._cache_lock:
            if len(cache) < limit:
                cache[key] = rec
        return rec

    def _load_sdf(self, cat_id: str, obj: str) -> codecs.SdfSamples:
        return self._cached(
            self._sdf_cache, self.cache_size, f"{cat_id}/{obj}",
            lambda: codecs.read_sdf_h5(self.paths.sdf_path(cat_id, obj)))

    def _read_view(self, cat_id: str, obj: str, view: int
                   ) -> codecs.ViewRecord:
        return self._cached(
            self._view_cache, self.view_cache_size, f"{cat_id}/{obj}/{view}",
            lambda: codecs.read_view_h5(
                self.paths.img_path(cat_id, obj, view)))

    @staticmethod
    def random_shift(raw: np.ndarray, rng: np.random.RandomState
                     ) -> tuple[np.ndarray, np.ndarray]:
        """2-DoF object translation augmentation for the camera net's xy
        shift head: move the object's pixels within 0.7x of its free
        margins; the target is (x, y) * 2 / img_h."""
        h, w = raw.shape[:2]
        alpha = np.argwhere(raw[:, :, 3] > 0)
        if len(alpha) == 0:
            return raw, np.zeros(2, np.float32)
        top = alpha[:, 0].min()
        down = h - alpha[:, 0].max()
        left = alpha[:, 1].min()
        right = w - alpha[:, 1].max()

        def rand_range(lo, hi):
            lo, hi = int(-lo * 0.7), int(hi * 0.7)
            return rng.randint(lo, hi) if hi > lo else 0

        y_shift = rand_range(top, down)
        x_shift = rand_range(left, right)
        out = np.zeros_like(raw)
        out[alpha[:, 0] + y_shift, alpha[:, 1] + x_shift] = \
            raw[alpha[:, 0], alpha[:, 1]]
        return out, np.asarray([x_shift, y_shift], np.float32) * 2.0 / h

    def _load_img(self, cat_id: str, obj: str, view: int,
                  rng: np.random.RandomState) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rec = self._read_view(cat_id, obj, view)
        raw = rec.img_arr
        shifts = None
        if cfg.cam_shift:
            raw, shifts = self.random_shift(raw, rng)
        if cfg.alpha:
            img = raw[:, :, :4].astype(np.float32) / 255.0
        else:
            img = raw[:, :, :3].astype(np.float32)
            alpha = raw[:, :, 3]
            # colour augmentation: the reference computes the fore/back
            # shifts without applying them; the flags (off by default)
            # apply them
            if cfg.augcolorfore or cfg.augcolorback:
                aug = rng.rand(3).astype(np.float32) * 60.0 - 30.0
                if cfg.augcolorfore:
                    img[alpha != 0] += aug
                if cfg.augcolorback:
                    img[alpha == 0] += aug
            if cfg.backcolorwhite:
                img[alpha == 0] = 255.0
            img = np.clip(img, 0.0, 255.0) / 255.0
        out = {
            "img": img,
            "trans_mat": rec.trans_mat,
            "regress_mat": rec.regress_mat,
            "obj_rot_mat": rec.obj_rot_mat,
        }
        if shifts is not None:
            out["shifts"] = shifts
        return out

    def get_example(self, index: int,
                    rng: np.random.RandomState | None = None
                    ) -> dict[str, np.ndarray]:
        """One example; draws from `rng` in the order: the view's
        augmentation, the surface point, the sample choice."""
        cfg = self.cfg
        rng = rng or self.rng
        cat_id, obj, view = self.listinfo[index]
        sdf = self._load_sdf(cat_id, obj)
        view_rec = self._load_img(cat_id, obj, view, rng)

        n = cfg.num_sample_points
        out: dict[str, np.ndarray] = {}
        # surface-point slot (debug dumps, chamfer diagnostics)
        pick = rng.randint(sdf.ori_pt.shape[0], size=cfg.num_points)
        out["pc"] = sdf.ori_pt[pick]
        if sdf.sample_pt is None:  # full-grid variant (3D-CNN baseline)
            out["sdf_pt"] = np.zeros((n, 3), np.float32)
            out["sdf_pt_rot"] = out["sdf_pt"]
            out["sdf_val"] = sdf.sample_sdf[:, None].astype(np.float32)
        else:
            total = sdf.sample_pt.shape[0]
            if n > total:
                choice = rng.randint(total, size=n)
            else:
                choice = rng.choice(total, size=n, replace=False)
            pts = sdf.sample_pt[choice]
            out["sdf_pt"] = pts
            out["sdf_val"] = sdf.sample_sdf[choice, None].astype(np.float32)
            if cfg.rot:
                out["sdf_pt_rot"] = pts @ view_rec["obj_rot_mat"]
            else:
                out["sdf_pt_rot"] = pts
        out["norm_params"] = sdf.norm_params
        out["sdf_params"] = sdf.sdf_params
        for k in ("img", "trans_mat", "regress_mat"):
            out[k] = view_rec[k]
        if "shifts" in view_rec:
            out["shifts"] = view_rec["shifts"]
        return out

    def get_batch(self, indices: np.ndarray,
                  rng: np.random.RandomState | None = None
                  ) -> tuple[dict[str, np.ndarray], list[tuple[str, str, int]]]:
        examples = [self.get_example(int(i), rng) for i in indices]
        batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
        ids = [self.listinfo[int(i)] for i in indices]
        return batch, ids


class PrefetchLoader:
    """Multi-worker batch producer with one batch in flight to the device.

    Host side: `workers` threads each assemble whole batches (h5 reads
    release the GIL) into a bounded queue; the consumer yields them in
    order. Device side: batch i+1 is copied into page-locked memory and
    sent with a non-blocking copy before batch i is handed out, so the copy
    overlaps batch i's step. `device="cpu"` hands out CPU tensors.

    `wait_s` sums the seconds the consumer spent blocked on the workers."""

    def __init__(self, dataset: SdfImageDataset, sampler: EpochSampler,
                 batch_size: int, epochs: int, workers: int = 4,
                 qsize: int = 16, drop_ids: bool = True, seed: int = 0,
                 device: str | torch.device | None = None):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.epochs = epochs
        self.workers = workers
        self.drop_ids = drop_ids
        self.seed = seed
        self.device = device_mod.resolve(device)
        self.wait_s = 0.0
        self._q: queue.Queue = queue.Queue(qsize)
        self._work_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        stripe = (min(sampler.epoch_amount, len(sampler.listinfo))
                  // sampler.host_count)
        self.batches_per_epoch = max(1, stripe // batch_size)
        self.total_batches = self.batches_per_epoch * epochs

    # -- host producer ------------------------------------------------------
    def _producer(self, wid: int) -> None:
        rng = np.random.RandomState(self.seed + 977 * wid)
        while not self._stop.is_set():
            try:
                item = self._work_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                return
            bno, indices = item
            try:
                batch, ids = self.dataset.get_batch(indices, rng)
                self._q.put((bno, batch, ids))
            except Exception as e:  # surface loader errors to the consumer
                self._q.put((bno, e, None))

    def start(self) -> "PrefetchLoader":
        # enqueue all work up front (index lists are tiny)
        for ep in range(self.epochs):
            order = self.sampler.epoch_order()
            for b in range(self.batches_per_epoch):
                sl = order[b * self.batch_size:(b + 1) * self.batch_size]
                if len(sl) < self.batch_size:  # wrap like the reference
                    sl = np.concatenate(
                        [sl, order[:self.batch_size - len(sl)]])
                self._work_q.put((ep * self.batches_per_epoch + b, sl))
        for w in range(self.workers):
            self._work_q.put(None)
            t = threading.Thread(target=self._producer, args=(w,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self) -> None:
        """Stop the workers and wait for them (a worker blocked on the
        full output queue is freed by draining it)."""
        self._stop.set()
        deadline = time.monotonic() + 10.0
        while (any(t.is_alive() for t in self._threads)
               and time.monotonic() < deadline):
            for q_ in (self._work_q, self._q):
                while True:
                    try:
                        q_.get_nowait()
                    except queue.Empty:
                        break
            for t in self._threads:
                t.join(timeout=0.05)

    # -- consumer -----------------------------------------------------------
    def _host_batches(self) -> Iterator[Any]:
        """Yield batches in order (workers may complete out of order)."""
        pending: dict[int, Any] = {}
        for want in range(self.total_batches):
            while want not in pending:
                t0 = time.perf_counter()
                bno, batch, ids = self._q.get()
                self.wait_s += time.perf_counter() - t0
                pending[bno] = (batch, ids)
            batch, ids = pending.pop(want)
            if isinstance(batch, Exception):
                self.shutdown()
                raise batch
            yield batch, ids

    def _to_device(self, batch: dict[str, np.ndarray]
                   ) -> dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                        non_blocking=True)
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Any]:
        prev = None
        for batch, ids in self._host_batches():
            nxt = (self._to_device(batch), ids)
            if prev is not None:
                yield prev[0] if self.drop_ids else prev
            prev = nxt
        if prev is not None:
            yield prev[0] if self.drop_ids else prev

    def __len__(self) -> int:
        return self.total_batches


def make_loader(cfg: Config, paths: SplitPaths, listinfo: ListInfo,
                cats_limit: dict[str, int], epochs: int = 1,
                shuffle: bool | None = None, workers: int = 4, seed: int = 0,
                device: str | torch.device | None = None, host_id: int = 0,
                host_count: int = 1, batch_size: int | None = None
                ) -> PrefetchLoader:
    """The loader of one host (data rank) `host_id` of `host_count`: its
    stripe of every epoch, in batches of `batch_size` (cfg.batch_size by
    default; a data-parallel run gives each rank cfg.batch_size //
    host_count, so the global batch stays cfg.batch_size)."""
    dataset = SdfImageDataset(cfg, paths, listinfo, seed=seed)
    sampler = EpochSampler(
        listinfo, cats_limit, cfg.cat_limit,
        shuffle=cfg.shuffle if shuffle is None else shuffle, seed=seed,
        host_id=host_id, host_count=host_count)
    return PrefetchLoader(dataset, sampler, batch_size or cfg.batch_size,
                          epochs, workers=workers, seed=seed, device=device)
