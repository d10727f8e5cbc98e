"""Checkpoints: atomic flat-npz save/restore and param-subset composition (a
copy of disn_tpu/train/checkpoint.py without JAX).

A checkpoint is one .npz of path-flattened leaves, the path's keys joined
with ``$`` in sorted order, plus an optional ``__metadata__`` JSON entry;
the JAX package reads and writes the same files. Trees are nested dicts
whose leaves are numpy arrays, torch tensors or numbers.

* ``merge_scopes`` composes a param tree from another checkpoint's
  top-level scopes (vgg_16, sdfprediction, ...), skipping shape mismatches;
* ``CheckpointManager`` keeps latest.npz every save, best.npz by a metric
  and epoch_NNN.npz every `period` epochs.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
import torch

Params = dict[str, Any]

_SEP = "$"


def _as_numpy(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(joined path, leaf) in sorted key order, as JAX flattens dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {k: _as_numpy(v) for k, v in leaves(tree)}


def unflatten(flat: dict[str, np.ndarray]) -> Params:
    tree: Params = {}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write `tree` to `path` through a temporary file and a rename."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    if metadata is not None:
        flat["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _read(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__metadata__"}


def load_metadata(path: str) -> dict:
    with np.load(path) as z:
        if "__metadata__" in z:
            return json.loads(bytes(z["__metadata__"]).decode())
    return {}


def restore(path: str, target: Any) -> Any:
    """Restore into the structure of ``target``, a nested dict of numpy
    arrays (shapes must match; each leaf comes back in the target's
    dtype)."""
    flat = _read(path)

    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(v, prefix + (str(k),)) for k, v in node.items()}
        key = _SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if arr.shape != _shape(node):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"target {_shape(node)}")
        return arr.astype(np.asarray(node).dtype)

    return fill(target, ())


def restore_params(path: str) -> Params:
    """A nested dict of numpy arrays, without a target structure."""
    return unflatten(_read(path))


def merge_scopes(params: Params, ckpt_params: Params,
                 scopes: tuple[str, ...] | None = None,
                 skip_mismatch: bool = True,
                 skip_substr: tuple[str, ...] = ()
                 ) -> tuple[Params, list[str]]:
    """Overlay ``ckpt_params`` onto a copy of ``params`` for the given
    top-level scopes: a leaf is taken from the checkpoint iff its path
    exists in ``params``, the shapes agree (else it is skipped when
    skip_mismatch) and no skip_substr matches ('fc8' when only the encoder
    is restored). Returns the merged tree and the skipped leaf paths."""
    skipped: list[str] = []

    def overlay(dst, src, path):
        if not isinstance(dst, dict) or not isinstance(src, dict):
            return
        for k, v in src.items():
            p = f"{path}/{k}" if path else k
            if any(s in p for s in skip_substr) or k not in dst:
                skipped.append(p)
                continue
            if isinstance(v, dict):
                overlay(dst[k], v, p)
                continue
            if _shape(dst[k]) != _shape(v):
                if skip_mismatch:
                    skipped.append(p)
                    continue
                raise ValueError(f"{p}: {_shape(v)} != {_shape(dst[k])}")
            dst[k] = np.asarray(v)

    merged = _copy_dicts(params)
    src = ckpt_params
    if scopes is not None:
        src = {k: v for k, v in ckpt_params.items() if k in scopes}
    overlay(merged, src, "")
    return merged, skipped


def _copy_dicts(tree: dict) -> dict:
    """A copy of every dict of `tree`; the leaves are shared."""
    return {k: _copy_dicts(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


class CheckpointManager:
    """Retention policy: latest every save, best by metric, periodic
    epochs."""

    def __init__(self, directory: str, period: int = 10):
        self.dir = directory
        self.period = period
        self.best_metric = -np.inf
        os.makedirs(directory, exist_ok=True)

    def save_latest(self, tree: Any, step: int, **meta) -> None:
        save(os.path.join(self.dir, "latest.npz"), tree,
             {"step": int(step), **meta})

    def save_epoch(self, tree: Any, epoch: int, metric: float | None = None,
                   **meta) -> None:
        md = {"epoch": int(epoch), **meta}
        if metric is not None and metric > self.best_metric:
            self.best_metric = float(metric)
            save(os.path.join(self.dir, "best.npz"), tree,
                 {**md, "metric": float(metric)})
        if epoch % self.period == 0:
            save(os.path.join(self.dir, f"epoch_{epoch:03d}.npz"), tree, md)

    def latest_path(self) -> str | None:
        p = os.path.join(self.dir, "latest.npz")
        return p if os.path.exists(p) else None

    def best_path(self) -> str | None:
        p = os.path.join(self.dir, "best.npz")
        return p if os.path.exists(p) else None
