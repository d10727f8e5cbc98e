"""Carry weights across from the JAX package, without JAX, and from TF1
checkpoints (``tf_ckpt``: ``read_tf_checkpoint``, ``tf_vars_to_params``,
``convert_checkpoint``, the ``convert-ckpt`` subcommand).

* ``params_from_jax``: a nested dict of numpy arrays (``jax.device_get`` of
  a disn_tpu param tree) -> the same tree of torch tensors. Layouts are
  shared (HWIO convs, [in,out] dense), so this is a leaf-by-leaf copy that
  keeps each leaf's dtype; the layers cast to the compute type as the JAX
  layers do.
* ``load_npz``: read the flat npz that disn_tpu/train/checkpoint.save
  writes (leaf paths joined with ``$``, an optional ``__metadata__`` entry,
  f16 leaves allowed).
* ``opt_state_to_reference`` / ``opt_state_from_reference``: a
  torch.optim.Adam or SGD-momentum state <-> the tree of the JAX package's
  optax state, so a full-state checkpoint (``params$...``,
  ``opt_state$...``, ``step``) resumes in either package:

      Adam      opt_state$0$count   <-> exp_avg's "step" (one for all)
                opt_state$0$mu$<p>  <-> exp_avg
                opt_state$0$nu$<p>  <-> exp_avg_sq
      momentum  opt_state$0$trace$<p> <-> momentum_buffer
      both      opt_state$1$count   (the schedule's count)

  Leaf paths <p> are the param tree's, in sorted key order; the
  optimizer's parameters are the param tree's leaves in that order.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from disn_tpu_torch.train import checkpoint

_SEP = "$"


def params_from_jax(tree: Any) -> Any:
    """Nested dict of array-likes -> nested dict of CPU torch tensors (the
    entry points move them to their device)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def load_npz(path: str) -> dict:
    """Flat ``$``-joined npz -> nested dict of CPU torch tensors (the tree
    disn_tpu.train.checkpoint.restore_params returns, as torch)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key == "__metadata__":
                continue
            parts = key.split(_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(z[key])
    return tree


def _is_adam(opt: torch.optim.Optimizer) -> bool:
    if isinstance(opt, torch.optim.Adam):
        return True
    if isinstance(opt, torch.optim.SGD):
        return False
    raise TypeError(f"no reference names for {type(opt).__name__}")


def opt_state_to_reference(opt: torch.optim.Optimizer, params: dict,
                           count: int) -> dict:
    """The optax state tree of `opt` over `params` (numpy leaves): Adam's
    {"0": {"count", "mu", "nu"}, "1": {"count"}} or momentum's
    {"0": {"trace"}, "1": {"count"}}. A moment not made yet is zeros, as
    optax initialises it."""
    def moment(p, name):
        t = opt.state.get(p, {}).get(name)
        return (np.zeros(tuple(p.shape), np.float32) if t is None
                else t.detach().cpu().numpy())

    names = ("exp_avg", "exp_avg_sq") if _is_adam(opt) else (
        "momentum_buffer",)
    trees = [checkpoint.unflatten({path: moment(p, n)
                                   for path, p in checkpoint.leaves(params)})
             for n in names]
    c = np.asarray(count, np.int32)
    first = (dict(count=c, mu=trees[0], nu=trees[1]) if len(trees) == 2
             else dict(trace=trees[0]))
    return {"0": first, "1": {"count": c}}


def opt_state_from_reference(opt: torch.optim.Optimizer, params: dict,
                             tree: dict) -> int:
    """Load an optax state tree (as ``opt_state_to_reference`` gives it, or
    a JAX checkpoint's ``opt_state``) into `opt`; returns the schedule's
    count."""
    adam = _is_adam(opt)
    flat = {k: np.asarray(v) for k, v in checkpoint.leaves(tree)}
    state = {}
    for i, (path, _) in enumerate(checkpoint.leaves(params)):
        if adam:
            state[i] = {
                "step": torch.tensor(float(flat["0$count"]),
                                     dtype=torch.float32),
                "exp_avg": torch.from_numpy(flat["0$mu$" + path].copy()),
                "exp_avg_sq": torch.from_numpy(flat["0$nu$" + path].copy())}
        else:
            state[i] = {"momentum_buffer": torch.from_numpy(
                flat["0$trace$" + path].copy())}
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})
    return int(flat["1$count"])


from disn_tpu_torch.convert.tf_ckpt import (  # noqa: E402,F401
    convert_checkpoint, read_tf_checkpoint, tf_vars_to_params,
)
