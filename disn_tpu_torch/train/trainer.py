"""Training: optimizer, learning-rate schedule and the SDF train step (port
of disn_tpu/train/trainer.py).

Optimizer parity with the JAX package's optax chains: Adam(beta1 =
cfg.beta1, beta2 0.999, eps 1e-8) or SGD with momentum and no dampening,
the learning rate of step i being ``lr_schedule(cfg)(i)`` with i counted
before the step (optax's scale_by_schedule reads its count, then
increments it): a staircase exponential decay by samples seen, floored at
cfg.lr_floor. The loss is the L1 SDF loss of models/disn.get_loss on
``sdf_val - cfg.iso_offset``.

The step is eager PyTorch: the folded forward pass, autograd's backward
(the sampler's gather becomes a scatter-add into the folded map) and the
optimizer's update, which is one fused kernel on the card. Parameters are
leaf tensors with ``requires_grad``; a step updates them in place. The
camera net's step (make_cam_train_step) is the same step on
models/posenet's forward pass and loss.

Data parallel (the JAX package's step on a mesh, where XLA all-reduces the
gradients over the data axis): with a ``parallel.Mesh``, each rank runs the
step on its shard of the batch, and after backward the gradients are
averaged over every rank of the mesh, as one flat buffer per dtype (one
collective a dtype, not one a tensor). create_state broadcasts the mesh's
first rank's parameters, so every rank starts from them and, the averaged
gradients being equal, stays with them. The average is the whole batch's
gradient when every term of the loss is a mean over equal shards, which
holds for the SDF loss on a data split, a points split (the JAX package's
2D dry run) or both; the camera loss's batch sums are scaled by the shard
count first (posenet.get_loss's sum_scale). The losses returned are their
means over the ranks: the whole batch's. The explicit all-reduce stands
where DistributedDataParallel would: DDP wraps an nn.Module, and the
parameters here are a tree of leaf tensors.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch

from disn_tpu_torch import convert, parallel
from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config
from disn_tpu_torch.models import disn, posenet
from disn_tpu_torch.train import checkpoint

Params = dict[str, Any]


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Staircase exponential decay in units of samples, floored at
    cfg.lr_floor."""

    def schedule(step: int) -> float:
        k = math.floor(step * cfg.batch_size / cfg.lr_decay_step)
        return max(cfg.learning_rate * cfg.lr_decay_rate ** k, cfg.lr_floor)

    return schedule


def make_optimizer(cfg: Config, params: list[torch.Tensor]
                   ) -> torch.optim.Optimizer:
    """Adam (fused into one kernel on the card) or SGD with momentum, over
    `params` in the order the checkpoint names them. The learning rate is
    set before every step (TrainState.apply_gradients)."""
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum)
    fused = bool(params) and params[0].device.type == "cuda"
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, 0.999), eps=1e-8,
                            fused=fused or None)


@dataclasses.dataclass
class TrainState:
    """Step count, parameters and their optimizer. One counter serves as
    the step, Adam's count and the schedule's count, as they move together
    in the JAX package's TrainState."""

    step: int
    params: Params
    opt: torch.optim.Optimizer
    cfg: Config

    def apply_gradients(self) -> float:
        """One optimizer update from the parameters' .grad; returns the
        learning rate it used."""
        lr = lr_schedule(self.cfg)(self.step)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return lr

    def params_tree(self) -> Params:
        """The parameters as a tree of numpy arrays."""
        return _map(self.params, lambda t: t.detach().cpu().numpy())

    def state_tree(self) -> dict:
        """{"params", "opt_state", "step"} under the JAX package's names,
        numpy leaves: what a full-state checkpoint holds."""
        return {"params": self.params_tree(),
                "opt_state": convert.opt_state_to_reference(
                    self.opt, self.params, self.step),
                "step": np.asarray(self.step, np.int32)}

    def load_params(self, tree: Params) -> None:
        """Copy a param tree (numpy or tensor leaves, same paths and
        shapes) into the parameters in place."""
        flat = dict(checkpoint.leaves(tree))
        with torch.no_grad():
            for path, p in checkpoint.leaves(self.params):
                p.copy_(torch.as_tensor(flat[path]))

    def load_state_tree(self, tree: dict) -> None:
        """Resume from a full-state tree (``state_tree``'s form, or a JAX
        checkpoint's): parameters, optimizer moments and step."""
        step = int(np.asarray(tree["step"]))
        count = convert.opt_state_from_reference(self.opt, self.params,
                                                 tree["opt_state"])
        if count != step:
            raise ValueError(f"schedule count {count} != step {step}: the "
                             "port keeps one counter for both")
        self.load_params(tree["params"])
        self.step = step


def create_state(cfg: Config, seed: int = 0, params: Params | None = None,
                 device: str | torch.device | None = None,
                 init_fn: Callable[..., Params] = disn.init,
                 mesh: parallel.Mesh | None = None) -> TrainState:
    """A fresh TrainState on `device` (the GPU by default; it raises
    without one): `params` (copied, e.g. convert.params_from_jax of a JAX
    tree) or init_fn(cfg, seed=seed, device=device), the SDF net's
    disn.init by default (posenet.init for the camera net). With a `mesh`
    every rank takes the mesh's first rank's parameters (a broadcast)."""
    dev = device_mod.resolve(device)
    if params is None:
        params = init_fn(cfg, seed=seed, device=dev)

    def leaf(t):
        return torch.as_tensor(t).detach().to(dev, copy=True
                                              ).requires_grad_(True)

    params = _map(params, leaf)
    leaves = [p for _, p in checkpoint.leaves(params)]
    parallel.broadcast_(leaves, mesh)
    return TrainState(step=0, params=params,
                      opt=make_optimizer(cfg, leaves), cfg=cfg)


def _map(tree: Params, fn) -> Params:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def to_model_batch(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Loader keys (reference naming) -> model-forward keys."""
    out = {
        "img": batch["img"],
        "sample_pc": batch["sdf_pt"],
        "trans_mat": batch["trans_mat"],
    }
    if "sdf_pt_rot" in batch:
        out["sample_pc_rot"] = batch["sdf_pt_rot"]
    return out


def loss_fn(params: Params, batch: dict[str, torch.Tensor], cfg: Config
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    end_points = disn.apply(params, to_model_batch(batch), cfg, fold=True)
    gt = batch["sdf_val"] - cfg.iso_offset
    return disn.get_loss(end_points, gt, params, cfg)


def to_cam_batch(batch: dict) -> dict:
    """Loader keys -> the camera net's batch keys: the image's RGB, the
    SDF sample points, RT (the view's regress_mat), trans_mat and, when
    the loader shifted the image, shifts."""
    out = {"img": batch["img"][..., :3], "sample_pc": batch["sdf_pt"],
           "RT": batch["regress_mat"], "trans_mat": batch["trans_mat"]}
    if "shifts" in batch:
        out["shifts"] = batch["shifts"]
    return out


def cam_loss_fn(params: Params, batch: dict[str, torch.Tensor], cfg: Config,
                shards: int = 1
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The camera net's loss on a to_cam_batch batch that is one of
    `shards` equal shards of the whole batch."""
    end_points = posenet.apply(params, batch["img"], cfg)
    return posenet.get_loss(end_points, batch, params, cfg,
                            sum_scale=shards)


def compute_gradients(state: TrainState, batch: dict[str, torch.Tensor],
                      objective: Callable = loss_fn
                      ) -> dict[str, torch.Tensor]:
    """Forward and backward of `objective` (loss_fn, the SDF loss, by
    default): fills
    every parameter's .grad; returns the detached losses (0-d tensors on
    the device, not read here)."""
    state.opt.zero_grad(set_to_none=True)
    loss, losses = objective(state.params, batch, state.cfg)
    loss.backward()
    return {k: v.detach() for k, v in losses.items()}


def _on(batch: dict, dev: torch.device) -> dict[str, torch.Tensor]:
    """Batch arrays or tensors -> tensors on `dev` (no copy for those
    already there)."""
    return {k: torch.as_tensor(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(cfg: Config, device: str | torch.device | None = None,
                    objective: Callable = loss_fn,
                    mesh: parallel.Mesh | None = None):
    """SDF train step on `device` (the GPU by default; it raises without
    one): (state, batch) -> (state, losses). The batch is moved to the
    device unless it is there (PrefetchLoader puts it there). The state is
    updated in place; losses holds 0-d tensors on the device and the
    learning rate used (a float), so a caller that does not read them does
    not wait for the device.

    With a `mesh` the batch is this rank's shard: the gradients and the
    losses are averaged over the mesh's ranks before the update (see the
    module's docstring)."""
    dev = device_mod.resolve(device)

    def step(state: TrainState, batch: dict):
        if state.cfg != cfg:
            raise ValueError("the state was made for another Config")
        losses = compute_gradients(state, _on(batch, dev), objective)
        if mesh is not None and mesh.group is not None:
            parallel.all_reduce_mean_(
                [p.grad for _, p in checkpoint.leaves(state.params)
                 if p.grad is not None], mesh)
            losses = {k: v.clone() for k, v in losses.items()}
            parallel.all_reduce_mean_(list(losses.values()), mesh)
        losses["lr"] = state.apply_gradients()
        return state, losses

    return step


def make_cam_train_step(cfg: Config,
                        device: str | torch.device | None = None,
                        mesh: parallel.Mesh | None = None):
    """The camera net's train step, make_train_step's on cam_loss_fn: the
    batch has to_cam_batch's keys (img, sample_pc, RT, trans_mat, optional
    shifts); the state holds posenet params (create_state(init_fn=
    posenet.init)). With a `mesh` the loss's batch sums are scaled by the
    mesh's size, so that their mean over the ranks is the whole batch's."""
    objective = cam_loss_fn
    if mesh is not None and mesh.group is not None:
        objective = functools.partial(cam_loss_fn, shards=mesh.size)
    return make_train_step(cfg, device=device, objective=objective,
                           mesh=mesh)


def make_eval_step(cfg: Config, device: str | torch.device | None = None,
                   objective: Callable = loss_fn):
    """Metric-only step on `device`: (params, batch) -> losses, without
    gradients (the SDF loss by default, cam_loss_fn for the camera net)."""
    dev = device_mod.resolve(device)

    def step(params: Params, batch: dict):
        with torch.no_grad():
            return objective(params, _on(batch, dev), cfg)[1]

    return step
