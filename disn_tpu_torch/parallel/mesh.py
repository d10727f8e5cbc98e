"""The (data, points) mesh of ranks (port of disn_tpu/parallel/mesh.py) over
torch.distributed.

The JAX package lays one 2D logical mesh over its devices: training shards
the batch on ``data`` (XLA all-reduces the gradients), dense and sparse
inference shard the query points on ``points`` with the image features
replicated, and the slabs or stripes are gathered at the end. Here a device
is a process (a rank) with its own card, and ``Mesh`` is the grid of ranks,
row-major as JAX lays out its devices, over a process group, with each
row's (``points``) and each column's (``data``) subgroup. What JAX's
sharding specs say becomes what each rank does with its share:

* ``replicated``: ``broadcast_`` / ``broadcast`` from the mesh's first rank;
* ``batch_sharding`` / ``shard_batch``: ``shard_batch`` keeps this rank's
  rows of a batch on the data axis;
* ``point_sharding``: ``point_slice`` is this rank's slice on the points
  axis;
* the gather of a sharded result: ``gather`` concatenates every rank's
  share in rank order, padded to equal lengths for ``all_gather``.

One process (no process group) is the 1x1 mesh; its collectives do
nothing. A mesh over a process group runs them whatever its size, so a
1-rank NCCL group goes through the same calls as a larger one.

Collectives keep to what both backends offer: gloo has no ReduceOp.AVG
(SUM, then a divide) and no all_gather of CUDA tensors, so on gloo every
collective goes through host copies; NCCL takes the card's tensors.

``init_from_env`` joins the process group that torchrun describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL with one card a
rank (it raises when the host has fewer cards than local ranks: no two NCCL
ranks share a card, and no rank moves to the CPU), gloo on the CPU. Without
WORLD_SIZE, or with WORLD_SIZE=1, it creates no process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from disn_tpu_torch import device as device_mod

DATA_AXIS = "data"
POINT_AXIS = "points"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A [data, points] grid of global ranks and this process's place in it.

    ``group`` spans the mesh (its group ranks are the mesh's row-major
    index: torch sorts a group's ranks, and the grid is laid out from
    ascending ranks), ``data_group`` is this rank's column (the ranks of
    its points index) and ``points_group`` its row. All three are None for
    the one-process mesh."""

    grid: np.ndarray
    rank: int
    group: Any = None
    data_group: Any = None
    points_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.grid.shape[0], POINT_AXIS: self.grid.shape[1]}

    @property
    def size(self) -> int:
        return int(self.grid.size)

    @property
    def coords(self) -> tuple[int, int]:
        """(data index, points index) of this rank."""
        i, j = np.argwhere(self.grid == self.rank)[0]
        return int(i), int(j)

    @property
    def index(self) -> int:
        """This rank's row-major position in the mesh."""
        i, j = self.coords
        return i * self.grid.shape[1] + j

    @property
    def lead(self) -> bool:
        """Whether this rank is the mesh's first (the one that writes)."""
        return self.rank == int(self.grid[0, 0])


def layout(ranks, data: int | None = None, points: int = 1) -> np.ndarray:
    """The [data, points] grid of `ranks`, row-major, as JAX's make_mesh
    reshapes its devices; `data` defaults to all ranks over `points`."""
    ranks = np.asarray(list(ranks), np.int64).reshape(-1)
    n = ranks.size
    if data is None:
        data = n // points
    if data * points != n:
        raise ValueError(f"mesh {data}x{points} != {n} ranks")
    return ranks.reshape(data, points)


def fitting_layout(batch_size: int, ranks) -> np.ndarray:
    """The largest data-parallel grid whose size divides the batch: the
    first gcd(batch_size, len(ranks)) ranks on the data axis."""
    ranks = list(ranks)
    n = math.gcd(batch_size, len(ranks))
    return layout(ranks[:n], data=n, points=1)


def _world_ranks(group) -> list[int]:
    if group is None:
        return list(range(dist.get_world_size()))
    return list(dist.get_process_group_ranks(group))


def _build(grid: np.ndarray) -> Mesh | None:
    """The mesh's groups. dist.new_group is collective over the default
    group: every process calls it for every group, in one order, including
    the processes the grid leaves out, which get None."""
    whole = dist.new_group(grid.reshape(-1).tolist())
    rows = [dist.new_group(r.tolist()) for r in grid]
    cols = [dist.new_group(c.tolist()) for c in grid.T]
    me = dist.get_rank()
    if me not in grid:
        return None
    i, j = np.argwhere(grid == me)[0]
    return Mesh(grid, me, whole, cols[j], rows[i])


def make_mesh(data: int | None = None, points: int = 1,
              group=None) -> Mesh:
    """A (data, points) mesh over the ranks of `group` (the default group
    when None; the one-process mesh without a process group). Defaults to
    all ranks on the data axis; raises ``mesh {d}x{p} != {n} ranks`` when
    the shape does not cover them."""
    if not dist.is_initialized():
        return Mesh(layout([0], data, points), 0)
    return _build(layout(_world_ranks(group), data, points))


def fitting_mesh(batch_size: int, group=None) -> Mesh | None:
    """The largest data-parallel mesh whose size divides the batch (a batch
    of 2 on 8 ranks trains on 2). A rank outside it gets None and takes no
    step, as JAX's fitting_mesh leaves devices out."""
    if not dist.is_initialized():
        return Mesh(fitting_layout(batch_size, [0]), 0)
    return _build(fitting_layout(batch_size, _world_ranks(group)))


def init_from_env(device: str | torch.device | None = None
                  ) -> torch.device:
    """Join torchrun's process group when WORLD_SIZE > 1 and return this
    rank's device: cuda:LOCAL_RANK over NCCL for a CUDA device, `device`
    over gloo otherwise. Without WORLD_SIZE, or with 1, it creates no
    process group and returns device.resolve(device)."""
    dev = device_mod.resolve(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return dev
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(
                f"local rank {local} needs cuda:{local}, but this host has "
                f"{cards} card(s): one NCCL rank a card")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    return dev


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Shares of a batch and of the points
# ---------------------------------------------------------------------------

def share(total: int, parts: int, k: int) -> tuple[int, int]:
    """[lo, hi) of part k when `total` items split into `parts` contiguous
    shares, the first total % parts one longer."""
    base, extra = divmod(total, parts)
    lo = k * base + min(k, extra)
    return lo, lo + base + (k < extra)


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """This rank's rows (axis 0) of every array of a batch on the data axis
    (the batch must divide over it)."""
    if mesh is None:
        return batch
    d = mesh.shape[DATA_AXIS]
    i = mesh.coords[0]
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % d:
            raise ValueError(f"{k}: batch {b} does not divide over {d} ranks")
        out[k] = v[i * (b // d):(i + 1) * (b // d)]
    return out


def point_slice(n: int, mesh: Mesh | None) -> slice:
    """This rank's slice of n points on the points axis (n must divide)."""
    if mesh is None:
        return slice(0, n)
    p = mesh.shape[POINT_AXIS]
    if n % p:
        raise ValueError(f"{n} points do not divide over {p} ranks")
    j = mesh.coords[1]
    return slice(j * (n // p), (j + 1) * (n // p))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _comm_device(group, dev: torch.device) -> torch.device:
    """Where a collective of `group` takes its tensors: the card on NCCL,
    the host on gloo (which gathers no CUDA tensor)."""
    if dist.get_backend(group) == "nccl":
        return dev
    return torch.device("cpu")


# dtypes a backend may not carry (NCCL has no int16, gloo no bool), sent as
# a wider type and cast back
_WIRE = {torch.int16: torch.int32, torch.bool: torch.uint8}


def _wire(t: torch.Tensor, cd: torch.device) -> torch.Tensor:
    return t.contiguous().to(cd, _WIRE.get(t.dtype, t.dtype))


def _src(mesh: Mesh) -> int:
    return int(mesh.grid[0, 0])


def _flat_per_dtype(tensors: list[torch.Tensor], group, collective) -> None:
    """Run `collective` in place on one flat buffer per dtype of `tensors`
    (on the group's communication device), then copy the buffers back."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            cd = _comm_device(group, ts[0].device)
            flat = torch.cat([t.reshape(-1) for t in ts]).to(cd)
            collective(flat)
            flat = flat.to(ts[0].device)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh | None,
                     group=None) -> None:
    """Average `tensors` in place over the ranks of `group` (the mesh's
    whole group by default): one flat buffer and one all_reduce (SUM, then
    a divide) per dtype, not one collective a tensor."""
    if mesh is None or mesh.group is None or not tensors:
        return
    group = mesh.group if group is None else group
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)

    _flat_per_dtype(tensors, group, mean)


def broadcast_(tensors: list[torch.Tensor], mesh: Mesh | None) -> None:
    """Overwrite `tensors` (the same shapes on every rank) in place with the
    mesh's first rank's: one flat buffer and one broadcast per dtype."""
    if mesh is None or mesh.group is None or not tensors:
        return
    _flat_per_dtype(tensors, mesh.group, lambda flat: dist.broadcast(
        flat, src=_src(mesh), group=mesh.group))


def broadcast(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mesh's first rank's tensor on every rank, whatever shape the
    others hold (their `t` gives the dtype and the device only)."""
    if mesh is None or mesh.group is None:
        return t
    cd = _comm_device(mesh.group, t.device)
    head = torch.zeros(8, dtype=torch.int64, device=cd)
    if mesh.lead:
        head[0] = t.dim()
        head[1:1 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    dist.broadcast(head, src=_src(mesh), group=mesh.group)
    shape = head[1:1 + int(head[0])].tolist()
    buf = (_wire(t, cd) if mesh.lead else
           torch.empty(shape, dtype=_WIRE.get(t.dtype, t.dtype), device=cd))
    dist.broadcast(buf, src=_src(mesh), group=mesh.group)
    return buf.to(t.device, t.dtype)


def gather(t: torch.Tensor, mesh: Mesh | None, group=None) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0 in rank order (the mesh's
    row-major order over its whole group, by default), on every rank. The
    lengths may differ: each share is padded to the longest for all_gather
    and cut back after it."""
    if mesh is None or mesh.group is None:
        return t
    group = mesh.group if group is None else group
    n = dist.get_world_size(group)
    cd = _comm_device(group, t.device)
    x = _wire(t, cd)
    mine = torch.tensor([x.shape[0]], dtype=torch.int64, device=cd)
    lens = [torch.zeros_like(mine) for _ in range(n)]
    dist.all_gather(lens, mine, group=group)
    lens = [int(v) for v in lens]
    longest = max(lens)
    if x.shape[0] < longest:
        pad = torch.zeros((longest - x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=cd)
        x = torch.cat([x, pad])
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:m] for p, m in zip(parts, lens)]).to(t.device,
                                                              t.dtype)
