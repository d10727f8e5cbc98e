"""Multi-rank runs of the port (port of disn_tpu/parallel) over
torch.distributed: the (data, points) mesh of ranks, its shares of a batch
and of the points, and its collectives."""
from disn_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, POINT_AXIS, Mesh, all_reduce_mean_, broadcast, broadcast_,
    fitting_layout, fitting_mesh, gather, init_from_env, layout, make_mesh,
    point_slice, shard_batch, share, shutdown,
)
