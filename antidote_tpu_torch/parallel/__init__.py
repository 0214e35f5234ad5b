"""The mesh serving plane: tables placed over a list of devices."""

from antidote_tpu_torch.parallel.mesh import MeshServingPlane
from antidote_tpu_torch.parallel.spmd import (
    SHARD_AXIS,
    make_mesh,
    shard_axis_sharding,
    sharded_step_fn,
)

__all__ = [
    "MeshServingPlane",
    "SHARD_AXIS",
    "make_mesh",
    "shard_axis_sharding",
    "sharded_step_fn",
]
