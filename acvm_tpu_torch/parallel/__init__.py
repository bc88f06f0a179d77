"""Scaling the batched solver over several devices and processes: meshes
(:mod:`.mesh`), ``torch.distributed`` glue (:mod:`.distributed`) and a local
launcher (:mod:`.launcher`)."""

from .mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    shard_batch,
    shard_bounds,
    shard_state,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "shard_bounds",
    "shard_state",
]
