"""Distributed execution: device meshes, sharded operators, collectives.

The reference has **no distributed capability** (SURVEY §5.8: no NCCL/MPI/
Gloo; OpenMP dropped in v0.5). This package supplies the device-native
parallelism axes instead:

  * **operator sharding** (tensor-parallel analog): row/block-partitioned
    operators across a mesh axis, each matvec a local SpMM plus
    collectives (`all_gather` or neighbor `ppermute` halo exchange);
  * **probe sharding** (data-parallel analog): probe columns split across a
    second mesh axis, estimator reductions as `psum`s;
  * **multi-process** entry via `jax.distributed.initialize` (the same
    program runs on one process driving several devices or on many).
"""

from .mesh import make_mesh, mesh_devices, initialize_distributed
from .sharded import (
	ShardedCSROperator,
	ShardedDenseOperator,
	ShardedBSROperator,
	ShardedDIAOperator,
	auto_shard_operator,
	shard_operator,
)

__all__ = [
	"make_mesh",
	"mesh_devices",
	"initialize_distributed",
	"ShardedCSROperator",
	"ShardedDenseOperator",
	"ShardedBSROperator",
	"ShardedDIAOperator",
	"auto_shard_operator",
	"shard_operator",
]
