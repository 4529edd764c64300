"""Batched and sharded carving (counterpart of ``lqr_tpu.parallel``)."""

from .batch import (BatchCarver, extend_map_batched, materialize_batched,
                    materialize_all_batched, rigc_table)
from .sharding import (Mesh, make_mesh, make_process_mesh, shard_batch_state,
                       find_seam_sharded, sharded_seam_step)

__all__ = [
    "BatchCarver", "extend_map_batched", "materialize_batched",
    "materialize_all_batched", "rigc_table",
    "Mesh", "make_mesh", "make_process_mesh", "shard_batch_state",
    "find_seam_sharded", "sharded_seam_step",
]
