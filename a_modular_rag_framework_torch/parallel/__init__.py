"""Index sharding and the sharded train step on a single-controller device
mesh (port of ``a_modular_rag_framework_tpu/parallel/``)."""
from .collectives import all_gather, all_reduce_max, all_reduce_sum
from .mesh import (DeviceMesh, PartitionSpec, build_mesh, mesh_devices,
                   mesh_from_settings, visible_devices)
from .sharded import (ShardedRows, shard_corpus_rows, shard_splade_postings,
                      sharded_dense_topk, sharded_splade_topk)
from .sharded_engine import ShardedDenseEngine
from .sharded_hybrid import (ShardedHybridEngine, dryrun_check,
                             shard_hybrid_arrays)

__all__ = ["DeviceMesh", "PartitionSpec", "ShardedDenseEngine",
           "ShardedHybridEngine", "ShardedRows", "all_gather",
           "all_reduce_max", "all_reduce_sum", "build_mesh", "dryrun_check",
           "mesh_devices", "mesh_from_settings",
           "shard_corpus_rows", "shard_hybrid_arrays",
           "shard_splade_postings", "sharded_dense_topk",
           "sharded_splade_topk", "visible_devices"]
