"""Distributed layer: sharding rules and sharded SpMV over a device mesh
(port of ``repro.dist``).

``sharding`` — config+mesh partition rules for params/batches/caches
               (specs as tuples).
``mesh``     — ``DataMesh`` / ``make_data_mesh``: a 1-D ``("data",)`` axis
               of explicit torch devices (several shards may share one).
``spmv``     — row/column partitioning of a SparseMatrix over the ``data``
               axis and per-shard execution of per-family stacked operands.
``search``   — per-shard AlphaSparse search (each partition gets its own
               machine-designed format).
``collectives`` — the sharded train step's collectives over a mesh of
               processes (autograd Functions) and ``Layout``, which
               applies them to a state laid out by ``param_specs``.
"""
from .sharding import (ShardingRules, batch_specs, cache_specs, dp_axes,  # noqa: F401
                       param_specs)
from .mesh import DataMesh, make_data_mesh  # noqa: F401
from .spmv import (RowShard, ShardedSpmvProgram, partition_matrix,  # noqa: F401
                   shard_map_spmv)
from .search import ShardedSearchConfig, ShardedSearchResult, dist_search  # noqa: F401

__all__ = ["ShardingRules", "batch_specs", "cache_specs", "dp_axes",
           "param_specs", "DataMesh", "make_data_mesh", "RowShard", "ShardedSpmvProgram",
           "partition_matrix", "shard_map_spmv", "ShardedSearchConfig",
           "ShardedSearchResult", "dist_search"]
