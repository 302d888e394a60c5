"""Mesh execution: shards on devices, hash-shuffle exchange, mesh joins.

Counterpart of `sigmod2018_tpu/parallel/`: parallel/mesh.py (the mesh and
row-sharded columns), parallel/collectives.py (the collectives of
`shard_map`), dist.py (the shuffle, broadcast and skew-split join
programs), dist_engine.py and dist_compiled.py (the operator and
whole-query engines on a mesh, S18_MESH > 1) and multihost.py.
"""

from .dist import (
    AXIS,
    exchange_multi,
    exchange,
    local_join_checksum,
    make_dist_checksum,
    make_dist_join_checksum,
    make_dist_join_checksum_skew,
    make_exchange_counts,
    make_mesh,
    partition_for_exchange,
    row_sharding,
)

from .multihost import flat_mesh_dcn_last, hier_mesh, init_distributed

__all__ = [
    "AXIS",
    "exchange_multi",
    "flat_mesh_dcn_last",
    "hier_mesh",
    "init_distributed",
    "exchange",
    "local_join_checksum",
    "make_dist_checksum",
    "make_dist_join_checksum",
    "make_dist_join_checksum_skew",
    "make_exchange_counts",
    "make_mesh",
    "partition_for_exchange",
    "row_sharding",
]
