"""Uneven-partitioned PS strategy.

Counterpart of ``autodist_tpu/strategy/uneven_partition_ps_strategy.py``:
as PartitionedPS, but the shard count is the first that does NOT divide
dim 0. The data axis's shards of such a variable are uneven, so its
storage is padded (``DistributedProgram.paddings``): each rank stores a
shard of the padded rows, and the step cuts the logical rows back out.
"""
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS


def get_uneven_num_shards(var, max_shards):
    """First shard count >= 2 that does not divide dim 0."""
    if not var.shape or var.shape[0] <= 1 or max_shards <= 1:
        return 1
    dim0 = var.shape[0]
    for i in range(2, min(dim0, max_shards) + 1):
        if dim0 % i > 0:
            return i
    return min(dim0, max_shards)


class UnevenPartitionedPS(PartitionedPS):
    """Dim-0 sharding with deliberately uneven shard sizes."""

    shards_for = staticmethod(get_uneven_num_shards)
