"""Partitioned AllReduce strategy.

Counterpart of ``autodist_tpu/strategy/partitioned_all_reduce_strategy.py``:
each variable is partitioned along dim 0 (smallest divisor, as
PartitionedPS) and each part all-reduced, fusion groups assigned per part.
Over a data axis of more than one rank the Runner stores each rank's shard
and reduce-scatters its gradient (kind ``fsdp``).
"""
from autodist_tpu_torch.strategy.all_reduce_strategy import (_COMPRESSORS,
                                                              _SPECS)
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.partitioned_ps_strategy import get_num_shards


def add_ar_parts(node, var, axis, num_shards, spec, compressor, counter,
                 chunk_size):
    """Fill ``node``'s all-reduce synchronizer and, for ``num_shards`` > 1,
    its parts along ``axis``; returns the updated part counter (one fusion
    slot per part, or one for an unpartitioned variable)."""
    node.all_reduce_synchronizer.spec = spec
    node.all_reduce_synchronizer.compressor = compressor
    node.all_reduce_synchronizer.group = counter // chunk_size
    if num_shards <= 1:
        return counter + 1
    node.partitioner = f"{axis}:{num_shards}"
    for i in range(num_shards):
        part = node.part_config.add(var_name=f"{var.name}/part_{i}")
        part.all_reduce_synchronizer.spec = spec
        part.all_reduce_synchronizer.compressor = compressor
        part.all_reduce_synchronizer.group = counter // chunk_size
        counter += 1
    return counter


class PartitionedAR(StrategyBuilder):
    """Dim-0 partitioning + per-part all-reduce."""

    def __init__(self, chunk_size=128, all_reduce_spec="AUTO",
                 compressor="NoneCompressor"):
        self._chunk_size = chunk_size
        self._spec = _SPECS[all_reduce_spec]
        self._compressor = _COMPRESSORS[compressor]

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        max_shards = max(1, len(resource_spec.accelerator_devices))
        counter = 0
        for var in graph_item.trainable_variables:
            node = strategy.proto.node_config.add(var_name=var.name)
            counter = add_ar_parts(node, var, 0, get_num_shards(
                var, max_shards), self._spec, self._compressor, counter,
                self._chunk_size)
        return strategy
