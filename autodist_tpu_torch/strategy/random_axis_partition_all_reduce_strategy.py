"""Random-axis partitioned AllReduce strategy.

Counterpart of
``autodist_tpu/strategy/random_axis_partition_all_reduce_strategy.py``: as
PartitionedAR, but a dense variable is partitioned along a randomly chosen
axis (any axis with a divisor >= 2), from ``random.Random(seed)``, so one
seed makes the same choices in both packages. Sparse-access variables
take axis 0 (the gathered, vocabulary axis). With ``seed=None`` every
process would choose differently; strategy shipping (the chief builds,
the workers fetch) gives the whole job the chief's choices.
"""
import random

from autodist_tpu_torch.strategy.all_reduce_strategy import (_COMPRESSORS,
                                                              _SPECS)
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    add_ar_parts


def get_axis_shards(var, max_shards, rng):
    """(axis, num_shards): a random partitionable axis, its smallest
    divisor >= 2 as the shard count; (0, 1) when none."""
    candidates = []
    for axis, dim in enumerate(var.shape):
        if dim <= 1:
            continue
        for i in range(2, min(dim, max_shards) + 1):
            if dim % i == 0:
                candidates.append((axis, i))
                break
    if not candidates:
        return 0, 1
    if var.sparse_access:
        axis0 = [c for c in candidates if c[0] == 0]
        return axis0[0] if axis0 else (0, 1)
    return rng.choice(candidates)


class RandomAxisPartitionAR(StrategyBuilder):
    """Partition each variable along a randomly chosen axis, then
    all-reduce."""

    def __init__(self, chunk_size=128, seed=0):
        self._chunk_size = chunk_size
        self._spec = _SPECS["AUTO"]
        self._rng = random.Random(seed)

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        max_shards = max(1, len(resource_spec.accelerator_devices))
        counter = 0
        for var in graph_item.trainable_variables:
            node = strategy.proto.node_config.add(var_name=var.name)
            axis, num_shards = get_axis_shards(var, max_shards, self._rng)
            counter = add_ar_parts(node, var, axis, num_shards, self._spec,
                                   _COMPRESSORS["NoneCompressor"], counter,
                                   self._chunk_size)
        return strategy
