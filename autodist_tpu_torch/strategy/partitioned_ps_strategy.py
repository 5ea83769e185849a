"""Partitioned PS strategy: shard the parameters themselves, not just state.

Counterpart of ``autodist_tpu/strategy/partitioned_ps_strategy.py``: each
variable whose dim 0 has a divisor of at least 2 (capped by the device
count) is partitioned along dim 0; the Runner stores only this rank's
shard, all-gathers it for the forward and reduce-scatters its gradient
(kind ``fsdp``). The rest use plain PS.
"""
from autodist_tpu_torch.strategy.ps_strategy import PSBuilderBase, add_parts


def get_num_shards(var, max_shards):
    """Smallest divisor >= 2 of dim 0, capped by ``max_shards``; 1 when the
    variable cannot be partitioned."""
    if not var.shape or var.shape[0] <= 1 or max_shards <= 1:
        return 1
    dim0 = var.shape[0]
    for i in range(2, min(dim0, max_shards) + 1):
        if dim0 % i == 0:
            return i
    return 1


class PartitionedPS(PSBuilderBase):
    """Every partitionable variable is dim-0 sharded; the rest use PS."""

    shards_for = staticmethod(get_num_shards)

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        max_shards = max(1, len(resource_spec.accelerator_devices))
        for var in graph_item.trainable_variables:
            node = strategy.proto.node_config.add(var_name=var.name)
            self._set_ps(node)
            num_shards = self.shards_for(var, max_shards)
            if num_shards > 1:
                add_parts(node, num_shards)
        return strategy
