"""Load-balanced PS strategy.

Counterpart of ``autodist_tpu/strategy/ps_lb_strategy.py``: sharded state
spreads evenly over the data axis by construction, so the balancing
decision left is which variables are worth sharding. Variables of at
least ``shard_threshold_bytes`` go to PS (sharded state), the rest to the
all-reduce (replicated state); ``loads`` records the bytes of state each
device hosts.
"""
from autodist_tpu_torch.strategy.ps_strategy import PSBuilderBase

#: Variables smaller than this stay replicated (AllReduce): sharding a few
#: KB of state costs more in collective latency than it saves.
DEFAULT_SHARD_THRESHOLD_BYTES = 256 * 1024


def byte_size_load_fn(var):
    """Cost of hosting one variable's state, in bytes."""
    if any(s is None for s in var.shape):
        raise ValueError(f"Shape of variable {var.name} is not fully defined")
    return var.size_bytes


class PSLoadBalancing(PSBuilderBase):
    """Shard large variables' state; small ones ride the all-reduce."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 gspmd_update=False,
                 shard_threshold_bytes=DEFAULT_SHARD_THRESHOLD_BYTES):
        super().__init__(local_proxy_variable, sync, staleness, gspmd_update)
        self._shard_threshold_bytes = shard_threshold_bytes
        self.loads = {}  # device index -> bytes of state it hosts

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        n = max(1, len(resource_spec.accelerator_devices))
        self.loads = {i: 0.0 for i in range(n)}
        for var in graph_item.trainable_variables:
            load = byte_size_load_fn(var)
            node = strategy.proto.node_config.add(var_name=var.name)
            if load >= self._shard_threshold_bytes:
                self._set_ps(node)
                share = load / n  # sharded state spreads evenly
            else:
                node.all_reduce_synchronizer.spec = 0  # AUTO
                node.all_reduce_synchronizer.group = 0
                share = load      # a replicated update on every device
            for i in self.loads:
                self.loads[i] += share
        return strategy
