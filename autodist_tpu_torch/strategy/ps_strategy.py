"""PS strategy: every variable synchronized through sharded (PS-style) state.

Counterpart of ``autodist_tpu/strategy/ps_strategy.py``, the JAX package's
default builder: every trainable variable gets a ``PSSynchronizer`` on the
data axis. The Runner lowers it as ZeRO-1 (gradient reduce-scattered onto
this rank's optimizer-state shard, shard-local update, parameter
all-gathered), or as bounded staleness when ``staleness > 0``.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.base import StrategyBuilder


def set_ps(node, local_proxy_variable, sync, staleness, gspmd_update):
    """Fill ``node``'s PS synchronizer on the data axis."""
    ps = node.ps_synchronizer
    ps.reduction_destination = const.MESH_AXIS_DATA
    ps.local_replication = local_proxy_variable
    ps.sync = sync
    ps.staleness = staleness
    ps.gspmd_update = gspmd_update


def add_parts(node, num_shards):
    """Partition ``node`` along dim 0 into ``num_shards`` parts, each with
    the node's PS synchronizer."""
    node.partitioner = f"0:{num_shards}"
    for i in range(num_shards):
        part = node.part_config.add(var_name=f"{node.var_name}/part_{i}")
        part.ps_synchronizer.CopyFrom(node.ps_synchronizer)


class PSBuilderBase(StrategyBuilder):
    """The PS options the PS-family builders share."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 gspmd_update=False):
        self._ps_options = (local_proxy_variable, sync, staleness,
                            gspmd_update)

    def _set_ps(self, node):
        set_ps(node, *self._ps_options)


class PS(PSBuilderBase):
    """All variables -> PSSynchronizer on the data axis."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 gspmd_update=False):
        if staleness > 0 and not sync:
            raise ValueError("staleness is a bounded-sync mode and requires "
                             "sync=True")
        super().__init__(local_proxy_variable, sync, staleness, gspmd_update)

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        for var in graph_item.trainable_variables:
            self._set_ps(strategy.proto.node_config.add(var_name=var.name))
        return strategy
