"""PS synchronizer lowering: sharded-state synchronization over the data axis.

Counterpart of ``autodist_tpu/kernel/synchronization/ps_synchronizer.py``.
A parameter server's mechanisms map onto collectives over the data axis's
process group (the Runner lowers them, ``runner.py``):

* the variable's update placed on a server -> the optimizer state sharded
  over the reduction axis (ZeRO-1, kind ``zero1``), or the parameter
  itself when the strategy partitions it (kind ``fsdp``); the update runs
  on this rank's shard only;
* the gradient accumulator -> ``reduce_scatter_tensor`` of the gradient
  onto the state shard, then ``all_gather_into_tensor`` of the updated
  parameter;
* bounded staleness ``s`` -> local updates, the parameter averaged over
  the data group after every step ``t`` with ``t % (s + 1) == s`` (kind
  ``stale``); ``sync=False`` lowers to ``s = 1``;
* the proxy variable (``local_replication``) -> kept as metadata: every
  rank reads its own replica anyway.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.partitioner import (
    choose_state_sharding_spec, data_dim)
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.utils import logging


class PSSynchronizer(Synchronizer):

    # A PS variable whose state replicates (too small to shard) reduces as
    # a plain mean; such variables fuse into one bucket per dtype.
    fusable = True
    group = -1

    def __init__(self, var, node, mesh):
        super().__init__(var, node, mesh)
        cfg = node.ps_synchronizer
        self.reduction_axis = cfg.reduction_destination or \
            const.MESH_AXIS_DATA
        self.local_replication = cfg.local_replication
        self.sync = cfg.sync
        self.gspmd_update = cfg.gspmd_update
        self._staleness = cfg.staleness
        if not cfg.sync and self._staleness == 0:
            # Asynchronous PS has no unbounded lowering in a program whose
            # ranks step together: the tightest bounded contract instead.
            logging.info("PS(sync=False) on %s: lowered to bounded "
                         "staleness s=1 (local SGD)", var.name)
            self._staleness = 1

    @property
    def staleness(self):
        return self._staleness

    def _partition_mesh_axis(self):
        """A partitioned PS variable shards over its reduction axis (its
        gradient reduce-scatters to the shard owners); an explicit
        ``pconfig.mesh_axis`` still wins."""
        return self.reduction_axis

    @property
    def needs_explicit_path(self):
        """The reduce-scatter / shard-local update / all-gather lowering
        (or staleness); ``gspmd_update`` opts out of it, which the port
        lowers as the replicated all-reduce update (any optimizer)."""
        if self._staleness > 0:
            return True
        if self.gspmd_update:
            return False
        return self.mesh.shape.get(self.reduction_axis, 1) > 1

    def kind(self, n):
        """``stale`` and ``tp`` as the base class decides; else ``ar`` with
        ``gspmd_update``; ``zero1`` along the dim its state spec splits
        over the data axis where the parameter stays whole. A partitioned
        (``tp``) PS variable's state is its param spec: no ZeRO-1 split
        over ``data`` (``state_spec``)."""
        kind = super().kind(n)
        if kind[0] in ("stale", "tp"):
            return kind
        if self.gspmd_update:
            return ("ar", None)
        if kind[0] == "ar" and n > 1 and \
                (dim := data_dim(self.state_spec())) is not None:
            return ("zero1", dim)
        return kind

    def state_spec(self):
        if self.pconfig.active:
            return self.param_spec()
        axis_size = self.mesh.shape.get(self.reduction_axis, 1)
        if axis_size <= 1:
            return self.param_spec()
        return choose_state_sharding_spec(self.var, self.reduction_axis,
                                          axis_size)

    def grad_spec(self):
        """The gradient lands on the state's sharding: reduce-scattered."""
        return self.state_spec()
