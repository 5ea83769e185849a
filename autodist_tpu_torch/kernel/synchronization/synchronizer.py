"""Synchronizer base: per-variable lowering of a strategy node config.

Counterpart of ``autodist_tpu/kernel/synchronization/synchronizer.py``.
Each synchronizer contributes the variable's placement specs (parameter,
optimizer state, gradient; the JAX package's GSPMD path) and
``sync_gradient``, the cross-replica reduction of its gradient over the
data axis's process group (the JAX package's explicit path, which in the
port is the only path: PyTorch inserts no collectives of its own).
"""
from abc import ABC

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.partitioner import (PartitionerConfig,
                                                   PartitionSpec, axis_dim,
                                                   data_dim,
                                                   param_partition_spec)
from autodist_tpu_torch.kernel.synchronization.compressor import \
    all_reduce_mean_


class Synchronizer(ABC):
    """Lowered form of one strategy NodeConfig for one variable."""

    def __init__(self, var, node, mesh):
        self.var = var          # VariableItem
        self.node = node        # strategy_pb2.NodeConfig
        self.mesh = mesh
        self.pconfig = PartitionerConfig.from_string(node.partitioner)

    @classmethod
    def create(cls, var, node, mesh):
        from autodist_tpu_torch.kernel.synchronization.\
            all_reduce_synchronizer import AllReduceSynchronizer
        from autodist_tpu_torch.kernel.synchronization.ps_synchronizer \
            import PSSynchronizer
        which = node.WhichOneof("synchronizer")
        if which == "ps_synchronizer":
            return PSSynchronizer(var, node, mesh)
        if which == "all_reduce_synchronizer" or which is None:
            return AllReduceSynchronizer(var, node, mesh)
        raise ValueError(f"unknown synchronizer for {var.name}")

    def _partition_mesh_axis(self):
        """Mesh axis carrying parameter shards: 'model' when present and
        larger than 1, else 'data'. (The expert overlay names its axis in
        each partitioner: ``"<dim>:<size>:expert"``.)"""
        if self.mesh.shape.get(const.MESH_AXIS_MODEL, 1) > 1:
            return const.MESH_AXIS_MODEL
        return const.MESH_AXIS_DATA

    def param_spec(self):
        """PartitionSpec of the parameter itself."""
        if self.pconfig.active:
            axis = self.pconfig.mesh_axis or self._partition_mesh_axis()
            for name in (axis,) + tuple(
                    m for _a, _n, m in self.pconfig.extras if m):
                if name not in self.mesh.axis_names:
                    raise ValueError(
                        f"strategy partitions {self.var.name} over mesh "
                        f"axis '{name}', but the built mesh has axes "
                        f"{tuple(self.mesh.axis_names)}")
            return param_partition_spec(self.var, self.pconfig, axis,
                                        self.mesh.shape[axis],
                                        mesh_sizes=dict(self.mesh.shape))
        return PartitionSpec()

    def state_spec(self):
        """PartitionSpec of the variable's optimizer state."""
        return self.param_spec()

    def grad_spec(self):
        """Placement of the gradient before the update."""
        return self.state_spec()

    @property
    def needs_explicit_path(self):
        return False

    def kind(self, n):
        """(kind, dim): how the Runner lowers this variable on a data axis
        of ``n`` devices (``DistributedProgram.var_kinds``): ``stale``
        with staleness; ``tp`` along the dim its parameter spec splits
        over a ``model``, ``expert`` or ``pipe`` axis of more than one
        device (each rank of such a group stores its piece, the state spec
        is the param spec, and the gradient is averaged over the data group
        only); ``fsdp`` along the dim it splits over the data axis; else
        ``ar``."""
        if self.staleness > 0:
            return ("stale", None)
        spec = self.param_spec()
        for axis in (const.MESH_AXIS_MODEL, const.MESH_AXIS_EXPERT,
                     const.MESH_AXIS_PIPELINE):
            if self.mesh.shape.get(axis, 1) > 1 and \
                    (dim := axis_dim(spec, axis)) is not None:
                if data_dim(spec) is not None:
                    raise NotImplementedError(
                        f"{self.var.name} is split over both the {axis} "
                        f"and the data axis ({spec}): autodist_tpu_torch "
                        f"splits a parameter over one of them")
                return ("tp", dim)
        if n > 1 and (dim := data_dim(spec)) is not None:
            return ("fsdp", dim)
        return ("ar", None)

    @property
    def staleness(self):
        return 0

    def init_sync_state(self):
        """Per-variable auxiliary state (compressor residuals etc.): none,
        since no stateful compressor is ported yet."""
        return ()

    def sync_gradient(self, grad, group):
        """Mean of ``grad`` over ``group``, in place; returns ``grad``."""
        return all_reduce_mean_(grad, group)
