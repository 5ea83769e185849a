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
                                                   PartitionSpec,
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
        which = node.WhichOneof("synchronizer")
        if which == "ps_synchronizer":
            raise NotImplementedError(
                f"{var.name}: the PS synchronizer is not ported to "
                f"autodist_tpu_torch yet (ROADMAP.md, Queue A); use the "
                f"AllReduce strategy")
        if which == "all_reduce_synchronizer" or which is None:
            return AllReduceSynchronizer(var, node, mesh)
        raise ValueError(f"unknown synchronizer for {var.name}")

    def _partition_mesh_axis(self):
        """Mesh axis carrying parameter shards: 'model' when present and
        larger than 1, else 'data'."""
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
