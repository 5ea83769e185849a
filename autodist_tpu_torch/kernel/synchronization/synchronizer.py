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

#: The axes whose groups hold the pieces of a split parameter (kind ``tp``).
PIECE_AXES = (const.MESH_AXIS_PIPELINE, const.MESH_AXIS_EXPERT,
              const.MESH_AXIS_MODEL)


class Synchronizer(ABC):
    """Lowered form of one strategy NodeConfig for one variable."""

    def __init__(self, var, node, mesh):
        self.var = var          # VariableItem
        self.node = node        # strategy_pb2.NodeConfig
        self.mesh = mesh
        self.pconfig = PartitionerConfig.from_string(node.partitioner)

    @classmethod
    def create(cls, var, node, mesh, devices_per_host=None):
        from autodist_tpu_torch.kernel.synchronization.\
            all_reduce_synchronizer import AllReduceSynchronizer
        from autodist_tpu_torch.kernel.synchronization.ps_synchronizer \
            import PSSynchronizer
        which = node.WhichOneof("synchronizer")
        if which == "ps_synchronizer":
            return PSSynchronizer(var, node, mesh)
        if which == "all_reduce_synchronizer" or which is None:
            return AllReduceSynchronizer(var, node, mesh,
                                         devices_per_host=devices_per_host)
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

    def piece_dims(self):
        """Every (piece axis, dim) pair of this variable: the ``pipe``,
        ``expert`` and ``model`` axes of more than one device its parameter
        spec splits, in the mesh's axis order, each with the dim it splits
        (a composed partitioner, ``"0:2:pipe,2:2:model"``, gives two)."""
        spec = self.param_spec()
        return tuple((axis, dim) for axis in self.mesh.axis_names
                     if axis in PIECE_AXES and self.mesh.shape[axis] > 1 and
                     (dim := axis_dim(spec, axis)) is not None)

    def kind(self, n):
        """(kind, dim): how the Runner lowers this variable on a data axis
        of ``n`` devices (``DistributedProgram.var_kinds``): ``stale``
        with staleness; ``tp`` where its parameter spec splits it over a
        ``model``, ``expert`` or ``pipe`` axis of more than one device
        (each rank of such a group stores its piece, the state spec is the
        param spec, and the gradient is averaged over the axes that do not
        split it), with the dim of its one piece axis, or every (piece
        axis, dim) pair (:meth:`piece_dims`) where two axes split it;
        ``fsdp`` along the dim it splits over the data axis; else ``ar``."""
        if self.staleness > 0:
            return ("stale", None)
        spec = self.param_spec()
        pairs = self.piece_dims()
        if pairs:
            if data_dim(spec) is not None:
                raise NotImplementedError(
                    f"{self.var.name} is split over both the "
                    f"{pairs[0][0]} and the data axis ({spec}): "
                    f"autodist_tpu_torch splits a parameter over one of "
                    f"them")
            return ("tp", pairs[0][1] if len(pairs) == 1 else pairs)
        if n > 1 and (dim := data_dim(spec)) is not None:
            return ("fsdp", dim)
        return ("ar", None)

    @property
    def staleness(self):
        return 0

    def init_sync_state(self, shape=None, device=None):
        """Per-variable auxiliary state (compressor residuals etc.) for a
        gradient of ``shape``: none by default."""
        return ()

    def sync_gradient(self, grad, sync_state, group, groups=None):
        """(mean of ``grad`` over ``group``, in place, and the sync state
        unchanged)."""
        return all_reduce_mean_(grad, group), sync_state
