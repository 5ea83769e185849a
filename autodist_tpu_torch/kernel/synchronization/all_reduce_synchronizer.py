"""AllReduce synchronizer lowering.

Counterpart of
``autodist_tpu/kernel/synchronization/all_reduce_synchronizer.py``: the
node's compressor wraps a mean all-reduce of the gradient over its reduce
group, and its ``group`` id lets the Runner reduce same-group gradients of
one stateless wire format as one flat bucket (``Runner.bucket_plan``).

``spec: DCN`` selects the two-level collectives (``hierarchical.py``):
full-precision reduce-scatter / all-gather on the intra-host leg, the
node's compressor naming the codec used only on the cross-host leg
(Horovod* -> bf16, Int8Compressor -> int8, Int8CompressorEF -> int8 with
error feedback on the shard). On one host it degenerates to the flat codec
path, bitwise. PowerSGD has no per-leg form (its wire is the factor pair),
so a DCN spec on it stays on the flat path.
"""
import numpy as np

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.synchronization import hierarchical
from autodist_tpu_torch.kernel.synchronization.compressor import Compressor
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.proto import strategy_pb2

_C = strategy_pb2.AllReduceSynchronizer.Compressor
_SPEC = strategy_pb2.AllReduceSynchronizer.Spec

# DCN-leg codec selected by the node's compressor when spec is DCN.
_HIER_CODECS = {_C.NoneCompressor: "f32",
                _C.HorovodCompressor: "bf16",
                _C.HorovodCompressorEF: "bf16",
                _C.Int8Compressor: "int8",
                _C.Int8CompressorEF: "int8ef"}


def hier_codec(node):
    """The DCN codec an all-reduce node selects (None: the flat path)."""
    ar = node.all_reduce_synchronizer
    if ar.spec != _SPEC.DCN:
        return None
    return _HIER_CODECS.get(ar.compressor)


class AllReduceSynchronizer(Synchronizer):

    def __init__(self, var, node, mesh, devices_per_host=None):
        super().__init__(var, node, mesh)
        self.spec = node.all_reduce_synchronizer.spec
        self.group = node.all_reduce_synchronizer.group
        self.compressor_kind = node.all_reduce_synchronizer.compressor
        self.compressor = Compressor.create(self.compressor_kind, var.name)
        self.devices_per_host = devices_per_host
        self.hier_codec = hier_codec(node)

    @property
    def hierarchical(self):
        return self.hier_codec is not None

    def _legs(self):
        world = int(self.mesh.shape.get(const.MESH_AXIS_DATA, 1))
        return hierarchical.resolve_legs(world, self.devices_per_host)

    @property
    def needs_explicit_path(self):
        return self.compressor_kind != _C.NoneCompressor or self.hierarchical

    @property
    def fusable(self):
        """Eligible for bucketed (fused) reduction with same-group variables
        (stateless wire formats only; EF / PowerSGD carry per-variable
        state)."""
        if self.hierarchical:
            return self.hier_codec in ("f32", "bf16", "int8")
        return self.compressor_kind in (_C.NoneCompressor,
                                        _C.HorovodCompressor,
                                        _C.Int8Compressor)

    def init_sync_state(self, shape=None, device=None):
        """This rank's sync state for a gradient of ``shape`` (the stored
        piece's; default the variable's): the hierarchical EF residual on
        the DCN shard, else the compressor's state."""
        shape = tuple(self.var.shape if shape is None else shape)
        dtype = self.var.dtype
        if self.hierarchical:
            d, h = self._legs()
            n = int(np.prod(shape)) if shape else 1
            return hierarchical.init_hier_state(n, d, h, self.hier_codec,
                                                dtype, device)
        return self.compressor.init_state(shape, dtype, device)

    def sync_gradient(self, grad, sync_state, group, groups=None):
        """(mean of ``grad`` over ``group``, new sync state); ``groups``
        is this rank's (ici, dcn) pair for the hierarchical legs."""
        if self.hierarchical:
            return hierarchical.hier_mean(
                grad, group, codec=self.hier_codec,
                devices_per_host=self.devices_per_host, state=sync_state,
                groups=groups)
        return self.compressor.reduce(grad, sync_state, group)
