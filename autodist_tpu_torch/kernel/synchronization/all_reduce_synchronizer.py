"""AllReduce synchronizer lowering.

Counterpart of
``autodist_tpu/kernel/synchronization/all_reduce_synchronizer.py:45-93``:
the node's compressor wraps a mean all-reduce of the gradient over the
data axis's process group, and its ``group`` id lets the Runner reduce
same-group gradients as one flat bucket (:func:`reduce_bucket`).
``spec: DCN`` (the hierarchical two-level collectives) is not ported yet.
"""
import torch

from autodist_tpu_torch.kernel.synchronization.compressor import (
    Compressor, all_reduce_mean_)
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.proto import strategy_pb2

_C = strategy_pb2.AllReduceSynchronizer.Compressor
_SPEC = strategy_pb2.AllReduceSynchronizer.Spec


def reduce_bucket(grads, group):
    """Mean-reduce same-dtype gradients as one flat buffer over ``group``
    (one collective for the bucket) and write the means back in place."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_mean_(flat, group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    return grads


class AllReduceSynchronizer(Synchronizer):

    def __init__(self, var, node, mesh):
        super().__init__(var, node, mesh)
        self.spec = node.all_reduce_synchronizer.spec
        self.group = node.all_reduce_synchronizer.group
        self.compressor_kind = node.all_reduce_synchronizer.compressor
        if self.spec == _SPEC.DCN:
            raise NotImplementedError(
                f"{var.name}: all_reduce_spec DCN (hierarchical collectives) "
                f"is not ported to autodist_tpu_torch yet (ROADMAP.md, "
                f"Queue A); use AUTO or ICI")
        self.compressor = Compressor.create(self.compressor_kind, var.name)

    @property
    def needs_explicit_path(self):
        return self.compressor_kind != _C.NoneCompressor

    @property
    def fusable(self):
        """Eligible for bucketed (fused) reduction with same-group variables:
        the one wire format that can be built, ``NoneCompressor``."""
        return self.compressor_kind == _C.NoneCompressor

    def sync_gradient(self, grad, group):
        return self.compressor.reduce(grad, group)
