"""Gradient compressors: the wire format of one gradient's mean-reduction.

Counterpart of ``autodist_tpu/kernel/synchronization/compressor.py``:
``Compressor`` wraps the mean all-reduce of one gradient over a process
group, ``reduced = decompress(all_reduce(compress(grad)))``. Ported: the base, ``create`` and ``NoneCompressor``
(the identity wire format). ``create`` refuses every other kind, so an
``AllReduce(compressor=...)`` strategy fails when its program is built,
not silently at the first step (ROADMAP.md, Queue A).
"""
from abc import ABC, abstractmethod

import torch.distributed as dist

from autodist_tpu_torch.proto import strategy_pb2

_C = strategy_pb2.AllReduceSynchronizer.Compressor


def all_reduce_mean_(tensor, group):
    """Mean of ``tensor`` over ``group``, in place (sum, then divide by
    the group's size)."""
    dist.all_reduce(tensor, group=group)
    tensor.div_(dist.get_world_size(group))
    return tensor


class Compressor(ABC):
    """Wraps the mean all-reduce of one gradient over a process group."""

    def __init__(self, var_name=""):
        self.var_name = var_name

    @abstractmethod
    def reduce(self, grad, group):
        """Return the mean-reduced gradient."""

    @staticmethod
    def create(kind, var_name=""):
        """Name/enum-based factory; only ``NoneCompressor`` is ported."""
        if isinstance(kind, str):
            kind = _C.Value(kind)
        if kind == _C.NoneCompressor:
            return NoneCompressor(var_name)
        raise NotImplementedError(
            f"compressor {_C.Name(kind)} is not ported to autodist_tpu_torch "
            f"yet (ROADMAP.md, Queue A); use AllReduce(compressor="
            f"'NoneCompressor')")


class NoneCompressor(Compressor):
    """Identity wire format: a plain mean all-reduce, in place."""

    def reduce(self, grad, group):
        return all_reduce_mean_(grad, group)
