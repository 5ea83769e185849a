"""Remapper: host data -> tensors on this process's device of the mesh.

Counterpart of ``autodist_tpu/remapper.py``. ``shard_batch`` follows the
JAX package's multi-process contract (``remapper.py:152-178``): each
process passes its own process-local batch, the global batch is local x
the processes the mesh spans, and it must divide by the data-axis size
(the same error). One process drives one device, so the local batch goes
to this process's device whole. ``place_params`` puts a parameter tree on
that device once.
"""
import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.utils.tree import flatten, unflatten


class Remapper:
    """Feeds host batches onto the mesh according to a DistributedProgram."""

    def __init__(self, program):
        self._program = program
        self._mesh = program.mesh

    @property
    def device(self):
        """This process's device: its rank's on a rank mesh, the only one
        of a one-device local mesh."""
        return self._mesh.local_device

    def shard_batch(self, batch, non_blocking=False):
        """Put this process's batch tree on its device; dim 0 is this
        process's share of the data axis.

        The global batch (local rows x processes) must divide by the
        data-axis size. A leaf already on the target device is handed back
        untouched. ``non_blocking=True`` stages CPU leaves in pinned memory
        and copies asynchronously on the current stream; the caller orders
        the consumer after it (``DevicePrefetcher`` records an event).
        """
        n = self._program.data_axis_size
        leaves, treedef = flatten(batch)
        specs, _ = flatten(self._program.batch_specs(batch))
        for leaf, spec in zip(leaves, specs):
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if shape and spec and spec[0] == const.MESH_AXIS_DATA:
                total = shape[0] * self._mesh.process_count
                if total % n != 0:
                    raise ValueError(f"global batch {total} not divisible "
                                     f"by data-axis size {n}")
        device = self.device

        def put(leaf):
            t = torch.as_tensor(leaf)
            if t.device == device:
                return t
            if device.type == "cuda" and non_blocking and \
                    t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)
        return unflatten(treedef, [put(l) for l in leaves])

    def place_params(self, params, placements=None, copy=False):
        """Place a parameter tree once. ``placements`` overrides the
        program's ``param_placements()``. Serving reads the placed tensors
        and never writes them; training updates its copy in place, so it
        asks for ``copy=True`` and leaves the captured tree untouched."""
        if placements is None:
            placements = self._program.param_placements()
        leaves, treedef = flatten(params)
        devices, _ = flatten(placements)
        return unflatten(treedef, [
            torch.as_tensor(l).detach().to(d, copy=True) if copy
            else torch.as_tensor(l, device=d)
            for l, d in zip(leaves, devices)])

    def fetch(self, value):
        """Bring a result tree to host memory."""
        leaves, treedef = flatten(value)
        return unflatten(treedef, [l.detach().cpu()
                                   if isinstance(l, torch.Tensor) else l
                                   for l in leaves])
