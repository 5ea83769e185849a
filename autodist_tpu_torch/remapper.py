"""Remapper: host data -> tensors on the program's mesh.

Counterpart of ``autodist_tpu/remapper.py``: ``shard_batch`` splits the
batch dimension over the data axis (with the same divisibility error) and
``place_params`` puts a parameter tree on the mesh once. This slice
places on one device; splitting over several comes with the training
slice's ``torch.distributed`` world.
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
        """The device of a one-device mesh."""
        if self._mesh.size != 1:
            raise NotImplementedError(
                f"feeding a {self._mesh.size}-device mesh needs "
                f"torch.distributed, which lands with the training slice")
        return self._mesh.devices.flat[0]

    def shard_batch(self, batch, non_blocking=False):
        """Put a host batch tree on the mesh, dim 0 over the data axis.

        The batch dimension must divide by the data-axis size. A leaf
        already on the target device is handed back untouched.
        ``non_blocking=True`` stages CPU leaves in pinned memory and copies
        asynchronously on the current stream; the caller orders the
        consumer after it (``DevicePrefetcher`` records an event).
        """
        n = self._program.data_axis_size
        leaves, treedef = flatten(batch)
        specs, _ = flatten(self._program.batch_specs(batch))
        for leaf, spec in zip(leaves, specs):
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else np.shape(leaf)
            if shape and spec and spec[0] == const.MESH_AXIS_DATA and \
                    shape[0] % n != 0:
                raise ValueError(f"global batch {shape[0]} not divisible by "
                                 f"data-axis size {n}")
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

    def place_params(self, params, placements=None):
        """Place a parameter tree once (the serve path's placement: every
        dispatch reads these tensors, nothing writes them). ``placements``
        overrides the program's ``param_placements()``."""
        if placements is None:
            placements = self._program.param_placements()
        leaves, treedef = flatten(params)
        devices, _ = flatten(placements)
        return unflatten(treedef, [torch.as_tensor(l, device=d)
                                   for l, d in zip(leaves, devices)])

    def fetch(self, value):
        """Bring a result tree to host memory."""
        leaves, treedef = flatten(value)
        return unflatten(treedef, [l.detach().cpu()
                                   if isinstance(l, torch.Tensor) else l
                                   for l in leaves])
