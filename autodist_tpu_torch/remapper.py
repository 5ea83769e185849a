"""Remapper: host data -> tensors on this process's device of the mesh.

Counterpart of ``autodist_tpu/remapper.py``. ``shard_batch`` follows the
JAX package's multi-process contract (``remapper.py:152-178``): each
process passes its own process-local batch, the global batch is local x
the processes the mesh spans, and it must divide by the data-axis size
(the same error); ``shard_block`` does the same for the K-stacked blocks
of the fused multi-step dispatch. One process drives one device, so the
local batch goes to this process's device whole. ``place_params`` puts a
parameter tree on that device once, at its stored layout (uneven dims
padded, and a parameter split over the data axis or a piece axis cut to
this process's piece, over both axes where two split it;
``autodist_tpu/remapper.py:290``); ``fetch`` brings results back
through pinned host memory.
"""
import types

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
        the consumer after it (``DevicePrefetcher`` records an event); a
        leaf already in pinned memory (a CUDA loader's staging buffer) is
        copied from where it is.
        """
        self._check_rows(batch, batch)
        return self._put(batch, non_blocking)

    def shard_local_batch(self, batch, non_blocking=False):
        """Per-host feeding: ``batch`` is this process's local shard (its
        stripe of the global batch, e.g. from a ``per_host=True``
        ``NativeDataLoader``). The JAX package assembles its global arrays
        from such shards; here every batch is already process-local and
        one process drives one device, so this places the same tensors as
        :meth:`shard_batch`."""
        return self.shard_batch(batch, non_blocking=non_blocking)

    def shard_block(self, block, non_blocking=False):
        """Put a K-stacked batch block (leaf shapes ``(K,) + batch``) on
        this process's device: the input of the Runner's fused K-step
        dispatch (``megastep``). The leading dim is the step; dim 1 carries
        each step's batch rows, whose global count (local rows x processes)
        must divide by the data-axis size, as in :meth:`shard_batch`."""
        flat, treedef = flatten(block)
        steps = unflatten(treedef, [types.SimpleNamespace(shape=_shape(l)[1:])
                                    for l in flat])  # what batch_specs reads
        self._check_rows(block, steps, dim=1)
        return self._put(block, non_blocking)

    def _check_rows(self, tree, step_tree, dim=0):
        """Each leaf whose per-step spec (from ``step_tree``, the per-step
        view of ``tree``) puts the data axis first carries batch rows at
        ``dim``; their global count must divide by the data-axis size."""
        n = self._program.data_axis_size
        leaves, _ = flatten(tree)
        specs, _ = flatten(self._program.batch_specs(step_tree))
        for leaf, spec in zip(leaves, specs):
            shape = _shape(leaf)
            if len(shape) > dim and spec and \
                    spec[0] == const.MESH_AXIS_DATA:
                total = shape[dim] * self._mesh.process_count
                if total % n != 0:
                    raise ValueError(f"global batch {total} not divisible "
                                     f"by data-axis size {n}")

    def _put(self, tree, non_blocking):
        device = self.device
        leaves, treedef = flatten(tree)

        def put(leaf):
            if isinstance(leaf, np.ndarray) and not leaf.flags.writeable:
                return _put_read_only(leaf, device, non_blocking)
            t = torch.as_tensor(leaf)
            if t.device == device:
                return t
            if device.type == "cuda" and non_blocking and \
                    t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)
        return unflatten(treedef, [put(l) for l in leaves])

    def place_params(self, params, placements=None, copy=False):
        """Place a parameter tree once, at its stored layout: each leaf
        padded where its placement pads it (zeros) and cut to this
        process's piece where it is split over the data axis or over one
        or two piece axes (``Placement.pieces``).
        ``placements`` overrides the program's ``param_placements()``.
        Serving reads the placed tensors and never writes them; training
        updates its copy in place, so it asks for ``copy=True`` and leaves
        the captured tree untouched."""
        if placements is None:
            placements = self._program.param_placements()
        leaves, treedef = flatten(params)
        places, _ = flatten(placements)  # a Placement is a leaf
        return unflatten(treedef, [_place(torch.as_tensor(l), p, copy)
                                   for l, p in zip(leaves, places)])

    def fetch(self, value):
        """Bring a result tree to host memory. Each device leaf is copied,
        without blocking, into a pinned host tensor of its own, then one
        event per device is waited on: the caller owns every answer, and
        no later fetch writes it. CPU leaves pass through unchanged."""
        leaves, treedef = flatten(value)
        out, streams = [], {}
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                host.copy_(leaf.detach(), non_blocking=True)
                streams.setdefault(leaf.device,
                                   torch.cuda.current_stream(leaf.device))
                out.append(host)
            else:
                out.append(leaf)
        for stream in streams.values():
            done = torch.cuda.Event()
            done.record(stream)
            done.synchronize()
        return unflatten(treedef, out)


def _place(t, placement, copy):
    """One leaf at its stored layout on the placement's device."""
    device = placement.device
    if device is None:
        raise NotImplementedError(
            "one process drives one device: a local mesh of several "
            "devices has no device of this process to place on. Train with "
            "one process per device (a torch.distributed world, e.g. "
            "torchrun), or serve with one replica per device (replicas=N)")
    if placement.padding is not None:
        dim, logical, padded = placement.padding
        widths = [0, 0] * t.dim()
        widths[2 * (t.dim() - 1 - dim) + 1] = padded - logical
        t = torch.nn.functional.pad(t.detach(), widths)
    pieces = [(d, i, n) for d, i, n in (
        ((placement.dim, placement.index, placement.shards),) +
        tuple(placement.pieces)) if d is not None]
    if pieces:
        for dim, index, shards in pieces:
            size = t.shape[dim] // shards
            t = t.narrow(dim, index * size, size)
        return t.detach().to(device, copy=True).contiguous()
    if copy:
        return t.detach().to(device, copy=True)
    return t.to(device)


def _put_read_only(leaf, device, non_blocking):
    """A read-only array (a ``block_shuffle`` view into a loader's mmap)
    on ``device``, through one copy: into pinned memory for an
    asynchronous copy to the card, into a tensor of its own on the CPU
    (``torch.as_tensor`` would alias the file mapping, and warns)."""
    if device.type == "cuda" and non_blocking:
        staged = torch.empty(leaf.shape, dtype=torch.from_numpy(
            np.empty(0, leaf.dtype)).dtype, pin_memory=True)
        staged.numpy()[...] = leaf
        return staged.to(device, non_blocking=True)
    return torch.from_numpy(np.array(leaf)).to(device)


def _shape(leaf):
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else np.shape(leaf)
