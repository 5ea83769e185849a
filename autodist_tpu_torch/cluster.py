"""Cluster: named device meshes over ``torch.device``s.

Counterpart of ``autodist_tpu/cluster.py``. This slice is single-process:
a mesh is a named array of devices that placement reads. Joining processes
with ``torch.distributed`` / NCCL comes with the training slice.
"""
import math

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.resource_spec import DeviceType
from autodist_tpu_torch.utils import logging

# Data outermost, then pipe/expert/seq/model innermost (as in the JAX mesh).
_AXIS_ORDER = {const.MESH_AXIS_DATA: 0, const.MESH_AXIS_PIPELINE: 1,
               const.MESH_AXIS_EXPERT: 2, const.MESH_AXIS_SEQ: 3,
               const.MESH_AXIS_MODEL: 4}


class Mesh:
    """A named device mesh: ``devices`` (an object array of
    ``torch.device``), ``axis_names`` and ``shape`` (axis -> size)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of rank {self.devices.ndim} do not "
                             f"match axis names {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"


def local_devices(spec):
    """``torch.device``s for a resource spec's accelerators on this host."""
    return [torch.device("cuda", d.device_index)
            if d.device_type == DeviceType.GPU else torch.device("cpu")
            for d in spec.accelerator_devices]


class Cluster:
    """Mesh construction for a ResourceSpec."""

    def __init__(self, resource_spec):
        self._resource_spec = resource_spec

    def build_mesh(self, axis_sizes=None):
        """Build a named mesh over the spec's devices on this host.

        ``axis_sizes`` is {axis_name: size}; sizes multiply to at most the
        device count, a single ``-1`` is inferred, leftover devices fold
        into the data axis. Defaults to the spec's mesh hints, else every
        device on the data axis.
        """
        devices = local_devices(self._resource_spec)
        n = len(devices)
        if not axis_sizes:
            axis_sizes = dict(self._resource_spec.mesh_hints) or \
                {const.MESH_AXIS_DATA: n}
        axis_sizes = dict(axis_sizes)
        known = [s for s in axis_sizes.values() if s != -1]
        prod = math.prod(known) if known else 1
        if any(s == -1 for s in axis_sizes.values()):
            if n % prod != 0:
                raise ValueError(f"Cannot infer mesh axis: {n} devices not "
                                 f"divisible by {prod}")
            axis_sizes = {k: (n // prod if v == -1 else v)
                          for k, v in axis_sizes.items()}
        total = math.prod(axis_sizes.values())
        if total > n:
            raise ValueError(f"Mesh {axis_sizes} needs {total} devices, "
                             f"have {n}")
        if total < n:
            if n % total != 0:
                raise ValueError(f"Mesh {axis_sizes} does not divide device "
                                 f"count {n}")
            axis_sizes.setdefault(const.MESH_AXIS_DATA, 1)
            axis_sizes[const.MESH_AXIS_DATA] *= n // total
        names = sorted(axis_sizes, key=lambda a: _AXIS_ORDER.get(a, 99))
        shape = tuple(axis_sizes[a] for a in names)
        grid = np.empty(n, dtype=object)
        grid[:] = devices
        logging.info("Built mesh %s over %d devices", dict(zip(names, shape)),
                     n)
        return Mesh(grid.reshape(shape), names)
