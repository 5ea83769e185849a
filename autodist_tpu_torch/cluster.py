"""Cluster: the ``torch.distributed`` world and named device meshes.

Counterpart of ``autodist_tpu/cluster.py``. Two kinds of mesh:

* a **rank mesh** (training): :meth:`Cluster.start` joins or starts a
  ``torch.distributed`` world, NCCL when this rank's device is a CUDA
  device, gloo when it is the CPU, and :meth:`Cluster.build_mesh` lays the
  named axes over its ranks with ``init_device_mesh``, one device per
  rank. The ``data`` axis's process group carries the gradient reduction;
* a **local mesh** (serving): with no world started, ``build_mesh`` names
  the devices of this one process, as in slice 1; a replica places on one
  of them.

With ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` in the
environment (the ``torchrun`` contract) ``start`` joins that world; without
them it starts a one-rank world on an in-process ``HashStore`` (no port to
race for). A world the caller initialized first is joined, not replaced,
and :meth:`Cluster.terminate` leaves it alone.
"""
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.resource_spec import DeviceType, ResourceSpec
from autodist_tpu_torch.utils import logging

# Data outermost, then pipe/expert/seq/model innermost (as in the JAX mesh).
_AXIS_ORDER = {const.MESH_AXIS_DATA: 0, const.MESH_AXIS_PIPELINE: 1,
               const.MESH_AXIS_EXPERT: 2, const.MESH_AXIS_SEQ: 3,
               const.MESH_AXIS_MODEL: 4}
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh:
    """A named device mesh: ``devices`` (an object array), ``axis_names``
    and ``shape`` (axis -> size).

    A rank mesh holds ranks in ``devices`` and this process's
    ``torch.device`` in ``local_device``; its ``device_mesh`` gives each
    axis's process group. A local mesh holds ``torch.device``s.
    """

    def __init__(self, devices, axis_names, device_mesh=None,
                 local_device=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of rank {self.devices.ndim} do not "
                             f"match axis names {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device_mesh = device_mesh
        self._local_device = local_device

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def process_count(self):
        """Processes the mesh spans: its size for a rank mesh, else 1."""
        return self.size if self.device_mesh is not None else 1

    @property
    def local_device(self):
        """This process's device: its rank's on a rank mesh, the only one on
        a one-device local mesh."""
        if self._local_device is not None:
            return self._local_device
        if self.size != 1:
            raise NotImplementedError(
                f"one process drives one device: this {self.size}-device "
                f"mesh of a single process has no device of its own. Train "
                f"with one process per device (a torch.distributed world, "
                f"e.g. torchrun), or serve with one replica per device "
                f"(replicas=N)")
        return self.devices.flat[0]

    def group(self, axis=const.MESH_AXIS_DATA):
        """The process group of ``axis`` on a rank mesh (None on a local
        mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def local_devices(spec):
    """``torch.device``s for a resource spec's accelerators on this host."""
    return [torch.device("cuda", d.device_index)
            if d.device_type == DeviceType.GPU else torch.device("cpu")
            for d in spec.accelerator_devices]


def _resolve_axis_sizes(axis_sizes, n, hints):
    """{axis: size} over ``n`` devices: defaults to ``hints``, else every
    device on the data axis; a single ``-1`` is inferred and leftover
    devices fold into the data axis."""
    if not axis_sizes:
        axis_sizes = dict(hints) or {const.MESH_AXIS_DATA: n}
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
        raise ValueError(f"Mesh {axis_sizes} needs {total} devices, have {n}")
    if total < n:
        if n % total != 0:
            raise ValueError(f"Mesh {axis_sizes} does not divide device "
                             f"count {n}")
        axis_sizes.setdefault(const.MESH_AXIS_DATA, 1)
        axis_sizes[const.MESH_AXIS_DATA] *= n // total
    names = sorted(axis_sizes, key=lambda a: _AXIS_ORDER.get(a, 99))
    return names, tuple(axis_sizes[a] for a in names)


class Cluster:
    """The process world and mesh construction for a ResourceSpec."""

    def __init__(self, resource_spec):
        self._resource_spec = resource_spec
        self._device = None      # this rank's device once started
        self._owns_group = False
        self._mesh = None

    @property
    def resource_spec(self):
        return self._resource_spec

    @property
    def started(self):
        return self._device is not None

    def start(self, device):
        """Join (or start) the ``torch.distributed`` world for this rank's
        ``device`` and return the device.

        A CUDA device without an index becomes ``cuda:LOCAL_RANK`` under
        torchrun, else the current device, and is made current. The resource
        spec then describes the world: one device per rank.
        """
        if self.started:
            return self._device
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", int(os.environ.get(
                    "LOCAL_RANK", torch.cuda.current_device())))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            backend = "nccl" if device.type == "cuda" else "gloo"
            if all(k in os.environ for k in _TORCHRUN_ENV):
                dist.init_process_group(
                    backend, init_method="env://",
                    rank=int(os.environ["RANK"]),
                    world_size=int(os.environ["WORLD_SIZE"]))
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            self._owns_group = True
            logging.info("started a %s world: rank %d of %d on %s", backend,
                         dist.get_rank(), dist.get_world_size(), device)
        self._device = device
        self._resource_spec = ResourceSpec.world(
            device, dist.get_rank(), dist.get_world_size(),
            self._resource_spec.mesh_hints)
        return device

    def build_mesh(self, axis_sizes=None):
        """Build a named mesh: over the world's ranks once :meth:`start`
        ran, else over the spec's devices on this host.

        ``axis_sizes`` is {axis_name: size}; sizes multiply to at most the
        device (rank) count, a single ``-1`` is inferred, leftover devices
        fold into the data axis. Defaults to the spec's mesh hints, else
        every device on the data axis.
        """
        if self.started:
            n = dist.get_world_size()
            names, shape = _resolve_axis_sizes(
                axis_sizes, n, self._resource_spec.mesh_hints)
            from torch.distributed.device_mesh import init_device_mesh
            device_mesh = init_device_mesh(self._device.type, shape,
                                           mesh_dim_names=tuple(names))
            self._mesh = Mesh(np.arange(n).reshape(shape), names,
                              device_mesh=device_mesh,
                              local_device=self._device)
        else:
            devices = local_devices(self._resource_spec)
            n = len(devices)
            names, shape = _resolve_axis_sizes(
                axis_sizes, n, self._resource_spec.mesh_hints)
            grid = np.empty(n, dtype=object)
            grid[:] = devices
            self._mesh = Mesh(grid.reshape(shape), names)
        logging.info("Built mesh %s over %d devices",
                     dict(zip(names, shape)), n)
        return self._mesh

    @property
    def mesh(self):
        if self._mesh is None:
            self.build_mesh()
        return self._mesh

    def terminate(self):
        """Destroy the process group :meth:`start` began (a world the
        caller initialized stays)."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
        self._device = None
        self._mesh = None
