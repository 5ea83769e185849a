"""Cluster: the ``torch.distributed`` world and named device meshes.

Counterpart of ``autodist_tpu/cluster.py``. Two kinds of mesh:

* a **rank mesh** (training): :meth:`Cluster.start` joins or starts a
  ``torch.distributed`` world, NCCL when this rank's device is a CUDA
  device, gloo when it is the CPU, and :meth:`Cluster.build_mesh` lays the
  named axes over its ranks with ``init_device_mesh``, one device per
  rank. The ``data`` axis's process group carries the gradient reduction
  (the ``data`` x ``seq`` group's, :meth:`Mesh.group_over`, under
  sequence parallelism), and the ``seq`` axis's the ring's hops;
* a **local mesh** (serving): with no world started, ``build_mesh`` names
  the devices of this one process, as in slice 1; a replica places on one
  of them.

``start`` joins a world from one of two launch contracts:

* ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` in the
  environment (``torchrun``'s);
* the AutoDist contract, where the resource spec has several processes
  (``launch: local|ssh``, whose chief starts the workers, or a platform
  that sets the env): rank ``AUTODIST_PROCESS_ID`` of the spec's
  ``num_processes``, over a ``tcp://`` init at ``AUTODIST_COORDINATOR``
  (else the spec's ``coordinator:``), where the chief hosts the c10d TCP
  store. The join retries transient faults (``resilience.retry``), as the
  JAX package retries its ``jax.distributed.initialize``. A CUDA device
  with no index is the spec's card for this process. The backend is NCCL
  where every process has a card of its own, gloo where the spec puts two
  processes of one host on one card (NCCL cannot run two ranks on one
  device) or the device is the CPU.

Without either, it starts a one-rank world on an in-process ``HashStore``
(no port to race for: a re-exec'd chief at world size 1 cannot collide with
its predecessor's port). A world the caller initialized first is joined,
not replaced, and :meth:`Cluster.terminate` leaves it alone.
"""
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, observability
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
        self._groups = {}  # sorted axes -> the process group over them

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

    def axis_index(self, axis=const.MESH_AXIS_DATA):
        """This process's coordinate on ``axis``: its rank in the axis's
        group on a rank mesh, 0 on a one-device local mesh or an axis the
        mesh lacks."""
        if axis not in self.axis_names:
            return 0
        if self.device_mesh is None:
            if self.size != 1:
                raise NotImplementedError(
                    f"no process of this {self.size}-device local mesh has "
                    f"a place on '{axis}'")
            return 0
        return self.device_mesh.get_local_rank(mesh_dim=axis)

    def group(self, axis=const.MESH_AXIS_DATA):
        """The process group of ``axis`` on a rank mesh (None on a local
        mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def group_over(self, axes):
        """The process group of the ranks that share this rank's place on
        every axis but ``axes`` (a rank mesh; None on a local mesh): the
        data x seq group over which a sequence-parallel step averages its
        gradients. One axis is :meth:`group`; axes that span the mesh are
        the world; otherwise every rank builds every such group once
        (``new_group`` is collective), on the first call, which every rank
        makes."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.device_mesh is None:
            return None
        if len(axes) == 1:
            return self.group(axes[0])
        if axes not in self._groups:
            if math.prod(self.shape[a] for a in axes) == self.size:
                self._groups[axes] = dist.group.WORLD
            else:
                dims = [self.axis_names.index(a) for a in axes]
                rows = np.moveaxis(self.devices, dims,
                                   range(-len(dims), 0))
                rows = rows.reshape(-1, math.prod(self.shape[a]
                                                  for a in axes))
                me = dist.get_rank()
                for ranks in rows:
                    group = dist.new_group([int(r) for r in ranks])
                    if me in ranks:
                        self._groups[axes] = group
        return self._groups[axes]

    def hier_groups(self, d, axis=const.MESH_AXIS_DATA):
        """This rank's (ici, dcn) process groups of the hierarchical legs
        over its ``axis`` group split ``d`` ranks a host
        (``hierarchical.leg_groups``): every rank makes every data group's
        leg groups, in one order, on the first call, which every rank
        makes; later calls (and later sessions over this world's mesh)
        reuse them. None, None on a local mesh."""
        if self.device_mesh is None:
            return None, None
        key = ("hier", axis, int(d))
        if key not in self._groups:
            from autodist_tpu_torch.kernel.synchronization.hierarchical \
                import leg_groups
            dim = self.axis_names.index(axis)
            rows = np.moveaxis(self.devices, dim, -1).reshape(
                -1, self.shape[axis])
            me = dist.get_rank()
            mine = (None, None)
            for ranks in rows:
                got = leg_groups([int(r) for r in ranks], int(d), me=me)
                if me in ranks:
                    mine = got
            self._groups[key] = mine
        return self._groups[key]

    def __repr__(self):
        return f"Mesh({self.shape})"


# Rank meshes of the live world by (device, axis names, shape): a session
# that lays out a mesh an earlier session of this world laid out takes that
# mesh, so its process groups (NCCL's communicators, made at their first
# collective) are made once per world, not once per session.
_RANK_MESHES = {}


def _rank_mesh(device, names, shape):
    world = dist.group.WORLD
    if any(w is not world for w, _ in _RANK_MESHES.values()):
        _RANK_MESHES.clear()  # another world: its groups are gone
    key = (str(device), names, shape)
    if key not in _RANK_MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        device_mesh = init_device_mesh(device.type, shape,
                                       mesh_dim_names=names)
        _RANK_MESHES[key] = (world, Mesh(
            np.arange(math.prod(shape)).reshape(shape), names,
            device_mesh=device_mesh, local_device=device))
    return _RANK_MESHES[key][1]


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

    def _contract(self):
        """``(rank, world size)`` of the AutoDist launch contract when the
        spec has several processes and torchrun's env is absent, else
        None."""
        spec = self._resource_spec
        if spec.num_processes <= 1 or \
                all(k in os.environ for k in _TORCHRUN_ENV):
            return None
        return const.ENV.AUTODIST_PROCESS_ID.val, spec.num_processes

    def _backend(self, device, contract):
        """(backend, why): gloo for the CPU and where the spec puts two
        processes of one host on one card, else NCCL."""
        if device.type != "cuda":
            return "gloo", "cpu"
        if contract is None:
            return "nccl", "one card a process"
        spec = self._resource_spec
        seen = {}
        for d in spec.accelerator_devices:
            host = "local" if spec.local_launch else d.host_address
            key = (host, d.device_index)
            if seen.setdefault(key, d.process_index) != d.process_index:
                return "gloo", (f"processes {seen[key]} and "
                                f"{d.process_index} share card "
                                f"{d.device_index} of {host}")
        return "nccl", "one card a process"

    def start(self, device):
        """Join (or start) the ``torch.distributed`` world for this rank's
        ``device`` and return the device.

        A CUDA device without an index becomes ``cuda:LOCAL_RANK`` under
        torchrun, the spec's card of this process under the AutoDist
        contract, else the current device, and is made current. The
        resource spec then describes the world, one device per rank, and
        keeps the parsed spec's launch fields. A ``tpu:`` spec is refused.
        """
        if self.started:
            return self._device
        spec = self._resource_spec
        if spec._source == "tpu":
            raise ValueError(
                "a tpu: resource spec describes TPU hosts, and no job starts "
                "from one on a CUDA card: describe the cluster with a nodes: "
                "list whose nodes name their cards with gpus: (one node per "
                "card under launch: local|ssh)")
        contract = self._contract()
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                mine = [d for d in spec.devices
                        if d.device_type == DeviceType.GPU and
                        d.process_index == contract[0]] \
                    if contract is not None else []
                index = mine[0].device_index if mine else int(
                    os.environ.get("LOCAL_RANK",
                                   torch.cuda.current_device()))
                device = torch.device("cuda", index)
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            backend, why = self._backend(device, contract)
            with observability.span("distributed-init", backend=backend,
                                    why=why):
                if all(k in os.environ for k in _TORCHRUN_ENV):
                    dist.init_process_group(
                        backend, init_method="env://",
                        rank=int(os.environ["RANK"]),
                        world_size=int(os.environ["WORLD_SIZE"]))
                elif contract is not None:
                    self._join_contract(backend, *contract)
                else:
                    dist.init_process_group(backend,
                                            store=dist.HashStore(), rank=0,
                                            world_size=1)
            self._owns_group = True
            logging.info("started a %s world (%s): rank %d of %d on %s",
                         backend, why, dist.get_rank(),
                         dist.get_world_size(), device)
        self._device = device
        self._resource_spec = ResourceSpec.world(
            device, dist.get_rank(), dist.get_world_size(),
            spec.mesh_hints, parsed=spec)
        return device

    def _join_contract(self, backend, rank, world_size):
        """``init_process_group`` over ``tcp://`` at the contract's
        coordinator. The join races the chief's start (a worker dialing a
        store that is not up yet): transient faults retry with backoff."""
        from autodist_tpu_torch.resilience.retry import (
            retry_call, transient_runtime_error)
        spec = self._resource_spec
        coordinator = (const.ENV.AUTODIST_COORDINATOR.val or spec.coordinator
                       or f"{spec.chief_address}:"
                          f"{const.DEFAULT_COORDINATOR_PORT}")
        logging.info("joining the world at tcp://%s as rank %d of %d",
                     coordinator, rank, world_size)
        retry_call(dist.init_process_group, backend,
                   init_method=f"tcp://{coordinator}", rank=rank,
                   world_size=world_size,
                   is_retryable=transient_runtime_error,
                   describe="torch.distributed.init_process_group")

    def is_chief(self):
        """Rank 0 of the world once started, else the launch contract's
        process 0."""
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
        return const.ENV.AUTODIST_PROCESS_ID.val == 0

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
            self._mesh = _rank_mesh(self._device, tuple(names), shape)
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
        observability.record_event(
            "mesh-built", f"{dict(zip(names, shape))} over {n} devices")
        if observability.enabled():
            # World-size gauge (elasticity trail): the processes the mesh
            # spans.
            observability.registry().gauge("cluster.world_size").set(
                self._mesh.process_count)
        return self._mesh

    def ranks_per_host(self):
        """Ranks (devices) a host holds, for the hierarchical legs: the
        spec's ``devices_per_host`` where its nodes name hosts; in a world
        whose spec names none (each rank its own ``process-<r>``, as
        ``ResourceSpec.world`` makes for torchrun's contract), torchrun's
        ``LOCAL_WORLD_SIZE``, or the whole world on one host when unset (as
        ``Topology.for_mesh`` assumes)."""
        spec = self._resource_spec
        if self.started and dist.is_initialized() and all(
                str(d.host_address).startswith("process-")
                for d in spec.accelerator_devices):
            return int(os.environ.get("LOCAL_WORLD_SIZE") or
                       dist.get_world_size())
        return spec.devices_per_host

    def build_hierarchical_mesh(self, devices_per_host=None):
        """A nested ``(dcn, ici)`` mesh over the world's ranks (over this
        host's devices before :meth:`start`): the outer ``dcn`` axis spans
        hosts (the slow leg), the inner ``ici`` axis the ranks of a host
        (the fast leg), host-major, so row h holds host h's ranks and
        ``group("ici")`` / ``group("dcn")`` are the legs'
        (``hierarchical.hier_mean_nested``). ``devices_per_host`` defaults
        to the spec's (``AUTODIST_HIER_ICI`` still overrides, as the
        execution-side leg split does); a split that does not divide the
        rank count degenerates to ``dcn = 1``, the flat topology as a
        1 x N mesh."""
        from autodist_tpu_torch.kernel.synchronization.hierarchical import \
            resolve_legs
        if devices_per_host is None:
            devices_per_host = self.ranks_per_host()
        if self.started:
            n = dist.get_world_size()
            d, h = resolve_legs(n, devices_per_host)
            mesh = _rank_mesh(self._device,
                              (const.MESH_AXIS_DCN, const.MESH_AXIS_ICI),
                              (h, d))
        else:
            devices = local_devices(self._resource_spec)
            n = len(devices)
            d, h = resolve_legs(n, devices_per_host)
            grid = np.empty(n, dtype=object)
            grid[:] = devices
            mesh = Mesh(grid.reshape(h, d),
                        (const.MESH_AXIS_DCN, const.MESH_AXIS_ICI))
        logging.info("Built hierarchical mesh {%s: %d, %s: %d}",
                     const.MESH_AXIS_DCN, h, const.MESH_AXIS_ICI, d)
        return mesh

    @property
    def mesh(self):
        if self._mesh is None:
            self.build_mesh()
        return self._mesh

    def terminate(self, keep_world=False):
        """Destroy the process group :meth:`start` began (a world the
        caller initialized stays, and so does this one with
        ``keep_world``: the next :meth:`start` joins it)."""
        if self._owns_group and dist.is_initialized() and not keep_world:
            dist.destroy_process_group()
        self._owns_group = False
        self._device = None
        self._mesh = None
