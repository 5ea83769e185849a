"""Resource model: cluster description -> devices, chief election, launch
and mesh hints.

Counterpart of ``autodist_tpu/resource_spec.py``, parsed as the JAX package
parses it, so one spec file gives equal spec objects in both packages.
Three sources:

1. ``auto: true`` (or no file at all): the launch contract
   (``AUTODIST_NUM_PROCESSES`` / ``AUTODIST_COORDINATOR``) now, the
   devices from ``torch.cuda.device_count()`` on first access (a host with
   no CUDA device is one CPU device).
2. A ``tpu:`` block (``accelerator``, ``num_hosts``, ``chips_per_host``,
   ``coordinator``, ``hosts``). It parses, but no job starts from it on a
   CUDA card: ``Cluster.start`` refuses it.
3. A reference-style ``nodes:`` list (``address`` / ``gpus`` / ``cpus`` /
   ``chief`` / ``ssh_config``), with the ``ssh:`` groups, ``coordinator:``,
   ``interconnect:`` and ``memory:`` keys, and ``launch: local`` (the chief
   re-runs the user script once per extra process) or ``launch: ssh``
   (the chief starts it on each node over SSH, ``ssh.SSHLauncher``).

One process drives one device (the port's rule). A node is one process, as
in the JAX package; under ``launch: local|ssh`` a node that lists more than
one accelerator is refused (list one node per card), and a CPU node is one
CPU device whatever its ``cpus:`` lists.

``AUTODIST_ELASTIC_WORLD`` (set by ``Coordinator.reform_now``) shrinks the
spec to its first K processes after an elastic re-form.
"""
from collections import namedtuple
from enum import Enum

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging


class DeviceType(Enum):
    CPU = 0
    GPU = 1
    TPU = 2


class Connectivity(Enum):
    """Relative link quality between two devices (best -> worst)."""
    SAME_DEVICE = 0
    ICI = 1          # intra-slice TPU interconnect (or NVLink-class)
    LOCAL = 2        # same host, PCIe/host memory
    DCN = 3          # cross-host data-center network


class DeviceSpec:
    """A single device, addressable as ``host:KIND:index``."""

    def __init__(self, host_address, device_type=DeviceType.GPU,
                 device_index=0, process_index=0, coords=None):
        self.host_address = host_address
        self.device_type = device_type
        self.device_index = device_index
        self.process_index = process_index
        self.coords = coords

    def name_string(self):
        return f"{self.host_address}:{self.device_type.name}:{self.device_index}"

    @classmethod
    def from_string(cls, name):
        """Parse ``host:KIND:index`` (``host:index`` is a TPU, as in the
        JAX package)."""
        parts = name.split(":")
        if len(parts) == 2:
            return cls(parts[0], DeviceType.TPU, int(parts[1]))
        host, kind, idx = parts[0], parts[1], parts[2]
        return cls(host, DeviceType[kind.upper()], int(idx))

    def __repr__(self):
        return f"DeviceSpec({self.name_string()})"

    def __eq__(self, other):
        return isinstance(other, DeviceSpec) and \
            self.name_string() == other.name_string()

    def __hash__(self):
        return hash(self.name_string())


SSHConfig = namedtuple("SSHConfig", ["username", "port", "python_venv",
                                     "key_file", "env"])

# Launch fields a world spec keeps from the parsed one (Cluster.start).
_LAUNCH_FIELDS = ("coordinator", "interconnect", "memory", "ssh_config_map",
                  "node_ssh_group", "local_launch", "remote_launch")


class ResourceSpec:
    """Parsed cluster description.

    Attributes:
        devices: list[DeviceSpec] — every device in the cluster.
        chief_address: host address of the chief (process 0).
        num_processes: number of host processes.
        coordinator: "host:port" of the chief's store, or "".
        mesh_hints: dict axis-name -> size requested in the spec.
        interconnect / memory: the spec's declared link and memory keys.
        ssh_config_map: group-name -> SSHConfig; node_ssh_group: address ->
            group name.
        local_launch / remote_launch: ``launch: local`` / ``launch: ssh``.
    """

    def __init__(self, resource_file=None):
        self._devices = []
        self.chief_address = None
        self.num_processes = 1
        self.coordinator = ""
        self.mesh_hints = {}
        self.interconnect = {}
        self.memory = {}
        self.ssh_config_map = {}
        self.node_ssh_group = {}
        self.local_launch = False
        self.remote_launch = False
        self._source = None
        self._discovered = False
        if resource_file is None:
            self._prepare_auto()
        else:
            import yaml  # only a spec file needs it
            with open(resource_file) as f:
                info = yaml.safe_load(f) or {}
            launch = info.get("launch")
            if info.get("auto") or (not info.get("nodes")
                                    and not info.get("tpu")):
                self._prepare_auto()
            elif "tpu" in info:
                self._from_tpu_block(info["tpu"])
            else:
                self._from_nodes(info, launched=launch in ("local", "ssh"))
            self.mesh_hints = dict(info.get("mesh", {}) or {})
            self.interconnect = dict(info.get("interconnect", {}) or {})
            self.memory = dict(info.get("memory", {}) or {})
            self.local_launch = launch == "local" and self._source != "auto"
            self.remote_launch = launch == "ssh" and self._source == "nodes"
        self._apply_elastic_world()

    def _apply_elastic_world(self):
        """Shrink the spec to ``AUTODIST_ELASTIC_WORLD`` processes: after an
        elastic re-form the relaunched generation keeps the first K
        processes' nodes and devices of the spec file, which still
        describes the whole fleet. A larger override is clamped (the spec
        is the ceiling)."""
        world = const.ENV.AUTODIST_ELASTIC_WORLD.val
        if not world or world <= 0 or self.num_processes <= 1:
            return
        if world >= self.num_processes:
            return
        dropped = [d for d in self._devices if d.process_index >= world]
        self._devices = [d for d in self._devices if d.process_index < world]
        self.num_processes = world
        logging.warning(
            "elastic world override: spec shrunk to %d process(es), "
            "%d device(s) dropped", world, len(dropped))
        try:
            from autodist_tpu_torch import resilience
            resilience.record_event(
                "spec-shrink", f"AUTODIST_ELASTIC_WORLD={world}: "
                               f"{len(dropped)} device(s) dropped")
        except Exception:  # noqa: BLE001 - spec parsing must never fail here
            pass

    # -- sources ------------------------------------------------------------

    def _prepare_auto(self):
        """Auto mode: the launch contract now, the devices on first
        access."""
        self._source = "auto"
        self.num_processes = max(1, const.ENV.AUTODIST_NUM_PROCESSES.val)
        self.coordinator = const.ENV.AUTODIST_COORDINATOR.val
        self.chief_address = "process-0"

    def _from_tpu_block(self, tpu):
        self._source = "tpu"
        accel = tpu.get("accelerator", "v5e-8")
        num_hosts = int(tpu.get("num_hosts", 1))
        chips_per_host = int(tpu.get("chips_per_host",
                                     self._default_chips_per_host(accel)))
        self.num_processes = num_hosts
        self.coordinator = tpu.get("coordinator",
                                   const.ENV.AUTODIST_COORDINATOR.val)
        hosts = tpu.get("hosts") or [f"host-{i}" for i in range(num_hosts)]
        if len(hosts) < num_hosts:
            raise ValueError(f"tpu.hosts lists {len(hosts)} hosts but "
                             f"num_hosts is {num_hosts}")
        for h in range(num_hosts):
            for c in range(chips_per_host):
                self._devices.append(DeviceSpec(
                    hosts[h], DeviceType.TPU, h * chips_per_host + c, h))
        self.chief_address = (self._devices[0].host_address
                              if self._devices else None)

    @staticmethod
    def _default_chips_per_host(accel):
        try:
            return min(int(accel.rsplit("-", 1)[1]), 8)
        except (ValueError, IndexError):
            return 8

    def _from_nodes(self, info, launched=False):
        self._source = "nodes"
        nodes = info.get("nodes", [])
        chief = None
        for proc, node in enumerate(nodes):
            address = str(node["address"])
            if node.get("chief"):
                chief = address
            if node.get("ssh_config"):
                self.node_ssh_group[address] = node["ssh_config"]
            gpus = node.get("gpus", [])
            tpus = node.get("tpus", [])
            cpus = node.get("cpus", [0] if not gpus and not tpus else [])
            if launched and len(gpus) + len(tpus) > 1:
                raise ValueError(
                    f"node {address!r} lists {len(gpus) + len(tpus)} "
                    f"accelerators under launch: {info.get('launch')}, but "
                    f"a launched node is one process and one process drives "
                    f"one device: list one node per card")
            if launched and not gpus and not tpus:
                cpus = list(cpus)[:1] or [0]
            for kind, ids in ((DeviceType.TPU, tpus), (DeviceType.GPU, gpus),
                              (DeviceType.CPU, cpus)):
                for i in ids:
                    self._devices.append(DeviceSpec(address, kind, int(i),
                                                    proc))
        self.num_processes = max(1, len(nodes))
        self.chief_address = chief or (nodes[0]["address"] if nodes else None)
        self.coordinator = info.get("coordinator",
                                    const.ENV.AUTODIST_COORDINATOR.val)
        for group, cfg in (info.get("ssh", {}) or {}).items():
            self.ssh_config_map[group] = SSHConfig(
                username=cfg.get("username", ""),
                port=int(cfg.get("port", 22)),
                python_venv=cfg.get("python_venv", ""),
                key_file=cfg.get("key_file", ""),
                env=cfg.get("shared_envs", {}))

    @classmethod
    def local(cls, device):
        """A spec of exactly one local ``torch.device``: the cluster a
        caller describes by naming its device (``"cpu"``, ``"cuda:1"``)."""
        import torch
        device = torch.device(device)
        spec = cls()
        spec._discovered = True
        spec.num_processes = 1
        if device.type == "cuda":
            index = torch.cuda.current_device() if device.index is None \
                else device.index
            spec._devices = [DeviceSpec("process-0", DeviceType.GPU, index)]
        else:
            spec._devices = [DeviceSpec("process-0", DeviceType.CPU, 0)]
        return spec

    @classmethod
    def world(cls, device, rank, world_size, mesh_hints=None, parsed=None):
        """A spec of a ``torch.distributed`` world: one device of
        ``device``'s kind per rank (this rank's device with its own index,
        the others' by rank). Process ``r`` is on host ``process-r``, or on
        the ``parsed`` spec's node ``r`` where that spec has one node per
        rank; the parsed spec's launch fields (coordinator, ssh groups,
        launch mode, interconnect, memory) and chief are kept."""
        spec = cls()
        spec._discovered = True
        kind = DeviceType.GPU if device.type == "cuda" else DeviceType.CPU
        hosts = [f"process-{r}" for r in range(world_size)]
        if parsed is not None:
            for field in _LAUNCH_FIELDS:
                setattr(spec, field, getattr(parsed, field))
            named = parsed.node_addresses if parsed._source == "nodes" \
                else []
            if len(named) == world_size:
                hosts = named
                spec.chief_address = parsed.chief_address
        if spec.chief_address is None or spec.chief_address not in hosts:
            spec.chief_address = hosts[0]
        spec._devices = [
            DeviceSpec(hosts[r], kind,
                       (device.index or 0) if r == rank else
                       (r if kind == DeviceType.GPU else 0), r)
            for r in range(world_size)]
        spec.num_processes = world_size
        spec.mesh_hints = dict(mesh_hints or {})
        return spec

    def _discover_live_backend(self):
        import torch
        n = torch.cuda.device_count()
        if n:
            self._devices = [DeviceSpec("process-0", DeviceType.GPU, i, 0)
                             for i in range(n)]
        else:
            self._devices = [DeviceSpec("process-0", DeviceType.CPU, 0, 0)]

    @property
    def devices(self):
        if self._source == "auto" and not self._discovered:
            self._discovered = True
            self._discover_live_backend()
        return self._devices

    # -- queries ------------------------------------------------------------

    @property
    def num_devices(self):
        return len(self.devices)

    @property
    def accelerator_devices(self):
        accels = [d for d in self.devices
                  if d.device_type in (DeviceType.TPU, DeviceType.GPU)]
        return accels if accels else list(self.devices)

    @property
    def cpu_devices(self):
        return [d for d in self.devices if d.device_type == DeviceType.CPU]

    @property
    def node_addresses(self):
        seen, out = set(), []
        for d in self.devices:
            if d.host_address not in seen:
                seen.add(d.host_address)
                out.append(d.host_address)
        return out

    @property
    def num_hosts(self):
        """Distinct hosts carrying accelerator devices (>= 1)."""
        return max(1, len({d.host_address for d in self.accelerator_devices}))

    @property
    def devices_per_host(self):
        """Accelerator devices per host (uniform hosts assumed; >= 1)."""
        return max(1, len(self.accelerator_devices) // self.num_hosts)

    def ssh_config_for(self, address):
        """The SSHConfig for a node: its ``ssh_config`` group, else the
        spec's single group if only one is defined."""
        group = self.node_ssh_group.get(address)
        if group is not None:
            return self.ssh_config_map.get(group)
        if len(self.ssh_config_map) == 1:
            return next(iter(self.ssh_config_map.values()))
        return None

    def is_chief(self, address=None):
        """This process's role from the launch contract (process 0 and no
        ``AUTODIST_WORKER``), or whether ``address`` is the chief's."""
        if address is None:
            return const.ENV.AUTODIST_PROCESS_ID.val == 0 and \
                not const.ENV.AUTODIST_WORKER.val
        return address == self.chief_address

    def connectivity(self, a, b):
        """Classify the link between two DeviceSpecs (used by cost models)."""
        if a == b:
            return Connectivity.SAME_DEVICE
        if a.device_type == DeviceType.TPU and b.device_type == DeviceType.TPU:
            return Connectivity.ICI if a.process_index == b.process_index \
                else Connectivity.DCN
        if a.host_address == b.host_address:
            return Connectivity.LOCAL
        return Connectivity.DCN

    def __repr__(self):
        return (f"ResourceSpec(source={self._source}, "
                f"devices={self.num_devices}, "
                f"processes={self.num_processes}, chief={self.chief_address})")
