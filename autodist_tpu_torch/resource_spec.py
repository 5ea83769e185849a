"""Resource model: cluster description -> devices and mesh hints.

Counterpart of ``autodist_tpu/resource_spec.py``. Two sources:

1. ``auto: true`` (or no file at all): discover devices from
   ``torch.cuda.device_count()``; a host with no CUDA device is one CPU
   device.
2. A reference-style ``nodes:`` list (``address`` / ``gpus`` / ``cpus`` /
   ``chief``), parsed as the JAX package parses it.

The ``tpu:`` block and the elastic-world override of the JAX package are
not ported yet (ROADMAP.md).
"""
from enum import Enum


class DeviceType(Enum):
    CPU = 0
    GPU = 1
    TPU = 2


class DeviceSpec:
    """A single device, addressable as ``host:KIND:index``."""

    def __init__(self, host_address, device_type=DeviceType.GPU,
                 device_index=0, process_index=0):
        self.host_address = host_address
        self.device_type = device_type
        self.device_index = device_index
        self.process_index = process_index

    def name_string(self):
        return f"{self.host_address}:{self.device_type.name}:{self.device_index}"

    def __repr__(self):
        return f"DeviceSpec({self.name_string()})"

    def __eq__(self, other):
        return isinstance(other, DeviceSpec) and \
            self.name_string() == other.name_string()

    def __hash__(self):
        return hash(self.name_string())


class ResourceSpec:
    """Parsed cluster description.

    Attributes:
        devices: list[DeviceSpec] — every device in the cluster.
        chief_address: host address of the chief (process 0).
        num_processes: number of host processes.
        mesh_hints: dict axis-name -> size requested in the spec.
    """

    def __init__(self, resource_file=None):
        self._devices = []
        self.chief_address = None
        self.num_processes = 1
        self.mesh_hints = {}
        self._source = None
        self._discovered = False
        if resource_file is None:
            self._source = "auto"
            self.chief_address = "process-0"
            return
        import yaml  # only a spec file needs it
        with open(resource_file) as f:
            info = yaml.safe_load(f) or {}
        if "tpu" in info:
            raise NotImplementedError(
                "the tpu: block of a resource spec is not ported; describe "
                "the cluster with a nodes: list or auto: true")
        if info.get("auto") or not info.get("nodes"):
            self._source = "auto"
            self.chief_address = "process-0"
        else:
            self._from_nodes(info)
        self.mesh_hints = dict(info.get("mesh", {}) or {})

    @classmethod
    def local(cls, device):
        """A spec of exactly one local ``torch.device``: the cluster a
        caller describes by naming its device (``"cpu"``, ``"cuda:1"``)."""
        import torch
        device = torch.device(device)
        spec = cls()
        spec._discovered = True
        if device.type == "cuda":
            index = torch.cuda.current_device() if device.index is None \
                else device.index
            spec._devices = [DeviceSpec("process-0", DeviceType.GPU, index)]
        else:
            spec._devices = [DeviceSpec("process-0", DeviceType.CPU, 0)]
        return spec

    @classmethod
    def world(cls, device, rank, world_size, mesh_hints=None):
        """A spec of a ``torch.distributed`` world: one device of
        ``device``'s kind per rank, process ``r`` on host ``process-r``
        (this rank's device with its own index, the others' by rank)."""
        spec = cls()
        spec._discovered = True
        kind = DeviceType.GPU if device.type == "cuda" else DeviceType.CPU
        spec._devices = [
            DeviceSpec(f"process-{r}", kind,
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

    def _from_nodes(self, info):
        self._source = "nodes"
        nodes = info.get("nodes", [])
        chief = None
        for proc, node in enumerate(nodes):
            address = str(node["address"])
            if node.get("chief"):
                chief = address
            gpus = node.get("gpus", [])
            tpus = node.get("tpus", [])
            cpus = node.get("cpus", [0] if not gpus and not tpus else [])
            for kind, ids in ((DeviceType.TPU, tpus), (DeviceType.GPU, gpus),
                              (DeviceType.CPU, cpus)):
                for i in ids:
                    self._devices.append(DeviceSpec(address, kind, int(i),
                                                    proc))
        self.num_processes = max(1, len(nodes))
        self.chief_address = chief or (nodes[0]["address"] if nodes else None)

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
    def num_hosts(self):
        """Distinct hosts carrying accelerator devices (>= 1)."""
        return max(1, len({d.host_address for d in self.accelerator_devices}))

    @property
    def devices_per_host(self):
        """Accelerator devices per host (uniform hosts assumed; >= 1)."""
        return max(1, len(self.accelerator_devices) // self.num_hosts)

    def __repr__(self):
        return (f"ResourceSpec(source={self._source}, "
                f"devices={self.num_devices}, "
                f"processes={self.num_processes}, chief={self.chief_address})")
