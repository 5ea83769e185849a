"""Variable partitioning: partition strings -> per-dimension mesh axes.

Counterpart of ``autodist_tpu/kernel/partitioner.py``:
``PartitionerConfig`` parses and formats the strategy's partition string
("axis:num_shards[:mesh_axis]", comma-joined for composed plans) and
``param_partition_spec`` picks the mesh axis of each parameter dimension,
and ``choose_state_sharding_spec`` the dimension of a PS variable's
optimizer state (ZeRO-1) that carries the data axis.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging


class PartitionSpec(tuple):
    """Per-dimension mesh axis (or None) of one array; ``()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def axis_dim(spec, axis):
    """Index of the dimension ``spec`` places on mesh axis ``axis``, or
    None."""
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def data_dim(spec):
    """Index of the dimension ``spec`` places on the data axis, or None."""
    return axis_dim(spec, const.MESH_AXIS_DATA)


class PartitionerConfig:
    """Partition string "axis:num_shards[:mesh_axis]" <-> structured config."""

    def __init__(self, axis=0, num_shards=1, mesh_axis=None, extras=()):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.axis = axis
        self.num_shards = num_shards
        self.mesh_axis = mesh_axis
        self.extras = tuple(extras)  # further (axis, num_shards, mesh_axis)

    @classmethod
    def from_string(cls, s):
        if not s:
            return cls(0, 1)
        entries = []
        for part in s.split(","):
            bits = part.split(":")
            entries.append((int(bits[0]), int(bits[1]),
                            bits[2] if len(bits) > 2 and bits[2] else None))
        first = entries[0]
        return cls(first[0], first[1], first[2], extras=entries[1:])

    def to_string(self):
        def one(axis, num, mesh_axis):
            base = f"{axis}:{num}"
            return f"{base}:{mesh_axis}" if mesh_axis else base
        return ",".join([one(self.axis, self.num_shards, self.mesh_axis)] +
                        [one(*e) for e in self.extras])

    @property
    def entries(self):
        return ((self.axis, self.num_shards, self.mesh_axis),) + self.extras

    def partition_list(self, rank):
        """Reference-style per-dimension shard counts."""
        out = [1] * rank
        for axis, num, _mesh in self.entries:
            if 0 <= axis < rank:
                out[axis] = num
        return out

    @property
    def active(self):
        return any(num > 1 for _a, num, _m in self.entries)

    def __repr__(self):
        return (f"PartitionerConfig(axis={self.axis}, "
                f"num_shards={self.num_shards})")


def param_partition_spec(var, pconfig, mesh_axis, axis_size=None,
                         mesh_sizes=None):
    """PartitionSpec for a partitioned parameter: ``pconfig.axis`` on
    ``mesh_axis``, extra entries on their own mesh axes. A dimension
    smaller than its mesh axis stays replicated (sharding it would leave
    devices holding pure padding)."""
    if not pconfig.active:
        return PartitionSpec()
    if pconfig.axis >= len(var.shape):
        raise ValueError(f"partition axis {pconfig.axis} out of range for "
                         f"{var.name} with shape {var.shape}")
    if axis_size is not None and var.shape[pconfig.axis] < axis_size:
        logging.debug("not partitioning %s: dim %d (%d) smaller than mesh "
                      "axis '%s' (%d)", var.name, pconfig.axis,
                      var.shape[pconfig.axis], mesh_axis, axis_size)
        return PartitionSpec()
    spec = [None] * len(var.shape)
    spec[pconfig.axis] = mesh_axis
    for axis, _num, extra_axis in pconfig.extras:
        if extra_axis is None or axis >= len(var.shape) or \
                spec[axis] is not None:
            continue
        size = (mesh_sizes or {}).get(extra_axis)
        if size is not None and var.shape[axis] < size:
            continue
        spec[axis] = extra_axis
    return PartitionSpec(*spec)


def choose_state_sharding_spec(var, mesh_axis, axis_size):
    """Sharding of a variable's optimizer state under PS (ZeRO-1) sync.

    The largest dimension the axis divides carries ``mesh_axis``, even if
    it is not dim 0; with none, the largest dimension, padded to a multiple
    (``DistributedProgram.paddings``); with no dimension at least
    ``axis_size``, the state replicates (sharding it would be pure
    overhead).
    """
    if not var.shape:
        return PartitionSpec()
    dims = sorted(range(len(var.shape)), key=lambda i: var.shape[i],
                  reverse=True)
    best = next((i for i in dims if var.shape[i] >= axis_size and
                 var.shape[i] % axis_size == 0), None)
    if best is None:
        if var.shape[dims[0]] < axis_size:
            return PartitionSpec()
        best = dims[0]
    spec = [None] * len(var.shape)
    spec[best] = mesh_axis
    return PartitionSpec(*spec)
