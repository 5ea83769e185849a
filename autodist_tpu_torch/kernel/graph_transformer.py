"""GraphTransformer: (GraphItem, Strategy, Mesh) -> DistributedProgram.

Counterpart of ``autodist_tpu/kernel/graph_transformer.py``: the program
carries one ``Synchronizer`` per trainable variable (its placement specs
and its gradient reduction), whether any of them needs the explicit
(sharded-state / stale) gradient path, each parameter's placement, the
optimizer state's specs, the padding plan of uneven shards, the batch's
data-axis split, and the parallel context the loss runs in.
"""
import math
import os
from typing import Any, NamedTuple

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.partitioner import PartitionSpec
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.proto import strategy_pb2
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import (path_to_name, tree_map,
                                           tree_map_with_path)


class Placement(NamedTuple):
    """Where one parameter's storage lives on this process.

    ``device``: this process's device (None on a local mesh of several
    devices, which no process drives alone); ``dim``: the storage dim split
    over the data axis (None: whole); ``index``: this process's place on
    the data axis, its piece along ``dim`` (None where ``device`` is);
    ``shards``: the pieces along ``dim`` (1: whole); ``padding``:
    ``(dim, logical, padded)`` of padded storage, or None.
    """
    device: Any
    dim: Any
    index: Any
    shards: int
    padding: Any


class DistributedProgram:
    """Distribution plan for one captured program on one mesh."""

    def __init__(self, graph_item, strategy, mesh, synchronizers,
                 use_explicit_path):
        self.graph_item = graph_item
        self.strategy = strategy
        self.mesh = mesh
        self.synchronizers = synchronizers  # {var_name: Synchronizer}
        self.use_explicit_path = use_explicit_path
        self._parallel_context = None

    def parallel_context(self):
        """The :class:`~autodist_tpu_torch.parallel.context.ParallelContext`
        this strategy prescribes (its GraphConfig's ``seq_attn`` on this
        mesh), which the Runner activates around the loss."""
        if self._parallel_context is None:
            from autodist_tpu_torch.parallel.context import ParallelContext
            gc = self.strategy.graph_config
            self._parallel_context = ParallelContext(
                mesh=self.mesh, seq_attn=gc.seq_attn,
                pipeline_microbatches=gc.pipeline_microbatches,
                op_shardings=dict(gc.op_shardings))
        return self._parallel_context

    @property
    def seq_axis_size(self):
        return self.mesh.shape.get(const.MESH_AXIS_SEQ, 1)

    def _spec_tree(self, spec_of):
        return tree_map_with_path(
            lambda path, _: (spec_of(self.synchronizers[n])
                             if (n := path_to_name(path)) in
                             self.synchronizers else PartitionSpec()),
            self.graph_item.params)

    def param_specs(self):
        """PartitionSpec tree congruent with the params tree."""
        return self._spec_tree(lambda s: s.param_spec())

    def grad_specs(self):
        """Gradient placement specs, congruent with the params tree."""
        return self._spec_tree(lambda s: s.grad_spec())

    def var_kinds(self):
        """{var_name: (kind, dim)}: how the Runner lowers each trainable
        variable (the JAX Runner's ``var_kinds``,
        ``autodist_tpu/runner.py:195-225``):

        * ``stale``: bounded staleness; each rank updates its own whole
          copy, averaged over the data group every ``s + 1`` steps;
        * ``fsdp``: the parameter split over the data axis along ``dim``:
          each rank stores its (padded) piece, all-gathers it for the
          forward, and its gradient is reduce-scattered;
        * ``zero1``: a PS variable whose optimizer state is split along
          ``dim``: the gradient is reduce-scattered onto this rank's
          state shard, the shard updated, the parameter all-gathered;
        * ``ar``: everything else (and PS with ``gspmd_update``): a mean
          all-reduce of the whole gradient, a whole local update.

        On a data axis of one device every variable but a stale one is
        ``ar``: there is nothing to split. Each synchronizer decides its
        own (``Synchronizer.kind``)."""
        n = self.data_axis_size
        return {name: s.kind(n) for name, s in self.synchronizers.items()}

    def opt_state_specs(self):
        """PartitionSpec of each variable's optimizer state, congruent with
        the params tree: its synchronizer's ``state_spec`` (the ZeRO-1
        placement of PS variables), replicated for the others. A torch
        optimizer keeps one state per parameter tensor, so every state
        leaf maps to its variable."""
        return self._spec_tree(lambda s: s.state_spec())

    def param_placements(self):
        """:class:`Placement` tree congruent with the params tree (the
        counterpart of ``param_shardings()``): a parameter partitioned over
        the data axis (kind ``fsdp``) is split in ``data_axis_size`` pieces
        along its dim, the rest stay whole on every device; uneven dims are
        padded first. A stale variable is whole (each rank holds its own
        copy), and so is a PS one with ``gspmd_update``. Only the
        data axis carries pieces: a parameter split over another mesh axis
        of more than one device raises (tensor parallelism is not ported,
        ROADMAP.md Queue A item 10)."""
        mesh = self.mesh
        if mesh.size == 1 or mesh.device_mesh is not None:
            device = mesh.local_device
            index = mesh.axis_index(const.MESH_AXIS_DATA)
        else:
            device = index = None
        n = self.data_axis_size
        paddings = self.paddings()
        kinds = self.var_kinds()

        def place(path, _):
            name = path_to_name(path)
            sync = self.synchronizers.get(name)
            spec = PartitionSpec() if sync is None or sync.staleness > 0 \
                else sync.param_spec()
            for entry in spec:
                for axis in (entry if isinstance(entry, tuple) else
                             (entry,)):
                    if axis not in (None, const.MESH_AXIS_DATA) and \
                            mesh.shape.get(axis, 1) > 1:
                        raise NotImplementedError(
                            f"{name} is split over mesh axis '{axis}': "
                            f"tensor parallelism is not ported to "
                            f"autodist_tpu_torch yet (ROADMAP.md, Queue A "
                            f"item 10)")
            kind, dim = kinds.get(name, ("ar", None))
            if kind != "fsdp":
                dim = None
            return Placement(device, dim, index, n if dim is not None else 1,
                             paddings.get(name))
        return tree_map_with_path(place, self.graph_item.params)

    def paddings(self):
        """Physical padding plan for uneven (non-divisible) shardings:
        {var_name: (dim, logical_size, padded_size)}. A dim that the
        parameter's or the optimizer state's spec splits over n devices
        and that n does not divide is stored padded to a multiple (the lcm
        of the splits), each piece rounded up to 128 rows where the JAX
        package does (the second-minor dim, or a vector), so the stored
        shapes match the JAX package's. Stale variables are not padded
        (each rank holds its whole copy). Empty on a one-device mesh."""
        plan = {}
        for name, sync in self.synchronizers.items():
            if sync.staleness > 0:
                continue
            var = sync.var
            per_dim = {}
            for spec in (sync.param_spec(), sync.state_spec()):
                for dim, axes in enumerate(spec):
                    if axes is None:
                        continue
                    n = math.prod(self.mesh.shape[a] for a in
                                  ([axes] if isinstance(axes, str)
                                   else axes))
                    per_dim[dim] = math.lcm(per_dim.get(dim, 1), n)
            for dim, n in per_dim.items():
                d = var.shape[dim]
                if d % n == 0:
                    continue
                align = 128 if (len(var.shape) == 1 or
                                dim == len(var.shape) - 2) else 1
                shard = -(-d // n)
                shard = -(-shard // align) * align
                prev = plan.get(name)
                if prev is not None and prev[0] != dim:
                    raise ValueError(
                        f"{name}: uneven sharding on two dims ({prev[0]} "
                        f"and {dim}) is unsupported")
                plan[name] = (dim, d, shard * n)
        return plan

    def batch_specs(self, batch_example):
        """Every batch leaf's dim 0 on the data axis."""
        def spec_for(leaf):
            ndim = len(getattr(leaf, "shape", ()) or ())
            if ndim == 0:
                return PartitionSpec()
            return PartitionSpec(const.MESH_AXIS_DATA, *([None] * (ndim - 1)))
        return tree_map(spec_for, batch_example)

    @property
    def data_axis_size(self):
        return self.mesh.shape.get(const.MESH_AXIS_DATA, 1)

    @property
    def max_staleness(self):
        return max((s.staleness for s in self.synchronizers.values()),
                   default=0)


class GraphTransformer:
    """Builds the DistributedProgram (the reference's ``transform()``)."""

    def __init__(self, compiled_strategy, cluster, graph_item):
        self.strategy = compiled_strategy
        self.cluster = cluster
        self.graph_item = graph_item

    def transform(self):
        mesh = self.cluster.mesh
        nodes = {n.var_name: n for n in self.strategy.node_config}
        synchronizers = {}
        for var in self.graph_item.trainable_variables:
            node = nodes.get(var.name)
            if node is None:
                node = strategy_pb2.NodeConfig(var_name=var.name)
                node.all_reduce_synchronizer.SetInParent()
            synchronizers[var.name] = Synchronizer.create(var, node, mesh)
        for sync in synchronizers.values():
            sync.param_spec()  # a partition over a missing axis raises here
        use_explicit = any(s.needs_explicit_path
                           for s in synchronizers.values())
        for s in synchronizers.values():
            if s.staleness > 0 and s.pconfig.active:
                # Stale copies diverge per rank between syncs: a rank's
                # stale read is always the whole variable.
                logging.warning(
                    "staleness on %s: dropping its partitioning - stale "
                    "copies diverge per device and cannot also be sharded "
                    "across them", s.var.name)
                s.pconfig.num_shards = 1
        if const.ENV.AUTODIST_DUMP_GRAPHS.val:
            const.ensure_working_dirs()
            path = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR,
                                "1-strategy.txt")
            with open(path, "w") as f:
                f.write(str(self.strategy.proto))
        logging.info("GraphTransformer: %d vars, mesh=%s",
                     len(synchronizers), mesh.shape)
        return DistributedProgram(self.graph_item, self.strategy, mesh,
                                  synchronizers, use_explicit)
