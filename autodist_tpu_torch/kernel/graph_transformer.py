"""GraphTransformer: (GraphItem, Strategy, Mesh) -> DistributedProgram.

Counterpart of ``autodist_tpu/kernel/graph_transformer.py``: the program
carries one ``Synchronizer`` per trainable variable (its placement specs
and its gradient reduction), whether any of them needs the explicit
(compressed / stale) gradient path, each parameter's placement, the
padding plan of uneven shards, and the batch's data-axis split.
"""
import math
import os

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.partitioner import PartitionSpec
from autodist_tpu_torch.kernel.synchronization.synchronizer import \
    Synchronizer
from autodist_tpu_torch.proto import strategy_pb2
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import (path_to_name, tree_map,
                                           tree_map_with_path)


class DistributedProgram:
    """Distribution plan for one captured program on one mesh."""

    def __init__(self, graph_item, strategy, mesh, synchronizers,
                 use_explicit_path):
        self.graph_item = graph_item
        self.strategy = strategy
        self.mesh = mesh
        self.synchronizers = synchronizers  # {var_name: Synchronizer}
        self.use_explicit_path = use_explicit_path

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

    def param_placements(self):
        """``torch.device`` tree congruent with the params tree (the
        counterpart of ``param_shardings()``): every leaf on this process's
        device of the mesh, whole (the AllReduce strategy replicates)."""
        device = self.mesh.local_device
        return tree_map(lambda _: device, self.graph_item.params)

    def paddings(self):
        """Physical padding plan for uneven (non-divisible) shardings:
        {var_name: (dim, logical_size, padded_size)}, shards rounded up to
        128 rows where the JAX package does. Empty on a one-device mesh."""
        plan = {}
        for name, sync in self.synchronizers.items():
            var = sync.var
            for dim, axes in enumerate(sync.param_spec()):
                if axes is None:
                    continue
                n = math.prod(self.mesh.shape[a] for a in
                              ([axes] if isinstance(axes, str) else axes))
                d = var.shape[dim]
                if d % n == 0:
                    continue
                align = 128 if (len(var.shape) == 1 or
                                dim == len(var.shape) - 2) else 1
                shard = -(-d // n)
                shard = -(-shard // align) * align
                plan[var.name] = (dim, d, shard * n)
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
