"""GraphTransformer: (GraphItem, Strategy, Mesh) -> DistributedProgram.

Counterpart of ``autodist_tpu/kernel/graph_transformer.py``, for the
serving slice: the program carries each parameter's placement (a
PartitionSpec from its node config through ``partitioner.py``), the
padding plan of uneven shards, and the batch's data-axis split — the
members the serve engine reads. The per-variable ``Synchronizer`` objects
and the explicit (compressed / stale) gradient path are about gradients
and come with the training slice (ROADMAP.md).
"""
import math
import os

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.partitioner import (PartitionerConfig,
                                                   PartitionSpec,
                                                   param_partition_spec)
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import (path_to_name, tree_map,
                                           tree_map_with_path)


class DistributedProgram:
    """Distribution plan for one captured program on one mesh."""

    def __init__(self, graph_item, strategy, mesh, specs):
        self.graph_item = graph_item
        self.strategy = strategy
        self.mesh = mesh
        self._specs = specs  # {var_name: PartitionSpec}

    def param_specs(self):
        """PartitionSpec tree congruent with the params tree."""
        return tree_map_with_path(
            lambda path, _: self._specs.get(path_to_name(path),
                                            PartitionSpec()),
            self.graph_item.params)

    def param_placements(self):
        """``torch.device`` tree congruent with the params tree (the
        counterpart of ``param_shardings()``). This slice places on a
        one-device mesh; spanning devices needs the training slice's
        ``torch.distributed`` world."""
        if self.mesh.size != 1:
            raise NotImplementedError(
                f"placing params over a {self.mesh.size}-device mesh needs "
                f"torch.distributed, which lands with the training slice; "
                f"serve with one replica per device (replicas=N)")
        device = self.mesh.devices.flat[0]
        return tree_map(lambda _: device, self.graph_item.params)

    def paddings(self):
        """Physical padding plan for uneven (non-divisible) shardings:
        {var_name: (dim, logical_size, padded_size)}, shards rounded up to
        128 rows where the JAX package does. Empty on a one-device mesh."""
        plan = {}
        for var in self.graph_item.trainable_variables:
            for dim, axes in enumerate(self._specs.get(var.name, ())):
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


class GraphTransformer:
    """Builds the DistributedProgram (the reference's ``transform()``)."""

    def __init__(self, compiled_strategy, cluster, graph_item):
        self.strategy = compiled_strategy
        self.cluster = cluster
        self.graph_item = graph_item

    def _partition_axis(self, mesh):
        """Mesh axis carrying parameter shards: 'model' when present and
        larger than 1, else 'data'."""
        if mesh.shape.get(const.MESH_AXIS_MODEL, 1) > 1:
            return const.MESH_AXIS_MODEL
        return const.MESH_AXIS_DATA

    def transform(self):
        mesh = self.cluster.mesh
        nodes = {n.var_name: n for n in self.strategy.node_config}
        specs = {}
        for var in self.graph_item.trainable_variables:
            node = nodes.get(var.name)
            pconfig = PartitionerConfig.from_string(
                node.partitioner if node is not None else "")
            if not pconfig.active:
                specs[var.name] = PartitionSpec()
                continue
            axis = pconfig.mesh_axis or self._partition_axis(mesh)
            for name in (axis,) + tuple(m for _a, _n, m in pconfig.extras
                                        if m):
                if name not in mesh.axis_names:
                    raise ValueError(
                        f"strategy partitions {var.name} over mesh axis "
                        f"'{name}', but the built mesh has axes "
                        f"{mesh.axis_names}")
            specs[var.name] = param_partition_spec(
                var, pconfig, axis, mesh.shape[axis],
                mesh_sizes=dict(mesh.shape))
        if const.ENV.AUTODIST_DUMP_GRAPHS.val:
            const.ensure_working_dirs()
            path = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR,
                                "1-strategy.txt")
            with open(path, "w") as f:
                f.write(str(self.strategy.proto))
        logging.info("GraphTransformer: %d vars, mesh=%s", len(specs),
                     mesh.shape)
        return DistributedProgram(self.graph_item, self.strategy, mesh, specs)
