"""Parallax hybrid strategy: dense -> AllReduce, sparse -> sharded PS.

Counterpart of ``autodist_tpu/strategy/parallax_strategy.py`` (the
technique of arXiv:1808.02621, and the JAX package's BERT benchmark
configuration): a variable the program gathers rows of
(``var.sparse_access``, an embedding table) goes to PS, partitioned along
its vocabulary axis where dim 0 divides, so its gradient reduce-scatters
instead of all-reducing at full density; every other variable rides the
all-reduce in fusion groups of ``chunk_size``.
"""
from autodist_tpu_torch.strategy.all_reduce_strategy import (_COMPRESSORS,
                                                              _SPECS)
from autodist_tpu_torch.strategy.partitioned_ps_strategy import get_num_shards
from autodist_tpu_torch.strategy.ps_strategy import PSBuilderBase, add_parts


class Parallax(PSBuilderBase):
    """Hybrid dense/sparse synchronization."""

    def __init__(self, chunk_size=128, local_proxy_variable=False, sync=True,
                 staleness=0, all_reduce_spec="AUTO",
                 compressor="NoneCompressor", gspmd_update=False):
        super().__init__(local_proxy_variable, sync, staleness, gspmd_update)
        self._chunk_size = chunk_size
        self._spec = _SPECS[all_reduce_spec]
        self._compressor = _COMPRESSORS[compressor]

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        max_shards = max(1, len(resource_spec.accelerator_devices))
        dense_idx = 0
        for var in graph_item.trainable_variables:
            node = strategy.proto.node_config.add(var_name=var.name)
            if var.sparse_access:
                self._set_ps(node)
                num_shards = get_num_shards(var, max_shards)
                if num_shards > 1:
                    add_parts(node, num_shards)
            else:
                node.all_reduce_synchronizer.spec = self._spec
                node.all_reduce_synchronizer.compressor = self._compressor
                node.all_reduce_synchronizer.group = \
                    dense_idx // self._chunk_size
                dense_idx += 1
        return strategy
