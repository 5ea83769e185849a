"""AllReduce strategy: pure data parallelism with bucketed gradient reduction.

Counterpart of ``autodist_tpu/strategy/all_reduce_strategy.py``: every
trainable variable gets an AllReduceSynchronizer in fusion group
``i // chunk_size``. Training reduces each group's gradients as one
bucket (``runner.py``); serving reads the replicated placement.
"""
from autodist_tpu_torch.proto import strategy_pb2
from autodist_tpu_torch.strategy.base import StrategyBuilder

_AR = strategy_pb2.AllReduceSynchronizer
_SPECS = {"AUTO": _AR.Spec.AUTO, "ICI": _AR.Spec.ICI, "DCN": _AR.Spec.DCN,
          # Accepted aliases from reference-style configs:
          "NCCL": _AR.Spec.ICI, "RING": _AR.Spec.AUTO}
_COMPRESSORS = {name: getattr(_AR.Compressor, name) for name in (
    "NoneCompressor", "HorovodCompressor", "HorovodCompressorEF",
    "PowerSGDCompressor", "Int8Compressor", "Int8CompressorEF")}


class AllReduce(StrategyBuilder):
    """All trainable variables -> AllReduceSynchronizer.

    Args:
        chunk_size: variables per fusion group.
        all_reduce_spec: 'AUTO' | 'ICI' | 'DCN' (NCCL/RING accepted as aliases).
        compressor: one of ``_COMPRESSORS``.
    """

    def __init__(self, chunk_size=128, all_reduce_spec="AUTO",
                 compressor="NoneCompressor"):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if all_reduce_spec not in _SPECS:
            raise ValueError(f"unknown all_reduce_spec {all_reduce_spec}")
        if compressor not in _COMPRESSORS:
            raise ValueError(f"unknown compressor {compressor}")
        self._chunk_size = chunk_size
        self._spec = _SPECS[all_reduce_spec]
        self._compressor = _COMPRESSORS[compressor]

    def build(self, graph_item, resource_spec):
        strategy = self._base_strategy(resource_spec)
        for i, var in enumerate(graph_item.trainable_variables):
            node = strategy.proto.node_config.add(var_name=var.name)
            node.all_reduce_synchronizer.spec = self._spec
            node.all_reduce_synchronizer.compressor = self._compressor
            node.all_reduce_synchronizer.group = i // self._chunk_size
        return strategy
