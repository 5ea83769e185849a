"""SequenceParallel: sequence (context) parallelism as a strategy.

Counterpart of ``autodist_tpu/strategy/sequence_parallel_strategy.py``,
with the same proto: the base builder's per-variable synchronization, a
``seq`` axis carved out of ``data`` (``graph_config.mesh_axes``), and the
attention implementation in ``graph_config.seq_attn``. The Runner
activates it through the parallel context around the loss
(``parallel/context.py``), and the framework's attention resolver
(``models/transformer.py``) then runs ring or Ulysses attention over the
``seq`` group with no change to the model. Each rank of a seq group holds
its chunk of the sequence (``transformer.encode`` cuts it).

Usage::

    ad = AutoDist(strategy_builder=SequenceParallel(
        attn="ring", seq_axis=4, base=Parallax()))
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import StrategyBuilder, carve_mesh_axis


class SequenceParallel(StrategyBuilder):
    """Overlay sequence parallelism on a base strategy.

    Args:
        attn: "ring" (K/V blocks travel around the seq group, O(s/P)
            memory) or "ulysses" (all-to-all heads <-> sequence; needs
            heads % seq_axis == 0).
        seq_axis: size of the ``seq`` mesh axis.
        base: StrategyBuilder deciding per-variable sync (default AllReduce).
    """

    def __init__(self, attn="ring", seq_axis=2, base=None):
        if attn not in ("ring", "ulysses"):
            raise ValueError(f"attn must be 'ring' or 'ulysses', got {attn!r}")
        self._attn = attn
        self._seq_axis = seq_axis
        self._base = base or AllReduce()

    def build(self, graph_item, resource_spec):
        strategy = self._base.build(graph_item, resource_spec)
        carve_mesh_axis(strategy, resource_spec, const.MESH_AXIS_SEQ,
                        self._seq_axis)
        strategy.graph_config.seq_attn = self._attn
        return strategy
