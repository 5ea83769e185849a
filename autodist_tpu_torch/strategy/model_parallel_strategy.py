"""ModelParallel: tensor (or expert) parallelism composed over any base
strategy.

Counterpart of ``autodist_tpu/strategy/model_parallel_strategy.py``, with
the same proto: the base builder's per-variable synchronization, a
``model`` (or ``expert``) axis carved out of ``data``
(``graph_config.mesh_axes``), and the rules' partitioners on the matched
weights (``parallel/sharding_rules.py``). Each rank of a model (expert)
group stores its piece of every split weight; the model layers run the
Megatron forms (the MoE layer its experts) on the pieces and the Runner
gathers the other split weights at use.

Usage::

    ad = AutoDist(strategy_builder=ModelParallel(PS(), model_axis=2))
    ad = AutoDist(strategy_builder=ModelParallel(
        AllReduce(), model_axis=2, rules=moe.EXPERT_RULES,
        mesh_axis="expert"))
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.sharding_rules import (MEGATRON_RULES,
                                                        apply_sharding_rules)
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import StrategyBuilder, carve_mesh_axis


class ModelParallel(StrategyBuilder):
    """Overlay tensor-parallel partitioners on a base strategy.

    Args:
        base: StrategyBuilder deciding sync methods (default AllReduce).
        model_axis: size of the ``model`` mesh axis.
        rules: optional override of the (regex, weight-dim) rule table.
        mesh_axis: the axis the rules split over: ``"model"``, or
            ``"expert"`` for the MoE overlay (``rules=moe.EXPERT_RULES``:
            each rank of an expert group stores and computes E/size
            experts, ``parallel/moe.py``).
    """

    def __init__(self, base=None, model_axis=2, rules=None,
                 mesh_axis=const.MESH_AXIS_MODEL):
        self._base = base or AllReduce()
        self._model_axis = model_axis
        self._rules = rules or MEGATRON_RULES
        self._mesh_axis = mesh_axis

    def build(self, graph_item, resource_spec):
        strategy = self._base.build(graph_item, resource_spec)
        carve_mesh_axis(strategy, resource_spec, self._mesh_axis,
                        self._model_axis)
        return apply_sharding_rules(strategy, graph_item, self._model_axis,
                                    self._rules, mesh_axis=self._mesh_axis)
