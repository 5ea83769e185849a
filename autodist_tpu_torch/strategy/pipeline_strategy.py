"""Pipeline: GPipe pipeline parallelism as a strategy.

Counterpart of ``autodist_tpu/strategy/pipeline_strategy.py``, with the
same proto: the user writes the stacked-blocks model (``ops.scan_blocks``,
one layer after another on one device); this builder (a) carves a
``pipe`` axis out of the mesh, (b) splits the stacked block variables over
it (partitioner ``"0:S:pipe"``: each rank stores its stage's L/S layers),
and (c) records the microbatch count in
``GraphConfig.pipeline_microbatches``, which the Runner's parallel context
carries to ``scan_blocks``, which then runs the same model on the
pipeline schedule (``pipeline/schedule.py``).

Stage-count resolution: an explicit ``num_stages`` wins, then
``AUTODIST_PIPELINE_STAGES``, then the spec's ``pipeline:`` mesh hint,
then the stage cutter's own choice from the model's per-scope predicted
FLOPs (``pipeline/cutter.py``). The microbatch count defaults to
``AUTODIST_MICROBATCHES``, else ``2 * num_stages``. The builder records
a ``pipeline`` flight event, as the JAX builder does.

Usage::

    ad = AutoDist(strategy_builder=Pipeline(
        num_stages=4, num_microbatches=8, base=AllReduce()))
    ad = AutoDist(strategy_builder=Pipeline())   # the cutter decides S
"""
import re

from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import StrategyBuilder, carve_mesh_axis
from autodist_tpu_torch.utils import logging

# The stacked-blocks layout puts every pipelined variable under a "blocks"
# subtree (models/transformer.py scan_layers).
DEFAULT_STAGE_PATTERN = r"(^|/)blocks/"


class Pipeline(StrategyBuilder):
    """Overlay GPipe pipelining on a base strategy.

    Args:
        num_stages: size of the ``pipe`` mesh axis (stage count). The
            model's stacked layer count must be a multiple of it. ``None``
            resolves via ``AUTODIST_PIPELINE_STAGES``, the spec's
            ``pipeline:`` mesh hint, then the stage cutter.
        num_microbatches: GPipe microbatch count M (bubble fraction
            (P-1)/(M+P-1)); defaults to ``AUTODIST_MICROBATCHES``, else
            2 * num_stages.
        base: StrategyBuilder deciding per-variable sync (default AllReduce).
        stage_pattern: regex over logical variable names selecting the
            stacked block variables to split over ``pipe``.
    """

    def __init__(self, num_stages=None, num_microbatches=None, base=None,
                 stage_pattern=DEFAULT_STAGE_PATTERN):
        if num_stages is not None and num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        self._num_stages = num_stages
        self._num_microbatches = num_microbatches
        self._base = base or AllReduce()
        self._stage_pattern = stage_pattern

    def build(self, graph_item, resource_spec):
        from autodist_tpu_torch.pipeline import cutter
        num_stages, source = cutter.resolve_stages(
            graph_item, resource_spec, explicit=self._num_stages)
        if num_stages < 2:
            raise ValueError(
                "Pipeline: could not resolve a stage count > 1 — pass "
                "num_stages=, set AUTODIST_PIPELINE_STAGES, or add a "
                "'pipeline:' mesh hint to the resource spec "
                "(docs/pipelining.md)")
        num_microbatches = cutter.resolve_microbatches(
            graph_item, num_stages, explicit=self._num_microbatches)

        strategy = self._base.build(graph_item, resource_spec)
        carve_mesh_axis(strategy, resource_spec, const.MESH_AXIS_PIPELINE,
                        num_stages)
        strategy.graph_config.pipeline_microbatches = num_microbatches

        pat = re.compile(self._stage_pattern)
        nodes = {n.var_name: n for n in strategy.node_config}
        n_sharded = 0
        for var in graph_item.trainable_variables:
            if not pat.search(var.name):
                continue
            node = nodes.get(var.name)
            if node is None:
                continue
            if var.shape and var.shape[0] % num_stages == 0:
                node.partitioner = \
                    f"0:{num_stages}:{const.MESH_AXIS_PIPELINE}"
                n_sharded += 1
            else:
                raise ValueError(
                    f"Pipeline: stacked variable {var.name} has leading dim "
                    f"{var.shape[0] if var.shape else None}, not a multiple "
                    f"of num_stages={num_stages}")
        if n_sharded == 0:
            raise ValueError(
                f"Pipeline: no variables matched stage_pattern "
                f"{self._stage_pattern!r}. Pipelined models must use the "
                f"stacked-blocks layout (ops.scan_blocks; e.g. "
                f"TransformerConfig(scan_layers=True)).")

        cut = cutter.cut_stages(graph_item, num_stages, source=source)
        cutter.set_last_cut(cut)
        from autodist_tpu_torch import observability
        from autodist_tpu_torch.pipeline.schedule import bubble_fraction
        observability.record_event(
            "pipeline",
            f"{num_stages}-stage ({source}) x {num_microbatches} "
            f"microbatches: bubble "
            f"{bubble_fraction(num_stages, num_microbatches):.3f}, "
            f"imbalance {cut.imbalance:.3f}, "
            f"{n_sharded} stacked vars over "
            f"'{const.MESH_AXIS_PIPELINE}'")
        return strategy
