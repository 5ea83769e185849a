"""Pipeline parallelism: stacked-stage GPipe over the ``pipe`` mesh axis.

Counterpart of ``autodist_tpu/pipeline/``: per-stage weights stacked on a
leading layer dim split over ``pipe`` (each rank stores and runs its
stage), microbatches driven through the stages by the schedule's ticks
with a hop a tick. Pieces:

* :mod:`~autodist_tpu_torch.pipeline.schedule` — the executor, one
  ``torch.autograd.Function`` a call (``pipeline_apply``), with the
  bitwise sequential control schedule and ``1f1b``;
* :mod:`~autodist_tpu_torch.pipeline.cutter` — stage and microbatch
  counts, and the balanced cut from the per-scope predicted costs
  (``GraphItem.op_provenance``), which also picks the stage count when
  nothing else fixes it.

* :mod:`~autodist_tpu_torch.pipeline.observe` — the ``pipeline.*``
  gauges (bubble accounting) the Runner's observed loop publishes, and
  the monitor's ``/status`` pipeline section over them.

The user-facing entry point is the
:class:`~autodist_tpu_torch.strategy.Pipeline` strategy builder.
"""
from autodist_tpu_torch.pipeline.cutter import (StageCut, cut_stages,  # noqa: F401
                                                last_cut, resolve_stages,
                                                set_last_cut,
                                                top_level_costs)
from autodist_tpu_torch.pipeline.schedule import (SCHEDULES,  # noqa: F401
                                                  bubble_fraction,
                                                  num_schedule_steps,
                                                  pipeline_apply,
                                                  resolve_skip_idle,
                                                  stack_stage_params)

__all__ = ["StageCut", "cut_stages", "last_cut", "resolve_stages",
           "set_last_cut", "top_level_costs", "SCHEDULES",
           "bubble_fraction", "num_schedule_steps", "pipeline_apply",
           "resolve_skip_idle", "stack_stage_params"]
