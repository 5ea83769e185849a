"""Compatibility shim: the pipeline schedule lives in the
:mod:`autodist_tpu_torch.pipeline` subsystem (``pipeline/schedule.py``);
``from autodist_tpu_torch.parallel.pipeline import pipeline_apply`` keeps
working through this re-export, as in the JAX package.
"""
from autodist_tpu_torch.pipeline.schedule import (  # noqa: F401
    SCHEDULES, bubble_fraction, num_schedule_steps, pipeline_apply,
    stack_stage_params)

__all__ = ["SCHEDULES", "bubble_fraction", "num_schedule_steps",
           "pipeline_apply", "stack_stage_params"]
