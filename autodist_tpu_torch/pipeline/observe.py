"""Pipeline observability closure: bubble accounting on the step loop.

Counterpart of ``autodist_tpu/pipeline/observe.py``. The port's executor
always commits the output by a broadcast from the last stage (``M + S -
1`` ticks), so its bubble is the GPipe one at every ``M``, where the JAX
executor's conveyor (``M % S == 0``) idles longer.

The schedule's idle (fill/drain) slots are priced explicitly so the
profiler story stays closed: the Runner's cold-path finalize calls
:func:`finalize` once per observed step loop, which prices the measured
step p50 into a bubble share using the schedule model
(``(S-1)/(S+M-1)``) and publishes the ``pipeline.*``
gauges the monitor's ``/status`` pipeline section reads
(:func:`status_section`) and the transform report's pipeline section
(``report._render_pipeline``).  Telemetry off
(``AUTODIST_TELEMETRY=0``) never reaches this module — the zero-call
contract test spies on it.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.pipeline import cutter, schedule
from autodist_tpu_torch.utils import logging


def pipeline_shape(program):
    """``(stages, microbatches)`` of a transformed program, or ``(1, 0)``
    when its strategy does not pipeline."""
    gc = program.strategy.graph_config
    stages = dict(program.mesh.shape).get(const.MESH_AXIS_PIPELINE, 1)
    micro = int(gc.pipeline_microbatches or 0)
    return (stages, micro) if stages > 1 and micro > 0 else (1, 0)


def predicted_bubble(stages, microbatches):
    """The port's schedule's idle-slot fraction: ``(S-1)/(M+S-1)`` (no
    conveyor: the port's executor always broadcasts)."""
    return schedule.bubble_fraction(stages, microbatches,
                                    sharded_commit=False)


def finalize(runner, reg):
    """Publish the ``pipeline.*`` gauges for one observed step loop.

    Cold-path only (rides the runner's end-of-loop bookkeeping); fail-open.
    """
    stages, micro = pipeline_shape(runner.program)
    if stages <= 1:
        return None
    bubble = predicted_bubble(stages, micro)
    cut = cutter.last_cut()
    imbalance = cut.imbalance if cut is not None else 0.0
    reg.gauge("pipeline.stages").set(stages)
    reg.gauge("pipeline.microbatches").set(micro)
    reg.gauge("pipeline.bubble_fraction").set(round(bubble, 4))
    bubble_ms = None
    try:
        p50 = reg.histogram("step.latency_ms").summary().get("p50")
        if p50:
            # The fill/drain share of the measured step: idle slots are
            # (bubble) of the schedule, stretched by stage imbalance.
            bubble_ms = float(p50) * bubble * (1.0 + imbalance)
            reg.gauge("pipeline.bubble_ms_per_step").set(round(bubble_ms, 4))
    except Exception as e:  # noqa: BLE001 - accounting must not kill runs
        logging.debug("pipeline bubble accounting skipped: %s", e)
    return {"stages": stages, "microbatches": micro,
            "bubble_fraction": round(bubble, 4),
            "bubble_ms_per_step": (round(bubble_ms, 4)
                                   if bubble_ms is not None else None),
            "imbalance": round(imbalance, 4)}


def status_section(reg):
    """The monitor ``/status`` pipeline row (``None`` when not pipelined)."""
    stages = reg.gauge("pipeline.stages").value
    if not stages:
        return None
    out = {"stages": int(stages),
           "microbatches": int(reg.gauge("pipeline.microbatches").value or 0),
           "bubble_fraction": reg.gauge("pipeline.bubble_fraction").value,
           "bubble_ms_per_step":
               reg.gauge("pipeline.bubble_ms_per_step").value}
    cut = cutter.last_cut()
    if cut is not None:
        out["imbalance"] = round(cut.imbalance, 4)
    return out
