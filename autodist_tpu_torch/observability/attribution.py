"""Step-time attribution ledger: account for every millisecond.

Counterpart of ``autodist_tpu/observability/attribution.py``. On CUDA the
Runner reads each dispatch's wall time from ``torch.cuda.Event``s recorded
after the dispatches (the interval between the completions of consecutive
dispatches on the device), not from host clock deltas, which would time
only the asynchronous enqueue; ``data_wait`` stays on the host clock.

The raw gauges answer "how slow" (``step.latency_ms``) and "how starved"
(``step.data_wait_ms``) but nothing reconciles them: a 12 ms step could
be 2 ms of input stall, 0.6 ms of host dispatch, 8 ms of device compute,
1 ms of exposed collectives — or something unmodeled.  This module
decomposes measured wall step time into named causes::

    wall = data_wait + host_dispatch + device_compute
           + exposed_comms + residual

* ``data_wait`` — measured: host time blocked fetching the next batch
  (the runner's per-dispatch ``next()`` clock, same source as
  ``step.data_wait_ms``);
* ``host_dispatch`` — per-dispatch host overhead (dispatch + batch
  placement + clock reads), sourced from a calibration's persisted
  ``host_dispatch_ms`` when one exists, else the cost model's
  ``DISPATCH_MS`` seed — amortized by ``unroll``;
* ``device_compute`` — the cost model's FLOPs + optimizer-HBM roofline
  for this program (``tuner/cost_model``, seeded with the H100's
  datasheet figures), scaled by the per-term compute calibration;
* ``exposed_comms`` — this rank's measured exposed collective time where
  the loop was profiled (``torch-profiler``: ``kernel/overlap.py``'s
  windows over the trace, where the JAX package prices its scheduled
  HLO), else the cost model's sync estimate;
* ``residual`` — whatever is left, **surfaced, never absorbed**: the
  components plus the residual sum to the measured wall time exactly
  (a tier-1 invariant test pins it).  A large positive residual means
  the model misses real work; a negative one means it over-prices.

The residual closes the calibration loop *per term*
(:meth:`~autodist_tpu_torch.tuner.calibration.Calibration.observe_term`):
measured-compute (wall minus the measured/overhead terms) refines the
compute scale, and a measured exposed-comms term refines the comms
scale — so the tuner learns *which* cost-model term is wrong, not
just a single global fudge factor.

Everything here rides the cold path (the runner feeds the ledger on the
StepGuard flush cadence and finalizes once per ``run``); with
``AUTODIST_TELEMETRY=0`` no ledger is ever constructed and the step loop
makes zero attribution calls (test-pinned).
"""
import contextlib
from typing import NamedTuple

from autodist_tpu_torch.utils import logging

# Component keys, in render order (report / monitor / bench reuse this).
COMPONENTS = ("data_wait_ms", "host_dispatch_ms", "device_compute_ms",
              "exposed_comms_ms", "residual_ms")

_last_summary = None


class ModelTerms(NamedTuple):
    """Model-sourced attribution terms (ms; compute/comms are per STEP,
    host_dispatch is per DISPATCH).  ``raw_*`` carry the unscaled model
    predictions the per-term calibration folds residuals against;
    ``sources`` records where each term came from (report/bench honesty:
    a term estimated from seeds reads differently than a measured one).
    """
    host_dispatch_ms: float = 0.0
    device_compute_ms: float = 0.0
    exposed_comms_ms: float = 0.0
    raw_compute_ms: float = 0.0
    raw_comms_ms: float = 0.0
    sources: dict = {}


class Ledger:
    """Per-dispatch accumulator reconciling wall time into components.

    Unroll-aware: a ``unroll=K`` megastep hands ``observe`` one wall
    delta covering K steps; everything is normalized per-step in
    :meth:`summary` (host dispatch amortizes by K — the whole point of
    fused dispatch — while data-wait is measured per dispatch and
    divided by the steps it fed).
    """

    def __init__(self, terms=None, unroll=1):
        self.terms = terms if terms is not None else ModelTerms()
        self.unroll = max(1, int(unroll))
        self._wall_ms = 0.0
        self._wait_ms = 0.0
        self._steps = 0
        self._dispatches = 0

    def observe(self, wall_ms, data_wait_ms, steps=None):
        """Fold one dispatch: ``wall_ms`` covers ``steps`` fused steps
        (default: the ledger's unroll) and includes ``data_wait_ms`` of
        host time blocked fetching the batch/block."""
        steps = int(steps) if steps else self.unroll
        self._wall_ms += float(wall_ms)
        self._wait_ms += float(data_wait_ms)
        self._steps += max(1, steps)
        self._dispatches += 1

    @property
    def steps(self):
        return self._steps

    def summary(self):
        """Per-step attribution (ms).  The invariant — components sum to
        the measured wall time — holds by construction: ``residual`` is
        defined as the unexplained remainder and may be negative (the
        model over-priced), which is information, not an error."""
        if not self._steps:
            return {}
        t = self.terms
        wall = self._wall_ms / self._steps
        wait = self._wait_ms / self._steps
        dispatch = t.host_dispatch_ms / self.unroll
        residual = wall - (wait + dispatch + t.device_compute_ms +
                           t.exposed_comms_ms)
        return {
            "wall_ms": round(wall, 5),
            "data_wait_ms": round(wait, 5),
            "host_dispatch_ms": round(dispatch, 5),
            "device_compute_ms": round(t.device_compute_ms, 5),
            "exposed_comms_ms": round(t.exposed_comms_ms, 5),
            "residual_ms": round(residual, 5),
            "raw_compute_ms": round(t.raw_compute_ms, 5),
            "raw_comms_ms": round(t.raw_comms_ms, 5),
            "steps": self._steps,
            "dispatches": self._dispatches,
            "unroll": self.unroll,
            "sources": dict(t.sources),
        }


def terms_for_runner(runner, unroll=1):
    """Model terms for one Runner's program: fail-open, so any piece that
    cannot be priced degrades to 0 with the failure noted in ``sources``
    (the residual then absorbs that component, visibly).

    ``exposed_comms`` is this rank's measured ``comms.exposed_ms_per_step``
    where the step loop was profiled (``Runner._record_exposed_comms``:
    the collective kernels' time no compute covered, off the
    ``torch.profiler`` trace; ``sources["exposed_comms"] =
    "torch-profiler"``), so each rank has its own; else the cost model's
    estimate (with the Runner's overlap schedule and bucket cap), the same
    on every rank (``"cost-model"``)."""
    sources = {}
    unroll = max(1, int(unroll))
    cal = None
    try:
        from autodist_tpu_torch.tuner import calibration
        cal = calibration.Calibration.load(
            calibration.path_for(runner, unroll))
    except Exception as e:  # noqa: BLE001 - attribution must never kill a run
        sources["calibration"] = f"unavailable: {e}"

    from autodist_tpu_torch.tuner import cost_model as cm
    host_dispatch = cm.DISPATCH_MS
    sources["host_dispatch"] = "seed"
    if cal is not None and cal.host_dispatch_ms:
        host_dispatch = float(cal.host_dispatch_ms)
        sources["host_dispatch"] = "bench-calibrated"

    raw_compute = raw_comms = compute = comms = 0.0
    try:
        prog = runner.program
        topo = cm.Topology.for_mesh(prog.mesh)
        from autodist_tpu_torch.kernel import overlap as overlap_mod
        bd = cm.CostModel(topo).strategy_cost(
            prog.strategy, prog.graph_item, unroll=unroll,
            overlap=bool(getattr(runner, "_overlap", False)),
            bucket_bytes=overlap_mod.bucket_bytes_cap())
        raw_compute = bd["compute_ms"] + bd["update_ms"]
        raw_comms = bd["exposed_sync_ms"] + bd["overlay_ms"]
        compute = raw_compute * (cal.compute_scale if cal is not None else 1.0)
        comms = raw_comms * (cal.comms_scale if cal is not None else 1.0)
        sources["device_compute"] = "cost-model-roofline"
        sources["exposed_comms"] = "cost-model"
    except Exception as e:  # noqa: BLE001 - degrade to residual, visibly
        sources["cost_model"] = f"unavailable: {e}"

    try:
        from autodist_tpu_torch.observability import metrics
        gauges = metrics.registry().snapshot().get("gauges") or {}
        exposed = gauges.get("comms.exposed_ms_per_step")
        if exposed is not None:
            comms = float(exposed)
            sources["exposed_comms"] = "torch-profiler"
    except Exception:  # noqa: BLE001
        pass
    return ModelTerms(host_dispatch_ms=host_dispatch,
                      device_compute_ms=compute, exposed_comms_ms=comms,
                      raw_compute_ms=raw_compute, raw_comms_ms=raw_comms,
                      sources=sources)


# The exposed-comms sources that are measurements (the JAX package's
# scheduled HLO, the port's profiler windows), which refine the comms scale.
MEASURED_COMMS = ("scheduled-hlo", "torch-profiler")


def feed_calibration(summary, calibration=None, path=None):
    """Close the measured-vs-predicted loop per class, into
    ``calibration``, else into the file at ``path`` (the default one when
    None) under its lock.

    * compute: everything the ledger measured or charged elsewhere is
      subtracted from wall — what remains is the *measured* device
      compute, folded against the raw model roofline;
    * comms: only when the exposed-comms term was measured (the
      profiler's collective windows) does it refine the comms scale
      against the raw
      model sync estimate — a model-vs-itself comparison would teach
      nothing.  The measured side is **skew-corrected**: the barrier
      wait the skew decomposition attributed to a straggler rank
      (``skew.local_skew_wait_ms``) is subtracted first.
    """
    if not summary:
        return None
    try:
        measured_compute = (summary["wall_ms"] - summary["data_wait_ms"] -
                            summary["host_dispatch_ms"] -
                            summary["exposed_comms_ms"])
        feed_compute = (summary.get("raw_compute_ms", 0) > 0
                        and measured_compute > 0)
        # Skew-corrected: the barrier wait the skew decomposition put on
        # a straggler rank is not wire time (observability/skew.py).
        skew_wait = 0.0
        try:
            from autodist_tpu_torch.observability import skew
            skew_wait = float(skew.local_skew_wait_ms() or 0.0)
        except Exception:  # noqa: BLE001 - correction is best-effort
            pass
        measured_comms = max(
            0.0, summary.get("exposed_comms_ms", 0) - skew_wait)
        feed_comms = (summary.get("raw_comms_ms", 0) > 0
                      and measured_comms > 0
                      and (summary.get("sources") or {}).get(
                          "exposed_comms") in MEASURED_COMMS)
        with contextlib.ExitStack() as stack:
            if calibration is None:
                from autodist_tpu_torch.tuner.calibration import Calibration
                calibration = stack.enter_context(Calibration.locked(path))
            if feed_compute:
                calibration.observe_term("compute",
                                         summary["raw_compute_ms"],
                                         measured_compute,
                                         context="attribution")
            if feed_comms:
                calibration.observe_term("comms", summary["raw_comms_ms"],
                                         measured_comms,
                                         context="attribution")
        return calibration
    except Exception as e:  # noqa: BLE001 - calibration is best-effort
        logging.debug("attribution calibration feed failed: %s", e)
        return None


def finalize(ledger, registry=None, calibration_path=None):
    """End-of-run bookkeeping: publish the ``attr.*`` gauges, stash the
    summary for cluster snapshots / report / monitor / bench, feed the
    per-term calibration (the file at ``calibration_path``: the
    program's, from the Runner), and drop a flight-recorder event."""
    summary = ledger.summary()
    if not summary:
        return None
    if registry is not None:
        registry.gauge("attr.wall_ms").set(summary["wall_ms"])
        registry.gauge("attr.data_wait_ms").set(summary["data_wait_ms"])
        registry.gauge("attr.host_dispatch_ms").set(
            summary["host_dispatch_ms"])
        registry.gauge("attr.device_compute_ms").set(
            summary["device_compute_ms"])
        registry.gauge("attr.exposed_comms_ms").set(
            summary["exposed_comms_ms"])
        registry.gauge("attr.residual_ms").set(summary["residual_ms"])
    set_last_summary(summary)
    feed_calibration(summary, path=calibration_path)
    try:
        from autodist_tpu_torch.observability import recorder
        recorder.record(
            "attribution",
            " + ".join(f"{k.replace('_ms', '')} {summary[k]:.3f}"
                       for k in COMPONENTS)
            + f" = wall {summary['wall_ms']:.3f} ms/step "
              f"({summary['steps']} steps, unroll={summary['unroll']})")
    except Exception:  # noqa: BLE001 - telemetry must never kill a run
        pass
    return summary


def last_summary():
    """The most recent finalized attribution summary in this process
    (``None`` before the first observed step loop)."""
    return _last_summary


def set_last_summary(summary):
    global _last_summary
    _last_summary = summary


def reset():
    """Test harness hook."""
    set_last_summary(None)
