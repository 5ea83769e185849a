"""Observability: metrics, phase tracing, flight recorder, and the ledgers.

Counterpart of ``autodist_tpu/observability/``, its in-process half: what
a training run records about itself. Three pillars, one switch
(``AUTODIST_TELEMETRY``, default on, as in the JAX package):

* :mod:`~autodist_tpu_torch.observability.metrics` — a low-overhead
  registry (counters, gauges, time-window histograms) fed by the Runner's
  step loop (step latency, examples/s, data wait, graph capture time,
  padding bytes) and by the strategy-ship / checkpoint paths;
* :mod:`~autodist_tpu_torch.observability.tracing` — context-manager
  spans around every framework phase (capture -> strategy build ->
  transform -> compile -> ship -> restore -> step loop), emitted as
  Chrome trace-event JSON into ``DEFAULT_TRACE_DIR``, with an opt-in
  ``torch.profiler`` bridge (``AUTODIST_TRACE=profiler``);
* :mod:`~autodist_tpu_torch.observability.recorder` — a bounded JSONL
  flight recorder unifying the resilience event trail with compile /
  checkpoint / ship events, gathered per rank on the chief over the c10d
  store (:mod:`~autodist_tpu_torch.observability.cluster`).

On top of the pillars:

* :mod:`~autodist_tpu_torch.observability.attribution` — the step-time
  ledger: measured wall step time reconciled into ``data_wait +
  host_dispatch + device_compute + exposed_comms + residual`` (``attr.*``
  gauges), feeding per-term calibration (``tuner/calibration.py``);
* :mod:`~autodist_tpu_torch.observability.goodput` — the run-level
  goodput & MFU ledger (``goodput.*`` gauges, segments stitched across
  re-exec generations through ``AUTODIST_RUN_ID``);
* :mod:`~autodist_tpu_torch.observability.memory` — the HBM ledger:
  predicted per-device peak by class (``tuner/cost_model.strategy_memory``)
  against allocator samples, feasibility (the serving engines' bucket
  refusal), and OOM forensics (``mem.*`` gauges, ``logs/oom_report.json``);
* :mod:`~autodist_tpu_torch.observability.profile` — the per-layer
  profile: the ledger's device terms split per model scope, measured from
  the ``torch.profiler`` trace under ``AUTODIST_TRACE=profiler``
  (``profile.*`` gauges);
* :mod:`~autodist_tpu_torch.observability.skew` — the cross-rank clock
  sync over the c10d store and the wire-vs-skew-wait split of exposed
  comms (``skew.*`` gauges);
* :mod:`~autodist_tpu_torch.observability.monitor` — the chief's live
  ``/metrics`` + ``/status`` endpoint (``AUTODIST_MONITOR_PORT``) and the
  rolling anomaly detector :func:`sync_cluster` feeds.

Not ported yet (ROADMAP.md, A11b (ii)): the report that renders all of
this, and the offline timeline and trend tools.

Contract: **off-path cheap** (the Runner's loop records one CUDA event or
clock read and a list append per dispatch and flushes on the StepGuard
cadence; with telemetry disabled the loop makes ZERO telemetry calls) and
**fail-open** (no telemetry error may kill a run).
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.observability import (attribution, cluster, goodput,
                                              memory, metrics, monitor,
                                              profile, recorder, skew,
                                              tracing)

_enabled_cache = None


def enabled():
    """Whether telemetry is on (``AUTODIST_TELEMETRY``; cached — call
    :func:`refresh` after flipping the env var mid-process)."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = bool(const.ENV.AUTODIST_TELEMETRY.val)
    return _enabled_cache


def refresh():
    """Re-read the telemetry env knobs (test harness hook)."""
    global _enabled_cache
    _enabled_cache = None
    tracing.refresh()


def span(name, **args):
    """Phase span context manager; a shared no-op when telemetry is off."""
    if not enabled():
        return tracing.NULL_SPAN
    return tracing.Span(name, args)


def record_event(kind, detail="", **fields):
    """Append to the flight recorder (no-op when telemetry is off)."""
    if enabled():
        recorder.record(kind, detail, **fields)


def registry():
    """The process-global metrics registry (callers on hot paths must
    gate on :func:`enabled` themselves — see Runner.run)."""
    return metrics.registry()


def phase_timings():
    """{phase: {"start_ms", "total_ms", "count"}}."""
    return tracing.phase_summary()


def flush_trace(path=None):
    """Flush buffered spans to a Chrome-trace JSON file; returns the path
    (or ``None`` when tracing is off / nothing buffered / unwritable)."""
    if not enabled():
        return None
    return tracing.flush(path)


def sync_cluster(timeout_ms=None):
    """Exchange per-rank snapshots (the chief gathers); fail-open. Every
    rank reaches this at the same point (the end of ``Runner.run``), so
    the clock-sync ping runs first; then the chief decomposes the
    gathered dispatch windows into wire vs skew-wait (``skew``) and feeds
    the set to the rolling anomaly detector (``monitor``), whose newly
    raised anomalies land on the flight recorder."""
    if not enabled():
        return []
    skew.maybe_sync_clocks()
    snaps = cluster.sync(timeout_ms=timeout_ms)
    skew.update_from_snapshots(snaps)
    monitor.observe_cluster(snaps)
    return snaps


def snapshot():
    """This process's telemetry snapshot (JSON-serializable)."""
    return cluster.local_snapshot()


def reset():
    """Clear metrics, spans, and the event bus (test harness hook)."""
    metrics.registry().reset()
    tracing.clear()
    recorder.clear()
    cluster._ingest([])
    attribution.reset()
    profile.reset()
    goodput.reset()
    memory.reset()
    skew.reset()
    monitor.reset_detector()


__all__ = [
    "enabled", "refresh", "span", "record_event", "registry",
    "phase_timings", "flush_trace", "sync_cluster", "snapshot", "reset",
    "metrics", "tracing", "recorder", "cluster", "attribution", "monitor",
    "profile", "goodput", "memory", "skew",
]
