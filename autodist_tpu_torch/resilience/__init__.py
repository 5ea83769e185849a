"""Resilience: survive faults instead of merely detecting them.

Counterpart of ``autodist_tpu/resilience/``:

* :mod:`~autodist_tpu_torch.resilience.guard`: the NaN/Inf step guard with
  rollback (to an in-memory snapshot or the last good checkpoint) and a
  strikes-then-abort policy;
* :mod:`~autodist_tpu_torch.resilience.preemption`: SIGTERM/SIGINT =>
  emergency checkpoint before exit;
* :mod:`~autodist_tpu_torch.resilience.retry`: jittered exponential
  backoff for strategy shipping and checkpoint I/O;
* :mod:`~autodist_tpu_torch.resilience.supervision`: worker-death
  policies for the Coordinator (abort | restart-worker |
  checkpoint-and-exit | elastic);
* :mod:`~autodist_tpu_torch.resilience.chaos`: deterministic fault
  injection (``AUTODIST_CHAOS``), so every recovery path can be driven.

Every recovery action is recorded with :func:`record_event` (and on the
flight recorder, ``observability.recorder``).
"""
import threading
import time

_events = []
_events_lock = threading.Lock()


def record_event(kind, detail=""):
    """Append a resilience event (rollback, retry, preemption save, ...).

    Kept tiny: called from retry loops and after signals, so no
    logging-module machinery and no allocation beyond the tuple. Events
    also forward onto the observability flight recorder (the unified,
    bounded, JSONL-backed bus) when telemetry is on; this list stays as
    the always-on in-process trail."""
    with _events_lock:
        _events.append((time.time(), str(kind), str(detail)))
    try:
        from autodist_tpu_torch import observability
        observability.record_event(kind, detail, source="resilience")
    except Exception:  # noqa: BLE001 - called after signals; never raise
        pass


def events():
    """Snapshot of recorded resilience events as (unix_time, kind, detail)."""
    with _events_lock:
        return list(_events)


def clear_events():
    """Reset the event log (test harness hook)."""
    with _events_lock:
        _events.clear()


from autodist_tpu_torch.resilience.retry import (  # noqa: E402
    RetryPolicy, retry_call, retryable)
from autodist_tpu_torch.resilience.guard import (  # noqa: E402
    DivergenceAbort, StepGuard)
from autodist_tpu_torch.resilience.preemption import (  # noqa: E402
    Preempted, PreemptionHandler)
from autodist_tpu_torch.resilience.supervision import (  # noqa: E402
    AbortPolicy, CheckpointAndExitPolicy, ElasticPolicy, ElasticReform,
    RestartPolicy, supervision_policy)

__all__ = [
    "record_event", "events", "clear_events",
    "RetryPolicy", "retry_call", "retryable",
    "StepGuard", "DivergenceAbort",
    "PreemptionHandler", "Preempted",
    "AbortPolicy", "RestartPolicy", "CheckpointAndExitPolicy",
    "ElasticPolicy", "ElasticReform",
    "supervision_policy",
]
