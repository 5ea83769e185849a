"""Multi-process telemetry aggregation over the c10d store.

Counterpart of ``autodist_tpu/observability/cluster.py``. Per-rank
snapshots (metrics + phase totals + flight-recorder tail + the ledgers'
summaries) ship to the chief over the SAME channel strategy artifacts
ship on (``AutoDist._ship_or_fetch_strategy``): the default process
group's c10d store, where the JAX package uses the coordination service's
key-value store. Everything here is fail-open: no store, a slow rank or a
JSON hiccup degrades the chief's view to fewer ranks, never to a dead run
(a rank whose snapshot does not arrive within the timeout is named in a
warning and a ``straggler`` flight event).

Key discipline mirrors strategy shipping: a PROCESS-global sequence
counter (every rank runs the same script, so their ``sync`` call
sequences agree) plus the rank, so keys never repeat within one store's
lifetime.
"""
import datetime
import itertools
import json
import os
import time

from autodist_tpu_torch.utils import logging

_seq = itertools.count(1)
_gathered = []   # chief: the snapshots from the most recent sync()
_GATHER_TIMEOUT_MS = 10_000


def local_snapshot():
    """This process's telemetry snapshot (JSON-serializable dict)."""
    from autodist_tpu_torch.observability import metrics, recorder, tracing
    snap = {"host": tracing.process_index(), "pid": os.getpid(),
            "time": round(time.time(), 3)}
    snap.update(metrics.registry().snapshot())
    snap["phases"] = tracing.phase_summary()
    snap["events"] = recorder.events(limit=50)
    try:
        from autodist_tpu_torch.observability import attribution
        summ = attribution.last_summary()
        if summ:
            snap["attribution"] = summ
    except Exception:  # noqa: BLE001 - snapshot must always assemble
        pass
    try:
        from autodist_tpu_torch.observability import goodput
        g = goodput.last_summary()
        if g:
            snap["goodput"] = {k: g.get(k) for k in
                               ("run_id", "generation", "wall_ms",
                                "goodput_ms", "goodput_pct", "mfu", "hfu",
                                "classes")}
    except Exception:  # noqa: BLE001 - snapshot must always assemble
        pass
    try:
        from autodist_tpu_torch.observability import memory
        m = memory.last_summary()
        if m:
            snap["memory"] = {k: m.get(k) for k in
                              ("predicted_peak_gb", "measured_peak_gb",
                               "prediction_error_pct", "capacity_gb",
                               "feasible", "dominant_class",
                               "measured_source")}
    except Exception:  # noqa: BLE001 - snapshot must always assemble
        pass
    return snap


def _store():
    """The default process group's c10d store, or ``None``."""
    try:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return dist.distributed_c10d._get_default_store()
    except Exception:  # noqa: BLE001 - no store: the chief sees itself only
        return None


def sync(timeout_ms=None):
    """Snapshot exchange; call at the same point on every rank (end of
    ``Runner.run``).

    Workers publish their snapshot; the chief waits for every worker's
    (``timeout_ms``, default 10 s, for all of them together) and returns
    the full list (its own first). One process, or no store, returns
    ``[local_snapshot()]``. A worker never waits, so ranks that reach
    this at different times cannot deadlock: the chief's wait is bounded
    and a missing rank is left out, with a ``straggler`` flight event.
    """
    global _gathered
    from autodist_tpu_torch.observability import tracing
    snap = local_snapshot()
    nprocs, pidx = tracing.process_count(), tracing.process_index()
    if nprocs <= 1:
        _gathered = [snap]
        return _gathered
    store = _store()
    if store is None:
        logging.warning("telemetry sync: no c10d store; the chief's view "
                        "covers this rank only")
        _gathered = [snap]
        return _gathered
    seq = next(_seq)
    timeout_ms = timeout_ms or _GATHER_TIMEOUT_MS
    try:
        if pidx != 0:
            store.set(f"autodist/telemetry/{seq}/{pidx}",
                      json.dumps(snap, default=str))
            _gathered = [snap]
            return _gathered
        out = [snap]
        deadline = time.monotonic() + timeout_ms / 1e3
        for w in range(1, nprocs):
            key = f"autodist/telemetry/{seq}/{w}"
            try:
                left = max(0.001, deadline - time.monotonic())
                store.wait([key], datetime.timedelta(seconds=left))
                out.append(json.loads(store.get(key).decode("utf-8")))
                store.delete_key(key)
            except Exception as e:  # noqa: BLE001 - missing rank, not dead run
                logging.warning("telemetry sync: no snapshot from rank %d "
                                "(%s)", w, e)
                try:
                    from autodist_tpu_torch.observability import recorder
                    recorder.record("straggler", f"telemetry sync: no "
                                    f"snapshot from rank {w} within "
                                    f"{timeout_ms} ms")
                except Exception:  # noqa: BLE001
                    pass
        _gathered = out
        return out
    except Exception as e:  # noqa: BLE001 - fail-open end to end
        logging.warning("telemetry sync failed: %s", e)
        _gathered = [snap]
        return _gathered


def gathered():
    """The most recent sync() result seen by this process (chief: all
    hosts; worker / never-synced: possibly empty)."""
    return list(_gathered)


def _ingest(snapshots):
    """Replace the gathered set (test harness hook + report injection)."""
    global _gathered
    _gathered = list(snapshots)

