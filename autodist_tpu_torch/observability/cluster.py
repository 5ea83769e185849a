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
        from autodist_tpu_torch.observability import skew
        payload = skew.local_payload()
        if payload:
            # The clock estimate + dispatch-window ring: the chief
            # decomposes every rank's exposed comms into wire vs skew-wait.
            snap["skew"] = payload
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


def aggregate(snapshots, now=None, straggler_factor=1.25,
              heartbeat_stale_s=120.0):
    """Cluster-wide view over per-host snapshots (pure function).

    Returns::

        {"hosts": {host: {"step_ms": {...}, "steps", "examples_per_sec",
                          "age_s", "pid"}},
         "cluster_step_ms_median": float | None,
         "warnings": ["host 2 straggling: ...", ...]}

    A host whose median step time exceeds ``straggler_factor`` x the
    cluster median of medians is flagged; a snapshot older than
    ``heartbeat_stale_s`` (against ``now``) flags a heartbeat warning —
    in an SPMD job a silent host is a hung host.
    """
    now = time.time() if now is None else now
    hosts, medians = {}, {}
    for snap in snapshots:
        host = snap.get("host", 0)
        hist = (snap.get("histograms") or {}).get("step.latency_ms") or {}
        dwait = (snap.get("histograms") or {}).get("step.data_wait_ms") or {}
        gauges = snap.get("gauges") or {}
        counters = snap.get("counters") or {}
        # Input-bound vs compute-bound: a step whose median data-wait
        # (host time blocked fetching the next batch) exceeds a third of
        # its median latency is starved by the input pipeline, not the
        # device: the label says which layer tuning starts in.
        bound = None
        if hist.get("p50") and dwait.get("p50") is not None:
            bound = ("input" if dwait["p50"] > 0.33 * hist["p50"]
                     else "compute")
        hosts[host] = {
            "pid": snap.get("pid"),
            "step_ms": hist,
            "data_wait_ms": dwait,
            "bound": bound,
            "steps": counters.get("step.count", hist.get("count", 0)),
            "examples_per_sec": gauges.get("step.examples_per_sec"),
            "age_s": round(max(0.0, now - snap.get("time", now)), 1),
            "phases": snap.get("phases") or {},
            "attribution": snap.get("attribution"),
        }
        if hist.get("p50") is not None:
            medians[host] = hist["p50"]
    cluster_median = None
    if medians:
        vals = sorted(medians.values())
        cluster_median = vals[len(vals) // 2]
    warnings = []
    for host, info in sorted(hosts.items()):
        med = medians.get(host)
        if (cluster_median and med is not None
                and med > straggler_factor * cluster_median):
            warnings.append(
                f"host {host} straggling: median step "
                f"{med:.2f}ms vs cluster {cluster_median:.2f}ms "
                f"({med / cluster_median:.2f}x)")
        if info.get("bound") == "input":
            dw = info["data_wait_ms"].get("p50")
            warnings.append(
                f"host {host} input-bound: median data-wait {dw:.2f}ms "
                f"of {med:.2f}ms step — raise prefetch depth / loader "
                f"ring, or check the record-file storage (docs/data.md)")
        if info["age_s"] > heartbeat_stale_s:
            warnings.append(
                f"host {host} heartbeat stale: last snapshot "
                f"{info['age_s']:.0f}s ago")
    return {"hosts": hosts, "cluster_step_ms_median": cluster_median,
            "warnings": warnings}
