"""Cross-rank clock sync + skew-decomposed comms attribution.

Counterpart of ``autodist_tpu/observability/skew.py``. The ping rides the
default process group's c10d store (the channel strategy shipping and
``observability/cluster.py`` use), where the JAX package uses the
coordination service's key-value store: keys carry a process-global
sequence and the rank, so they never repeat, and every read is a bounded
``store.wait``.

Every other observability layer is **per-rank**: in data-parallel
training the slowest rank sets the pace, so on every *other* rank the
attribution ledger's ``exposed_comms`` term silently absorbs barrier
wait and gets misdiagnosed as wire time — which also poisons the
``comms_scale`` calibration the tuner consumes. This module is the
cross-rank half of the story:

1. **Clock-offset estimator** — an NTP-style ping exchange: each worker
   posts a request stamped with its send time, the chief stamps
   receive/respond times, and the worker closes the loop.  Per sample::

       offset = ((t_recv - t0) + (t_send - t1)) / 2
       rtt    = (t1 - t0) - (t_send - t_recv)

   The minimum-RTT sample wins and the estimate is
   **uncertainty-bounded**: the true offset lies within ``rtt/2`` of the
   estimate even when all the delay sits on one leg. It runs on the
   cluster-sync cadence (end of every ``Runner.run``), so drift is
   observable as offset change over time.

2. **Per-step skew decomposition** — each rank ships its per-dispatch
   ``(start, end)`` wall-clock windows (a bounded ring, folded on the
   flush cadence, riding the cluster snapshots). On CUDA a dispatch's
   window comes from the ``torch.cuda.Event`` chain of
   ``runner.DispatchClock``, anchored to one host reading taken after a
   synchronize (the loop's final drain), where the JAX loop stamps each
   dispatch on the host clock. The chief aligns the windows via the
   offsets and, per matched step window, estimates when each rank was
   *ready* to enter the collectives (``ready = end - exposed_comms``):
   the last-ready rank is the **straggler**; every other rank's wait for
   it is ``skew_wait = clamp(max_ready - ready, 0, exposed)`` and the
   remainder ``wire = exposed - skew_wait`` is wire time. The split is
   exact by construction (``wire_ms + skew_wait_ms == exposed_comms_ms``
   per step), and the straggler's *cause* is named from its own
   attribution terms (data_wait vs device_compute vs host_dispatch). Where
   a rank's loop was profiled its ``exposed_comms`` is its own measured
   exposed collective time (``torch-profiler``:
   ``attribution.terms_for_runner``), so the wire-versus-wait split can
   differ by rank; otherwise it is the cost model's estimate, the same on
   every rank, and the split can never exceed it. The decomposition's
   ``sources`` say where each came from.

3. **Calibration correction** — ``attribution.feed_calibration``
   subtracts :func:`local_skew_wait_ms` from the measured exposed-comms
   residual before ``Calibration.observe_term``.

Everything is fail-open and cold-path: the step loop's only cost is the
ring append on the flush cadence; with ``AUTODIST_TELEMETRY=0`` no ping
is sent and no ring entry appended (spy-pinned contract test).
"""
import datetime
import itertools
import json
import os
import threading
import time

from collections import deque

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

_PING_ROUNDS = 3
_PING_TIMEOUT_MS = 5_000
#: Skew-wait below this floor (ms/step) is indistinguishable from clock
#: noise — the straggler verdict only fires above it AND above twice the
#: worst clock uncertainty in the cluster.
SIGNIFICANT_MS = 0.05

_seq = itertools.count(1)
_lock = threading.Lock()
_ring = None           # deque of per-dispatch window records
_step_counter = 0      # running step index (matches across SPMD hosts)
_local_offset = None   # this host's clock estimate vs the chief
_offsets = {}          # chief: {host: estimate dict}
_history = {}          # {host: (epoch_s, offset_ms)} for drift
_last_summary = None
_local_skew_wait = 0.0


def ring_capacity():
    """Per-dispatch window ring size (``AUTODIST_SKEW_RING``; 0 disables
    the ring and with it the whole decomposition)."""
    return max(0, int(const.ENV.AUTODIST_SKEW_RING.val))


def ring_enabled():
    return ring_capacity() > 0


# ---------------------------------------------------------------------------
# clock-offset estimation


def estimate_offset(samples):
    """NTP-style offset estimate from ``(t0, t_recv, t_send, t1)``
    samples (seconds; t0/t1 on the local clock, t_recv/t_send on the
    reference clock).  ``offset_ms`` is the LOCAL clock minus the
    reference (positive = this host's clock runs ahead), so aligning a
    local timestamp onto the reference is ``t - offset``.  The
    minimum-RTT sample wins; the uncertainty is ``rtt/2`` — the
    worst-case error when the entire round-trip delay sits on one leg.
    Returns ``None`` with no usable samples."""
    best = None
    for t0, t_recv, t_send, t1 in samples or ():
        rtt = (t1 - t0) - (t_send - t_recv)
        if rtt < 0:  # stamps out of order: a clock stepped mid-sample
            continue
        offset = ((t0 - t_recv) + (t1 - t_send)) / 2.0
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    if best is None:
        return None
    rtt, offset = best
    return {"offset_ms": round(offset * 1e3, 6),
            "uncertainty_ms": round(rtt / 2.0 * 1e3, 6),
            "rtt_ms": round(rtt * 1e3, 6),
            "samples": len(samples)}


def _wall():
    """This rank's wall clock for the ping (a hook: a test or the chip
    check shifts it to plant an offset)."""
    return time.time()


def store_channel(store):
    """``(set_bytes, get_bytes)`` over a c10d store: ``get_bytes(key,
    timeout_ms)`` waits for the key (bounded), reads and deletes it."""
    def set_bytes(key, value):
        store.set(key, value)

    def get_bytes(key, timeout_ms):
        store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        value = store.get(key)
        try:
            store.delete_key(key)
        except Exception:  # noqa: BLE001 - hygiene only
            pass
        return value
    return set_bytes, get_bytes


def _kv_channel():
    from autodist_tpu_torch.observability import cluster
    store = cluster._store()
    return None if store is None else store_channel(store)


def _note_drift(host, est, now=None):
    """Fold one offset estimate into the drift tracker: ppm of clock
    drift vs the chief since the previous estimate for this host."""
    now = time.time() if now is None else now
    prev = _history.get(host)
    if prev is not None:
        dt = now - prev[0]
        if dt > 1e-3:
            est["drift_ppm"] = round(
                (est["offset_ms"] - prev[1]) / dt * 1e3, 3)
    _history[host] = (now, est["offset_ms"])
    return est


def maybe_sync_clocks(timeout_ms=None, rounds=_PING_ROUNDS):
    """Run one ping exchange when it can matter: telemetry on,
    ``AUTODIST_CLOCK_SYNC`` not disabled, multi-process, KV channel up.
    Must be called at the same point on every process (distributed-init
    and the end-of-run cluster sync both qualify).  Fail-open."""
    if not const.ENV.AUTODIST_CLOCK_SYNC.val:
        return None
    from autodist_tpu_torch import observability
    if not observability.enabled():
        return None
    from autodist_tpu_torch.observability import tracing
    nprocs, pidx = tracing.process_count(), tracing.process_index()
    if nprocs <= 1:
        return None
    channel = _kv_channel()
    if channel is None:
        return None
    try:
        return _sync_clocks(channel, nprocs, pidx,
                            timeout_ms or _PING_TIMEOUT_MS, rounds)
    except Exception as e:  # noqa: BLE001 - telemetry must never kill a run
        logging.debug("clock sync skipped: %s", e)
        return None


def _sync_clocks(channel, nprocs, pidx, timeout_ms, rounds, seq=None):
    """The exchange proper.  The chief serves workers serially; a
    worker's first round therefore carries the chief's queueing delay,
    but the min-RTT pick discards it once the chief reaches it."""
    global _local_offset
    set_bytes, get_bytes = channel
    if seq is None:
        seq = next(_seq)
    base = f"autodist/clock/{seq}"
    if pidx == 0:
        offsets = {0: _note_drift(0, {"offset_ms": 0.0,
                                      "uncertainty_ms": 0.0,
                                      "rtt_ms": 0.0, "samples": 0})}
        for w in range(1, nprocs):
            try:
                for r in range(rounds):
                    req = get_bytes(f"{base}/{w}/{r}/req", timeout_ms)
                    t_recv = _wall()
                    payload = json.loads(req.decode("utf-8"))
                    set_bytes(f"{base}/{w}/{r}/rep",
                              json.dumps({"t0": payload["t0"],
                                          "recv": t_recv,
                                          "send": _wall()}
                                         ).encode("utf-8"))
                est = json.loads(get_bytes(f"{base}/{w}/est",
                                           timeout_ms).decode("utf-8"))
                offsets[w] = _note_drift(w, est)
            except Exception as e:  # noqa: BLE001 - one slow host, not a dead run
                logging.warning("clock sync: no estimate from host %d (%s)",
                                w, e)
        with _lock:
            _offsets.clear()
            _offsets.update(offsets)
        _local_offset = offsets[0]
        return offsets
    samples = []
    for r in range(rounds):
        t0 = _wall()
        set_bytes(f"{base}/{pidx}/{r}/req",
                  json.dumps({"t0": t0}).encode("utf-8"))
        rep = json.loads(get_bytes(f"{base}/{pidx}/{r}/rep",
                                   timeout_ms).decode("utf-8"))
        t1 = _wall()
        samples.append((t0, rep["recv"], rep["send"], t1))
    est = estimate_offset(samples)
    if est is None:
        return None
    _note_drift(pidx, est)
    set_bytes(f"{base}/{pidx}/est", json.dumps(est).encode("utf-8"))
    _local_offset = est
    return {pidx: est}


def local_offset():
    """This process's clock estimate vs the chief (``None`` before the
    first successful exchange; the chief's is identically zero)."""
    return _local_offset


def local_offset_ms():
    return (_local_offset or {}).get("offset_ms", 0.0)


# ---------------------------------------------------------------------------
# per-dispatch window ring


def observe_dispatches(records):
    """Fold flushed dispatch windows into the bounded ring.  ``records``
    are ``(end_perf, dur_s, steps, wait_s)`` tuples in ``perf_counter``
    time — converted here (not in the hot loop) to epoch seconds via the
    tracing origin so cross-rank alignment is possible."""
    global _ring, _step_counter
    cap = ring_capacity()
    if cap <= 0 or not records:
        return
    from autodist_tpu_torch.observability import tracing
    with _lock:
        if _ring is None or _ring.maxlen != cap:
            _ring = deque(_ring or (), maxlen=cap)
        for end_perf, dur_s, steps, wait_s in records:
            end = tracing.perf_to_epoch(end_perf)
            _ring.append({"i": _step_counter,
                          "s": round(end - dur_s, 6),
                          "e": round(end, 6),
                          "k": max(1, int(steps)),
                          "w": round(wait_s * 1e3, 4)})
            _step_counter += max(1, int(steps))


def ring():
    with _lock:
        return list(_ring or ())


def local_payload(limit=128):
    """This host's skew payload for the cluster snapshot: the clock
    estimate plus the ring tail.  ``None`` when there is nothing to ship
    (keeps single-host snapshots lean)."""
    recs = ring()
    if not recs and _local_offset is None:
        return None
    est = _local_offset or {}
    return {"offset_ms": est.get("offset_ms", 0.0),
            "uncertainty_ms": est.get("uncertainty_ms", 0.0),
            "drift_ppm": est.get("drift_ppm"),
            "ring": recs[-limit:]}


# ---------------------------------------------------------------------------
# chief-side decomposition


def _blame(attr):
    """The dominant non-comms attribution term of a straggler host."""
    terms = {"data_wait": attr.get("data_wait_ms") or 0.0,
             "device_compute": attr.get("device_compute_ms") or 0.0,
             "host_dispatch": attr.get("host_dispatch_ms") or 0.0}
    cause = max(terms, key=lambda k: terms[k])
    return cause, terms[cause]


def decompose(snapshots, window_limit=64):
    """Split every host's ``exposed_comms`` into ``wire + skew_wait``
    over the step windows the snapshots share (pure function — the
    synthetic-fixture tests drive it directly).

    Per matched step window, each host's collective-ready time is
    ``ready = end - exposed`` on the chief-aligned clock; the last-ready
    host is the straggler and everyone else's ``skew_wait`` is the gap
    to it, clamped into ``[0, exposed]`` so ``wire = exposed -
    skew_wait`` stays exact and non-negative.  Returns ``None`` when no
    snapshot carries a skew payload."""
    hosts = {}
    for snap in snapshots or ():
        payload = snap.get("skew")
        if not payload:
            continue
        h = snap.get("host", 0)
        attr = snap.get("attribution") or {}
        hosts[h] = {
            "offset_ms": float(payload.get("offset_ms") or 0.0),
            "uncertainty_ms": float(payload.get("uncertainty_ms") or 0.0),
            "drift_ppm": payload.get("drift_ppm"),
            "attr": attr,
            "recs": {r["i"]: r for r in (payload.get("ring") or ())
                     if isinstance(r, dict) and "i" in r},
        }
    if not hosts:
        return None

    common = None
    for info in hosts.values():
        keys = set(info["recs"])
        common = keys if common is None else (common & keys)
    common = sorted(common or ())

    per_host = {
        h: {"skew_wait_ms": 0.0, "wire_ms": 0.0, "steps": 0,
            "straggler_windows": 0, "windows": []}
        for h in hosts}
    for i in common:
        ready, spans = {}, {}
        for h, info in hosts.items():
            r = info["recs"][i]
            off_s = info["offset_ms"] / 1e3
            s, e, k = r["s"] - off_s, r["e"] - off_s, r["k"]
            exposed_step = float(info["attr"].get("exposed_comms_ms")
                                 or 0.0)
            exposed_disp = exposed_step * k / 1e3
            ready[h] = max(s, e - exposed_disp)
            spans[h] = (s, e, k, exposed_step, exposed_disp)
        max_ready = max(ready.values())
        straggler_h = max(ready, key=lambda h: ready[h])
        for h, (s, e, k, exposed_step, exposed_disp) in spans.items():
            wait_disp = min(max(0.0, max_ready - ready[h]), exposed_disp)
            wait_step = wait_disp * 1e3 / k
            agg = per_host[h]
            agg["skew_wait_ms"] += wait_step * k
            agg["wire_ms"] += (exposed_step - wait_step) * k
            agg["steps"] += k
            if h == straggler_h and len(hosts) > 1:
                agg["straggler_windows"] += 1
            if len(agg["windows"]) < window_limit:
                agg["windows"].append({
                    "i": i, "s": round(s, 6), "e": round(e, 6), "k": k,
                    "skew_wait_ms": round(wait_step, 6),
                    "wire_ms": round(exposed_step - wait_step, 6),
                    "exposed_comms_ms": round(exposed_step, 6),
                    "straggler": straggler_h})

    max_unc = max(info["uncertainty_ms"] for info in hosts.values())
    out_hosts, worst_wait = {}, 0.0
    for h, agg in per_host.items():
        n = agg["steps"] or 1
        wait = agg["skew_wait_ms"] / n
        worst_wait = max(worst_wait, wait)
        out_hosts[h] = {
            "offset_ms": hosts[h]["offset_ms"],
            "uncertainty_ms": hosts[h]["uncertainty_ms"],
            "drift_ppm": hosts[h]["drift_ppm"],
            "exposed_comms_ms": hosts[h]["attr"].get("exposed_comms_ms"),
            "exposed_comms_source": (hosts[h]["attr"].get("sources")
                                     or {}).get("exposed_comms"),
            "skew_wait_ms": round(wait, 6),
            "wire_ms": round(agg["wire_ms"] / n, 6),
            "steps": agg["steps"],
            "straggler_windows": agg["straggler_windows"],
            "windows": agg["windows"],
        }

    straggler = None
    if len(hosts) > 1 and common:
        counts = {h: out_hosts[h]["straggler_windows"] for h in out_hosts}
        top = max(counts, key=lambda h: counts[h])
        if counts[top]:
            cause, cause_ms = _blame(hosts[top]["attr"])
            straggler = {
                "host": top,
                "share_pct": round(100.0 * counts[top] / len(common), 1),
                "cause": cause,
                "cause_ms": round(cause_ms, 5),
                "detail": (f"host {top} is the straggler in "
                           f"{counts[top]}/{len(common)} windows; dominant "
                           f"term {cause} ({cause_ms:.3f} ms/step)"),
            }
    significant = bool(straggler) and worst_wait > max(
        SIGNIFICANT_MS, 2.0 * max_unc)
    return {
        "hosts": out_hosts,
        "windows": len(common),
        "straggler": straggler,
        "significant": significant,
        "max_skew_wait_ms": round(worst_wait, 6),
        "max_abs_offset_ms": round(
            max(abs(info["offset_ms"]) for info in hosts.values()), 6),
        # Where each rank's exposed_comms came from: measured off its
        # profiler trace ("torch-profiler") or the cost model's estimate.
        "sources": {"exposed_comms": sorted({
            str((info["attr"].get("sources") or {}).get("exposed_comms"))
            for info in hosts.values()})},
    }


def update_from_snapshots(snapshots):
    """Fold one cluster sync's snapshots through the decomposition:
    stash the summary, publish the ``skew.*`` gauges, note this host's
    own skew-wait (the calibration correction), persist the summary for
    the timeline tool, and drop a flight-recorder line when a straggler
    is named.  Fail-open; chief-persisted only."""
    global _local_skew_wait
    try:
        summary = decompose(snapshots)
        if summary is None:
            return None
        set_last_summary(summary)
        from autodist_tpu_torch.observability import tracing
        me = tracing.process_index()
        mine = summary["hosts"].get(me)
        if mine is not None:
            _local_skew_wait = float(mine.get("skew_wait_ms") or 0.0)
        from autodist_tpu_torch.observability import metrics
        reg = metrics.registry()
        reg.gauge("skew.max_offset_ms").set(summary["max_abs_offset_ms"])
        reg.gauge("skew.wait_ms_per_step").set(summary["max_skew_wait_ms"])
        if mine is not None:
            reg.gauge("skew.wire_ms_per_step").set(mine["wire_ms"])
        if summary["straggler"]:
            reg.gauge("skew.straggler_host").set(
                summary["straggler"]["host"])
        persist_summary(summary)
        return summary
    except Exception as e:  # noqa: BLE001 - telemetry must never kill a run
        logging.debug("skew decomposition skipped: %s", e)
        return None


def local_skew_wait_ms():
    """This host's mean skew-wait (ms/step) from the most recent
    decomposition — the correction ``attribution.feed_calibration``
    subtracts from the measured exposed-comms residual."""
    return _local_skew_wait


def summary_path():
    return os.path.join(const.DEFAULT_LOG_DIR, "skew_summary.json")


def persist_summary(summary, path=None):
    """Write the decomposition next to the flight logs so the offline
    timeline tool can render skew-wait spans.  Chief-only, fail-open."""
    from autodist_tpu_torch.observability import tracing
    if tracing.process_index() != 0:
        return None
    try:
        const.ensure_working_dirs()
        path = path or summary_path()
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError as e:
        logging.debug("skew summary not persisted: %s", e)
        return None


def last_summary():
    """The most recent decomposition in this process (``None`` before
    the first cluster sync that carried skew payloads)."""
    return _last_summary


def set_last_summary(summary):
    global _last_summary
    _last_summary = summary


def reset():
    """Test harness hook."""
    global _ring, _step_counter, _local_offset, _last_summary
    global _local_skew_wait
    with _lock:
        _ring = None
        _step_counter = 0
    _local_offset = None
    _offsets.clear()
    _history.clear()
    _last_summary = None
    _local_skew_wait = 0.0
