"""Live cluster monitor: Prometheus + JSON status over HTTP, plus
rolling straggler/anomaly detection.

Counterpart of ``autodist_tpu/observability/monitor.py``. Opt-in
(``AUTODIST_MONITOR_PORT``, default 0 = off): the chief binds a tiny
threaded HTTP server exposing

* ``GET /metrics`` — Prometheus text format (counters as ``_total``,
  histograms as summaries with quantiles, per-rank step-latency /
  heartbeat-age series from the last cluster snapshots gathered over the
  c10d store, the skew split, the per-layer profile and the memory
  ledger);
* ``GET /status`` (also ``/`` and ``/healthz``) — a JSON status page:
  step rate, the attribution breakdown ("where the step goes"), the
  per-layer profile, the pipeline bubble, the skew split, the memory and
  goodput ledgers, per-rank heartbeat age + latency percentiles, serve
  queue depth / p99 / SLO-burn, decode throughput, and the active
  anomaly list. The JAX page's ``retune`` section (the online re-tuning
  controller and self-healing, ROADMAP.md A12) is not ported, nor the
  stitched goodput across elastic re-exec generations (A5 + A9).

Everything is read-only over state other layers already maintain (the
metrics registry, ``cluster.gathered()``, ``attribution.last_summary()``)
so a scrape never touches the step loop.  With ``AUTODIST_TELEMETRY=0``
the server never starts — no thread, no port (test-pinned).

The :class:`AnomalyDetector` watches the same per-rank snapshots the
cluster aggregate reads and flags, with rolling history:

* **latency spikes** — a rank whose median step time z-scores above
  ``AUTODIST_ANOMALY_ZSCORE`` against its own rolling history;
* **data-wait dominance flips** — a rank that turns input-bound after
  running compute-bound (the input pipeline regressed mid-run);
* **heartbeat gaps** — a snapshot older than the stale threshold;
* **stragglers** — the skew decomposition's named straggler, when its
  wait clears the clock-uncertainty floor.

Newly-raised anomalies land on the flight recorder (``anomaly`` events,
stragglers as ``straggler``); resolved ones clear.
"""
import json
import re
import threading
import time

from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

_server = None
_thread = None
_port = None
_lock = threading.Lock()

_THREAD_NAME = "autodist-monitor"


# ---------------------------------------------------------------------------
# anomaly detection


class AnomalyDetector:
    """Rolling per-host anomaly detection over cluster snapshots.

    Pure state machine (unit-testable with synthetic series): feed
    :meth:`update` the per-host snapshot list; it returns NEWLY-raised
    anomalies and maintains the active set.  An anomaly stays active
    while its condition holds and clears when it stops.
    """

    def __init__(self, zscore=None, heartbeat_s=120.0, dominance=0.5,
                 window=64, min_history=8):
        if zscore is None:
            zscore = const.ENV.AUTODIST_ANOMALY_ZSCORE.val
        self.zscore = float(zscore)
        self.heartbeat_s = float(heartbeat_s)
        self.dominance = float(dominance)
        self.window = int(window)
        self.min_history = int(min_history)
        self._lat = {}     # host -> deque of p50 samples
        self._bound = {}   # host -> last input/compute classification
        self._active = {}  # (kind, host) -> anomaly dict

    def _raise_or_hold(self, key, anomaly, new):
        if key not in self._active:
            self._active[key] = anomaly
            new.append(anomaly)
        else:  # keep the first-raised record, refresh the detail
            self._active[key].update(anomaly)

    def update(self, snapshots, now=None, skew=None):
        """Fold one round of per-host snapshots; returns the anomalies
        raised THIS round (the active set is :meth:`anomalies`).

        ``skew`` (the last skew decomposition, observability/skew.py)
        upgrades the straggler rule from a latency z-score to a causal
        verdict: "host X is the straggler and its cause is Y", raised
        only when the skew-wait clears the decomposition's
        clock-uncertainty-bounded significance floor.
        """
        now = time.time() if now is None else now
        new, seen = [], set()
        straggler = (skew or {}).get("straggler")
        if straggler is not None and (skew or {}).get("significant"):
            host = straggler.get("host")
            key = ("straggler", host)
            seen.add(key)
            # A straggler verdict for host X clears any held verdict
            # for a different host (the straggler moved).
            for other in [k for k in self._active
                          if k[0] == "straggler" and k != key]:
                self._active.pop(other, None)
            self._raise_or_hold(key, {
                "kind": "straggler", "host": host,
                "detail": (f"host {host} is the straggler and its cause "
                           f"is {straggler.get('cause')}: "
                           f"{straggler.get('detail')}")}, new)
        else:
            for key in [k for k in self._active if k[0] == "straggler"]:
                self._active.pop(key, None)
        for snap in snapshots or []:
            host = snap.get("host", 0)
            hists = snap.get("histograms") or {}
            lat = (hists.get("step.latency_ms") or {}).get("p50")
            wait = (hists.get("step.data_wait_ms") or {}).get("p50")

            # Heartbeat gap: in an SPMD job a silent host is a hung host.
            age = max(0.0, now - snap.get("time", now))
            key = ("heartbeat", host)
            seen.add(key)
            if age > self.heartbeat_s:
                self._raise_or_hold(key, {
                    "kind": "heartbeat-gap", "host": host,
                    "detail": f"host {host} last snapshot {age:.0f}s ago "
                              f"(threshold {self.heartbeat_s:.0f}s)"}, new)
            else:
                self._active.pop(key, None)

            if lat is not None:
                hist = self._lat.setdefault(
                    host, deque(maxlen=max(2, self.window)))
                key = ("latency", host)
                seen.add(key)
                if len(hist) >= self.min_history:
                    mean = sum(hist) / len(hist)
                    var = sum((x - mean) ** 2 for x in hist) / len(hist)
                    # Floor the spread: a perfectly-steady history must
                    # not turn a 1% wobble into an infinite z-score.
                    std = max(var ** 0.5, 0.05 * mean, 1e-6)
                    z = (lat - mean) / std
                    if z > self.zscore:
                        self._raise_or_hold(key, {
                            "kind": "latency-spike", "host": host,
                            "detail": f"host {host} step p50 {lat:.2f}ms is "
                                      f"{z:.1f} sigma above its rolling "
                                      f"median {mean:.2f}ms"}, new)
                    elif z < self.zscore / 2:
                        self._active.pop(key, None)
                hist.append(lat)

                # Data-wait dominance flip: compute-bound -> input-bound.
                if wait is not None and lat > 0:
                    bound = ("input" if wait > self.dominance * lat
                             else "compute")
                    prev = self._bound.get(host)
                    key = ("bound", host)
                    seen.add(key)
                    if bound == "input" and prev == "compute":
                        self._raise_or_hold(key, {
                            "kind": "input-bound-flip", "host": host,
                            "detail": f"host {host} flipped input-bound: "
                                      f"data-wait p50 {wait:.2f}ms of "
                                      f"{lat:.2f}ms step"}, new)
                    elif bound == "compute":
                        self._active.pop(key, None)
                    self._bound[host] = bound
        return new

    def anomalies(self):
        """The currently-active anomaly list (report warnings read it)."""
        return list(self._active.values())


_detector = None


def detector():
    """The process-global detector (lazy; thresholds from env)."""
    global _detector
    if _detector is None:
        _detector = AnomalyDetector()
    return _detector


def reset_detector():
    """Test harness hook."""
    global _detector
    _detector = None


def observe_cluster(snapshots, now=None):
    """Feed a sync's snapshots through the detector; newly-raised
    anomalies land on the flight recorder (skew-named stragglers as
    their own ``straggler`` event type). The JAX package also feeds the
    active set to its self-healing controller (ROADMAP.md A12).
    Fail-open."""
    try:
        from autodist_tpu_torch.observability import skew as skew_mod
        det = detector()
        new = det.update(snapshots, now=now, skew=skew_mod.last_summary())
        if new:
            from autodist_tpu_torch.observability import recorder
            for a in new:
                if a["kind"] == "straggler":
                    recorder.record("straggler", a["detail"],
                                    host=a.get("host"))
                else:
                    recorder.record("anomaly", a["detail"],
                                    kind_detail=a["kind"],
                                    host=a.get("host"))
        return new
    except Exception as e:  # noqa: BLE001 - telemetry must never kill a run
        logging.debug("anomaly detection skipped: %s", e)
        return []


# ---------------------------------------------------------------------------
# views (pure functions over existing telemetry state)


def _snapshots():
    from autodist_tpu_torch.observability import cluster
    snaps = cluster.gathered()
    if not snaps:
        try:
            snaps = [cluster.local_snapshot()]
        except Exception:  # noqa: BLE001
            snaps = []
    return snaps


def _sanitize(name):
    return "autodist_" + re.sub(r"[^a-zA-Z0-9_]", "_", str(name))


def _fmt(v):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return repr(round(f, 6))


def prometheus_text():
    """The local registry + per-host cluster series, Prometheus text
    exposition format (version 0.0.4)."""
    from autodist_tpu_torch.observability import cluster, metrics
    snap = metrics.registry().snapshot()
    lines = []
    for name, val in sorted((snap.get("counters") or {}).items()):
        n = _sanitize(name) + "_total"
        lines += [f"# TYPE {n} counter", f"{n} {_fmt(val) or 0}"]
    for name, val in sorted((snap.get("gauges") or {}).items()):
        v = _fmt(val)
        if v is None:
            continue
        n = _sanitize(name)
        lines += [f"# TYPE {n} gauge", f"{n} {v}"]
    for name, summ in sorted((snap.get("histograms") or {}).items()):
        n = _sanitize(name)
        lines.append(f"# TYPE {n} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            v = _fmt(summ.get(key))
            if v is not None:
                lines.append(f'{n}{{quantile="{q}"}} {v}')
        lines.append(f"{n}_sum {_fmt(summ.get('total', 0.0)) or 0}")
        lines.append(f"{n}_count {int(summ.get('count', 0))}")
    # Per-host series from the last cluster sync (chief view).
    agg = cluster.aggregate(_snapshots())
    for host, info in sorted(agg["hosts"].items()):
        lab = f'{{host="{host}"}}'
        for key, metric in (("p50", "autodist_host_step_p50_ms"),
                            ("p90", "autodist_host_step_p90_ms")):
            v = _fmt((info.get("step_ms") or {}).get(key))
            if v is not None:
                lines.append(f"{metric}{lab} {v}")
        lines.append(f"autodist_host_snapshot_age_seconds{lab} "
                     f"{_fmt(info.get('age_s', 0.0)) or 0}")
        lines.append(f"autodist_host_steps{lab} {int(info.get('steps') or 0)}")
    # Per-host skew series from the last decomposition (chief view):
    # clock offset vs the chief and barrier-wait share of exposed comms.
    try:
        from autodist_tpu_torch.observability import skew as skew_mod
        summ = skew_mod.last_summary()
        for host, row in sorted(((summ or {}).get("hosts") or {}).items()):
            lab = f'{{host="{host}"}}'
            lines.append(f"autodist_host_clock_offset_ms{lab} "
                         f"{_fmt(row.get('offset_ms')) or 0}")
            lines.append(f"autodist_host_skew_wait_ms{lab} "
                         f"{_fmt(row.get('skew_wait_ms')) or 0}")
            lines.append(f"autodist_host_wire_ms{lab} "
                         f"{_fmt(row.get('wire_ms')) or 0}")
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: skew series unavailable: %s", e)
    # Per-layer profile series (top-K scopes of the last profiled run).
    try:
        from autodist_tpu_torch.observability import profile as profile_mod
        for scope, row in profile_mod.last_summary_rows():
            lab = f'{{scope="{scope}"}}'
            lines.append(f"autodist_profile_compute_ms{lab} "
                         f"{_fmt(row['compute_ms']) or 0}")
            lines.append(f"autodist_profile_comms_ms{lab} "
                         f"{_fmt(row['comms_ms']) or 0}")
            lines.append(f"autodist_profile_wire_bytes{lab} "
                         f"{_fmt(row['wire_bytes']) or 0}")
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: profile series unavailable: %s", e)
    # Per-class HBM ledger series (predicted split of the last run's
    # peak) + the predicted/measured/capacity roll-ups.
    try:
        from autodist_tpu_torch.observability import memory as memory_mod
        summ = memory_mod.last_summary()
        for cls, v in sorted(((summ or {}).get("predicted") or {}).items()):
            lab = f'{{class="{cls.replace("_bytes", "")}"}}'
            lines.append(f"autodist_mem_predicted_gb{lab} "
                         f"{_fmt(v / (1 << 30)) or 0}")
        if summ:
            for key, metric in (
                    ("predicted_peak_gb", "autodist_mem_predicted_peak_gb"),
                    ("measured_peak_gb", "autodist_mem_measured_peak_gb"),
                    ("capacity_gb", "autodist_mem_capacity_gb"),
                    ("prediction_error_pct",
                     "autodist_mem_prediction_error_pct")):
                v = _fmt(summ.get(key))
                if v is not None:
                    lines.append(f"{metric} {v}")
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: memory series unavailable: %s", e)
    lines.append(f"autodist_anomalies_active {len(detector().anomalies())}")
    return "\n".join(lines) + "\n"


def status():
    """The JSON status document (``/status``)."""
    from autodist_tpu_torch.observability import attribution, cluster, metrics
    snap = metrics.registry().snapshot()
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    hists = snap.get("histograms") or {}
    snaps = _snapshots()
    agg = cluster.aggregate(snaps)
    observe_cluster(snaps)

    lat = hists.get("step.latency_ms") or {}
    step = {
        "count": counters.get("step.count", 0),
        "examples_per_sec": gauges.get("step.examples_per_sec"),
        "p50_ms": lat.get("p50"),
        "p90_ms": lat.get("p90"),
        "p99_ms": lat.get("p99"),
        "unroll": gauges.get("step.unroll") or 1,
    }

    hosts = {}
    for host, info in sorted(agg["hosts"].items()):
        h = info.get("step_ms") or {}
        hosts[str(host)] = {
            "p50_ms": h.get("p50"), "p90_ms": h.get("p90"),
            "steps": info.get("steps", 0), "bound": info.get("bound"),
            "heartbeat_age_s": info.get("age_s"),
            "attribution": info.get("attribution"),
        }

    serve = None
    slat = hists.get("serve.latency_ms") or {}
    if counters.get("serve.requests") or slat.get("count"):
        slo_ms = max(1, const.ENV.AUTODIST_SERVE_SLO_MS.val)
        p99 = slat.get("p99")
        serve = {
            "requests": counters.get("serve.requests", 0),
            "queue_depth": gauges.get("serve.queue_depth", 0),
            "p50_ms": slat.get("p50"), "p99_ms": p99,
            "slo_ms": slo_ms,
            # Burn > 1.0: the p99 is past the SLO — the pager gauge.
            "slo_burn": (round(p99 / slo_ms, 4) if p99 else None),
        }

    # Autoregressive decode fleet (serve/decode.py): token throughput,
    # continuous-batching occupancy, and the scale-event count the
    # autoscaler audit trail grows.
    decode = None
    dlat = hists.get("decode.latency_ms") or {}
    if counters.get("decode.requests") or dlat.get("count"):
        decode = {
            "requests": counters.get("decode.requests", 0),
            "tokens": counters.get("decode.tokens", 0),
            "steps": counters.get("decode.steps", 0),
            "tokens_per_sec": gauges.get("decode.tokens_per_sec"),
            "queue_depth": gauges.get("decode.queue_depth", 0),
            "active_slots": gauges.get("decode.active_slots", 0),
            "replicas": gauges.get("decode.replicas"),
            "scale_events": counters.get("decode.scale_events", 0),
            "p50_ms": dlat.get("p50"), "p99_ms": dlat.get("p99"),
        }

    # Per-layer profile: top-K scopes of the last profiled run (the
    # full table lives in the report / profile.json sidecar).
    prof = None
    try:
        from autodist_tpu_torch.observability import profile as profile_mod
        summ = profile_mod.last_profile()
        if summ:
            prof = {
                "top": [dict(row, scope=scope) for scope, row
                        in profile_mod.last_summary_rows()],
                "unattributed": summ["unattributed"],
                "coverage_pct": summ["coverage_pct"],
                "sources": summ["sources"],
            }
    except Exception:  # noqa: BLE001 - a scrape must never fail here
        pass

    # Cluster skew: per-host
    # clock offsets + the wire/skew-wait split of exposed comms, and the
    # named straggler with its cause.  ``None`` until a decomposition
    # ran (single host with no ring, or telemetry just started).
    skew_sec = None
    try:
        from autodist_tpu_torch.observability import skew as skew_mod
        summ = skew_mod.last_summary()
        if summ:
            skew_sec = {
                "max_abs_offset_ms": summ.get("max_abs_offset_ms"),
                "max_skew_wait_ms": summ.get("max_skew_wait_ms"),
                "windows": summ.get("windows"),
                "significant": summ.get("significant"),
                "straggler": summ.get("straggler"),
                "hosts": {str(h): {k: row.get(k) for k in
                                   ("offset_ms", "uncertainty_ms",
                                    "drift_ppm", "skew_wait_ms", "wire_ms",
                                    "exposed_comms_ms",
                                    "straggler_windows")}
                          for h, row in (summ.get("hosts") or {}).items()},
            }
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: skew section unavailable: %s", e)

    # Pipeline bubble row: stages x microbatches and
    # the schedule's priced fill/drain share of the step.  ``None`` for
    # unpipelined runs.
    pipeline_sec = None
    try:
        from autodist_tpu_torch.pipeline import observe as pipe_observe
        pipeline_sec = pipe_observe.status_section(metrics.registry())
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: pipeline section unavailable: %s", e)

    # HBM memory ledger: predicted per-class peak vs
    # the measured boundary samples, feasibility, and the last OOM
    # report if one was written.  ``None`` until a ledger finalized.
    memory_sec = None
    try:
        from autodist_tpu_torch.observability import memory as memory_mod
        summ = memory_mod.last_summary()
        if summ:
            memory_sec = {
                "predicted_peak_gb": summ.get("predicted_peak_gb"),
                "measured_peak_gb": summ.get("measured_peak_gb"),
                "prediction_error_pct": summ.get("prediction_error_pct"),
                "capacity_gb": summ.get("capacity_gb"),
                "feasible": summ.get("feasible"),
                "dominant_class": summ.get("dominant_class"),
                "predicted": {
                    c: round(v / (1 << 30), 6) for c, v in
                    (summ.get("predicted") or {}).items()},
            }
            oom = memory_mod.last_oom_report()
            if oom:
                memory_sec["last_oom"] = {
                    k: oom.get(k) for k in
                    ("error", "context", "dominant_class", "suggestion")}
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: memory section unavailable: %s", e)

    # Run identity + goodput: operators must be able
    # to tell a stitched elastic run from a fresh one at a glance.
    run_info = goodput_sec = None
    try:
        from autodist_tpu_torch.observability import goodput as goodput_mod
        segs = goodput_mod.segments_for()
        run_info = {
            "run_id": goodput_mod.run_id(),
            "generation": goodput_mod.generation(),
            "generations_observed": (len({s.get("generation")
                                          for s in segs}) or 1),
        }
        g = goodput_mod.last_summary()
        if g:
            goodput_sec = {
                "goodput_pct": g.get("goodput_pct"),
                "goodput_ms": g.get("goodput_ms"),
                "wall_ms": g.get("wall_ms"),
                "classes": g.get("classes"),
                "mfu": g.get("mfu"),
                "hfu": g.get("hfu"),
            }
    except Exception as e:  # noqa: BLE001 - a scrape must never fail here
        logging.debug("monitor: goodput section unavailable: %s", e)

    return {
        "time": round(time.time(), 3),
        "hosts_reporting": len(agg["hosts"]),
        "run": run_info,
        "step": step,
        "attribution": attribution.last_summary(),
        "profile": prof,
        "pipeline": pipeline_sec,
        "skew": skew_sec,
        "memory": memory_sec,
        "goodput": goodput_sec,
        "hosts": hosts,
        "serve": serve,
        "decode": decode,
        "warnings": agg["warnings"],
        "anomalies": detector().anomalies(),
    }


# ---------------------------------------------------------------------------
# HTTP server


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        try:
            path = self.path.split("?")[0]
            if path == "/metrics":
                body = prometheus_text().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path in ("/", "/status", "/healthz"):
                body = json.dumps(status(), default=str).encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception as e:  # noqa: BLE001 - a scrape must never kill a run
            try:
                self.send_error(500, str(e)[:100])
            except Exception:  # noqa: BLE001
                pass

    def log_message(self, fmt, *args):  # quiet: scrape spam stays off stderr
        logging.debug("monitor: " + fmt, *args)


def start(port):
    """Bind and serve on ``port`` (0 = ephemeral); idempotent.  Returns
    the bound port, or ``None`` when the bind fails (fail-open: a busy
    port degrades to no monitor, never to a dead run)."""
    global _server, _thread, _port
    with _lock:
        if _server is not None:
            return _port
        try:
            _server = ThreadingHTTPServer(("0.0.0.0", int(port)), _Handler)
            _server.daemon_threads = True
        except OSError as e:
            logging.warning("monitor: could not bind port %s: %s", port, e)
            _server = None
            return None
        _port = _server.server_address[1]
        _thread = threading.Thread(target=_server.serve_forever,
                                   name=_THREAD_NAME, daemon=True)
        _thread.start()
    logging.info("monitor: serving /metrics and /status on :%d", _port)
    try:
        from autodist_tpu_torch.observability import recorder
        recorder.record("monitor-start", f"port {_port}")
    except Exception:  # noqa: BLE001
        pass
    return _port


def ensure_started():
    """Start the monitor iff configured AND telemetry is on AND this is
    the chief.  The inert path — telemetry off or no port — makes no
    network/thread calls at all (test-pinned contract)."""
    cfg = const.ENV.AUTODIST_MONITOR_PORT.val
    if not cfg or cfg <= 0:
        return None
    from autodist_tpu_torch import observability
    if not observability.enabled():
        return None
    from autodist_tpu_torch.observability import tracing
    if tracing.process_index() != 0:
        return None
    return start(cfg)


def stop():
    """Shut the server down (test harness / clean exit hook)."""
    global _server, _thread, _port
    with _lock:
        srv, thr = _server, _thread
        _server = _thread = _port = None
    if srv is not None:
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:  # noqa: BLE001
            pass
    if thr is not None:
        thr.join(timeout=5)


def running():
    return _server is not None


def port():
    """The bound port (``None`` when not running)."""
    return _port
