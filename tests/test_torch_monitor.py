"""The port's live monitor, anomaly detector and cluster aggregate against
the JAX package.

* ``AnomalyDetector.update`` on the same synthetic snapshot sequences
  (latency spike, recovery, input-bound flip, heartbeat gap, the causal
  straggler rule): the same anomalies, raised and cleared at the same
  rounds (exact);
* ``prometheus_text`` over the same registry contents, gathered
  snapshots, skew decomposition, profile and memory ledger: the same
  lines (exact), each a valid Prometheus exposition line;
* ``cluster.aggregate`` on ``tests/test_observability.py``'s snapshots:
  equal (exact);
* the HTTP server: ``/metrics`` and ``/status`` on a free port (taken
  with a retry), 404 elsewhere, idempotent ``start``, ``stop`` frees the
  port; never started with telemetry off or with no port; started by the
  Runner on the chief when ``AUTODIST_MONITOR_PORT`` is set. ``/status``
  has the JAX page's sections less ``retune`` (ROADMAP.md A12).
"""
import functools
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from autodist_tpu import observability as jobs
from autodist_tpu.observability import cluster as jcluster
from autodist_tpu.observability import memory as jmemory
from autodist_tpu.observability import monitor as jmonitor
from autodist_tpu.observability import profile as jprofile
from autodist_tpu.observability import skew as jskew
from autodist_tpu_torch import AutoDist, const, observability
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.observability import (cluster, memory, monitor,
                                              profile, skew)
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce

BATCH = 16
NOW = 1_000_000.0

_PROM_LINE = re.compile(
    r"^(#\s(HELP|TYPE)\s.*|[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[^}]*\})?\s[-+0-9.eE]+)$")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_MONITOR_PORT",
                 "AUTODIST_TRACE", "AUTODIST_ANOMALY_ZSCORE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_WORKING_DIR", str(tmp_path))
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "c.json"))
    monkeypatch.setattr(const, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setattr(const, "DEFAULT_TRACE_DIR", str(tmp_path / "traces"))
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    yield
    monitor.stop()
    jmonitor.stop()
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    autodist_mod._reset_default()


def _loss_fn(params, batch):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean()


def _run_some_steps(steps=6):
    autodist_mod._reset_default()
    rng = np.random.RandomState(0)
    batch = (torch.tensor(rng.randn(BATCH, 8), dtype=torch.float32),
             torch.tensor(rng.randn(BATCH, 4), dtype=torch.float32))
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        _loss_fn, {"w": torch.zeros(8, 4)},
        functools.partial(torch.optim.SGD, lr=0.1), example_batch=batch))

    def batches():
        while True:
            yield batch
    runner.run(runner.create_state(), batches(), steps)
    return runner


def _get(path):
    url = f"http://127.0.0.1:{monitor.port()}{path}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), \
            resp.read().decode("utf-8")


def _start_free():
    """Start on a free port, taken with one retry (another process may
    bind it between the probe and the start)."""
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free = s.getsockname()[1]
        if monitor.start(free) == free:
            return free
    raise RuntimeError("no free port for the monitor")


# -- the anomaly detector -------------------------------------------------------

def _snap(host, p50, wait=None, t=NOW):
    hists = {"step.latency_ms": {"p50": p50, "count": 10}}
    if wait is not None:
        hists["step.data_wait_ms"] = {"p50": wait, "count": 10}
    return {"host": host, "pid": host, "time": t, "histograms": hists,
            "counters": {}, "gauges": {}, "phases": {}, "events": []}


def _skew_summary(host=1, cause="data_wait", significant=True):
    return {"hosts": {0: {}, host: {}}, "windows": 8,
            "significant": significant, "max_skew_wait_ms": 1.2,
            "max_abs_offset_ms": 0.5,
            "straggler": {"host": host, "share_pct": 100.0, "cause": cause,
                          "cause_ms": 6.0,
                          "detail": f"host {host} is the straggler in 8/8 "
                                    f"windows; dominant term {cause} "
                                    f"(6.000 ms/step)"}}


def _sequences():
    """{name: (detector kwargs, [(snapshots, skew summary)])}, seeded."""
    rng = np.random.RandomState(0)
    steady = [([_snap(0, 10.0 + 0.1 * rng.randn()),
                _snap(1, 10.0 + 0.1 * rng.randn())], None)
              for _ in range(20)]
    spike = steady + [([_snap(0, 30.0), _snap(1, 10.0)], None)] * 2
    recovery = ([([_snap(0, 10.0)], None)] * 8 + [([_snap(0, 40.0)], None)]
                + [([_snap(0, 10.0)], None)] * 12)
    flip = [([_snap(0, 10.0, wait=w)], None)
            for w in (0.5, 8.0, 8.0, 0.5, 9.0)]
    heartbeat = [([_snap(0, 10.0, t=NOW - 600), _snap(1, 10.0, t=NOW - 1)],
                  None), ([_snap(0, 10.0)], None)]
    straggler = [([], _skew_summary()), ([], _skew_summary()),
                 ([], _skew_summary(2, "device_compute")),
                 ([], _skew_summary(significant=False))]
    return {"spike": ({"zscore": 3.0, "min_history": 8}, spike),
            "recovery": ({"zscore": 3.0, "min_history": 4}, recovery),
            "flip": ({"min_history": 999}, flip),
            "heartbeat": ({"heartbeat_s": 120.0}, heartbeat),
            "straggler": ({}, straggler)}


@pytest.mark.parametrize("name", sorted(_sequences()))
def test_detector_matches_jax(name):
    kwargs, seq = _sequences()[name]
    det, jdet = monitor.AnomalyDetector(**kwargs), \
        jmonitor.AnomalyDetector(**kwargs)
    raised = 0
    for snaps, summ in seq:
        new = det.update(snaps, now=NOW, skew=summ)
        assert new == jdet.update(snaps, now=NOW, skew=summ)
        assert det.anomalies() == jdet.anomalies()
        raised += len(new)
    assert raised > 0


def test_new_anomalies_land_on_flight_recorder():
    monitor.observe_cluster([_snap(0, 10.0, t=NOW - 600)], now=NOW)
    skew.set_last_summary(_skew_summary())
    monitor.observe_cluster([], now=NOW)
    events = observability.recorder.events()
    assert [e["kind"] for e in events] == ["anomaly", "straggler"]
    assert "its cause is data_wait" in events[-1]["detail"]


def test_sync_cluster_feeds_skew_and_the_detector():
    _run_some_steps()
    assert skew.last_summary()["hosts"][0]["steps"] == 6
    assert set(monitor.detector()._lat) == {0}
    observability.reset()
    assert monitor.detector()._lat == {} and skew.last_summary() is None


# -- the aggregate --------------------------------------------------------------

def _hist(p50, total=500.0, **kw):
    return dict({"count": 50, "total": total, "window": 50, "mean": p50,
                 "min": 9.0, "max": 12.0, "p50": p50, "p90": 11.0}, **kw)


def _agg_snaps():
    chief = {"host": 0, "pid": 100, "time": NOW - 1,
             "counters": {"step.count": 50},
             "gauges": {"step.examples_per_sec": 1000.0},
             "histograms": {"step.latency_ms": _hist(10.0)},
             "phases": {}, "events": []}
    straggler = dict(chief, host=1, pid=101, histograms={
        "step.latency_ms": _hist(50.0, total=2500.0, p90=60.0)})
    silent = dict(chief, host=2, pid=102, time=NOW - 600, histograms={
        "step.latency_ms": _hist(10.4, total=520.0)})
    starved = dict(chief, host=3, pid=103, histograms={
        "step.latency_ms": _hist(10.0),
        "step.data_wait_ms": _hist(8.0)})
    fed = dict(starved, host=4, histograms={
        "step.latency_ms": _hist(10.0), "step.data_wait_ms": _hist(0.5)})
    return [chief, straggler, silent, starved, fed]


@pytest.mark.parametrize("hosts", [(0, 1, 2), (3, 4), (0, 1, 2, 3, 4)])
def test_aggregate_matches_jax(hosts):
    snaps = [s for s in _agg_snaps() if s["host"] in hosts]
    got = cluster.aggregate(snaps, now=NOW)
    assert got == jcluster.aggregate(snaps, now=NOW)
    bound = {h: got["hosts"][h]["bound"] for h in hosts}
    if 3 in hosts:
        assert bound[3] == "input" and bound[4] == "compute"
        assert any("host 3 input-bound" in w for w in got["warnings"])
    if 1 in hosts:
        assert any("host 1 straggling" in w for w in got["warnings"])
        assert any("host 2 heartbeat stale" in w for w in got["warnings"])


# -- the exposition -------------------------------------------------------------

def _fill(obs_mod, cluster_mod, skew_mod, profile_mod, memory_mod):
    reg = obs_mod.registry()
    reg.counter("step.count").inc(12)
    reg.counter("serve.requests").inc(3)
    reg.gauge("step.examples_per_sec").set(1234.5)
    reg.gauge("attr.wall_ms").set(2.5)
    reg.gauge("mem.none").set(None)
    reg.histogram("step.latency_ms").observe_many([1.0, 2.0, 3.5, 4.0])
    reg.histogram("serve.latency_ms").observe_many([5.0, 7.0])
    cluster_mod._ingest(_agg_snaps()[:2])
    skew_mod.set_last_summary({"hosts": {
        0: {"offset_ms": 0.0, "skew_wait_ms": 0.5, "wire_ms": 0.0},
        1: {"offset_ms": 2.5, "skew_wait_ms": 0.0, "wire_ms": 0.5}}})
    profile_mod.set_last_profile({
        "scopes": {"layer0/attn": {"compute_ms": 1.5, "comms_ms": 0.25,
                                   "wire_bytes": 1024.0},
                   "embed": {"compute_ms": 0.5, "comms_ms": 0.0,
                             "wire_bytes": 0.0}},
        "top": ["layer0/attn", "embed"]})
    memory_mod._last_summary = {
        "predicted": {"params_bytes": 2.0 * (1 << 30),
                      "activations_bytes": 1.0 * (1 << 30)},
        "predicted_peak_gb": 3.0, "measured_peak_gb": 3.5,
        "capacity_gb": 80.0, "prediction_error_pct": -14.29}


def test_prometheus_text_matches_jax(monkeypatch):
    _fill(observability, cluster, skew, profile, memory)
    _fill(jobs, jcluster, jskew, jprofile, jmemory)
    monkeypatch.setattr(time, "time", lambda: NOW)
    got, want = monitor.prometheus_text(), jmonitor.prometheus_text()
    assert got == want
    lines = [l for l in got.splitlines() if l.strip()]
    assert all(_PROM_LINE.match(l) for l in lines), lines
    for name in ("autodist_step_count_total",
                 'autodist_step_latency_ms{quantile="0.5"}',
                 'autodist_host_clock_offset_ms{host="1"} 2.5',
                 'autodist_profile_compute_ms{scope="layer0/attn"} 1.5',
                 'autodist_mem_predicted_gb{class="params"} 2.0',
                 "autodist_anomalies_active 0"):
        assert name in got


# -- the HTTP server ------------------------------------------------------------

def test_metrics_and_status_endpoints():
    _run_some_steps()
    try:
        _start_free()
        status, ctype, body = _get("/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        lines = [l for l in body.splitlines() if l.strip()]
        assert lines and all(_PROM_LINE.match(l) for l in lines)
        assert "autodist_step_count_total 6" in body
        assert "autodist_step_latency_ms_count 6" in body
        assert "autodist_skew_wait_ms_per_step" in body
        status, ctype, body = _get("/status")
        assert status == 200 and ctype.startswith("application/json")
        doc = json.loads(body)
        assert doc["step"]["count"] == 6 and doc["step"]["p50_ms"] > 0
        assert doc["attribution"]["steps"] == 6
        assert doc["skew"]["windows"] == 6
        assert doc["profile"]["sources"]["compute"] == "aten-flops"
        assert doc["goodput"]["goodput_pct"] > 0
        assert doc["hosts"]["0"]["heartbeat_age_s"] is not None
        assert json.loads(_get("/healthz")[2])["hosts_reporting"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _get("/bogus")
        assert e.value.code == 404
    finally:
        monitor.stop()


def test_status_sections_are_the_jax_pages_less_retune(monkeypatch):
    monkeypatch.setattr(jmonitor, "_snapshots", lambda: [])
    monkeypatch.setattr(monitor, "_snapshots", lambda: [])
    assert set(jmonitor.status()) - set(monitor.status()) == {"retune"}
    assert set(monitor.status()) <= set(jmonitor.status())


def test_start_is_idempotent_and_stop_frees_the_port():
    try:
        p1 = _start_free()
        assert monitor.start(0) == p1 == monitor.port() and monitor.running()
    finally:
        monitor.stop()
    assert not monitor.running() and monitor.port() is None
    with socket.socket() as s:   # the port is free again
        s.bind(("0.0.0.0", p1))


def test_disabled_telemetry_never_starts_monitor(monkeypatch):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    monkeypatch.setenv("AUTODIST_MONITOR_PORT", "18123")
    observability.refresh()
    before = {t.name for t in threading.enumerate()}
    assert monitor.ensure_started() is None
    _run_some_steps()
    assert not monitor.running() and monitor.port() is None
    new = {t.name for t in threading.enumerate()} - before
    assert not any("autodist-monitor" in n for n in new), new


def test_no_port_never_starts_monitor():
    assert monitor.ensure_started() is None
    _run_some_steps()
    assert not monitor.running()


def test_env_port_starts_the_monitor_from_the_runner(monkeypatch):
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free = s.getsockname()[1]
        monkeypatch.setenv("AUTODIST_MONITOR_PORT", str(free))
        try:
            _run_some_steps()
            if monitor.port() == free:
                break
        finally:
            if monitor.port() != free:
                monitor.stop()
    try:
        assert monitor.running() and monitor.port() == free
        assert json.loads(_get("/status")[2])["step"]["count"] == 6
        kinds = [e["kind"] for e in observability.recorder.events()]
        assert "monitor-start" in kinds
    finally:
        monitor.stop()
