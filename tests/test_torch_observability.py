"""The port's observability pillars against the JAX package's: metrics,
Chrome-trace spans, the flight recorder and the cluster snapshots.

* the registry, the phase accumulator and ``recorder.read_jsonl``: the same inputs through both packages give
  equal outputs (exact);
* the Runner's loop on a one-rank gloo world: every framework phase's
  span (``capture`` -> ``strategy-build`` -> ``transform`` -> ``compile``
  (a graph step's capture) -> ``step-loop``), the step metrics against the
  wall clock, the data wait, the trace flushed per process, the
  ``AUTODIST_TRACE=profiler`` bridge into a ``torch.profiler`` trace;
* ``CheckpointManager.run``'s loop telemetry and the checkpoint spans and
  counters; resilience events on the flight recorder;
* ``AUTODIST_TELEMETRY=0``: zero telemetry calls in the loop (a spy on
  every entry point) and no files;
* flight-file rotation under ``AUTODIST_FLIGHT_MAX_MB``;
* a two-rank gloo world whose chief gathers both ranks' snapshots over the
  c10d store, and a chief that fails open when a rank never arrives;
* every metric name and event kind the port emits is the JAX package's,
  documented in ``docs/observability.md`` or ``docs/memory.md``.
"""
import ast
import functools
import itertools
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autodist_tpu import observability as jobs
from autodist_tpu_torch import AutoDist, const, observability
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from test_torch_ps_strategies import RANK_TIMEOUT_S, WORLD_TIMEOUT_S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 16
PHASES = ("capture", "strategy-build", "transform", "compile", "step-loop")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Default (on) telemetry, empty buffers, and the files telemetry
    writes under tmp_path."""
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_TRACE", "AUTODIST_CHAOS",
                 "AUTODIST_FLIGHT_MAX_MB", "AUTODIST_METRICS_WINDOW"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "cal.json"))
    monkeypatch.setattr(const, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setattr(const, "DEFAULT_TRACE_DIR", str(tmp_path / "traces"))
    observability.recorder._reset_sidecar_for_tests()
    autodist_mod._reset_default()
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    yield
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    observability.recorder._reset_sidecar_for_tests()
    autodist_mod._reset_default()


def _loss_fn(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    return ((h @ params["w2"] - y) ** 2).mean()


def _build():
    rng = np.random.RandomState(0)
    params = {"w1": torch.zeros(8, 16), "w2": torch.zeros(16, 4)}
    batch = (torch.tensor(rng.randn(BATCH, 8), dtype=torch.float32),
             torch.tensor(rng.randn(BATCH, 4), dtype=torch.float32))
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(_loss_fn, params,
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _repeat(batch):
    while True:
        yield batch


# -- the pillars against the JAX package's ------------------------------------

def _drive_registry(reg):
    reg.counter("step.count").inc(3)
    reg.counter("step.count").inc()
    reg.gauge("compile.ms").set(12.5)
    reg.gauge("padding.bytes").set(0)
    h = reg.histogram("step.latency_ms", window=4)
    h.observe_many([5.0, 1.0, 3.0])
    h.observe(9.0)
    h.observe_many([2.0, 7.0])
    reg.histogram("step.data_wait_ms").observe_many([0.25] * 3)
    reg.histogram("empty")
    return reg.snapshot()


def test_metrics_registry_matches_jax():
    got = _drive_registry(observability.metrics.MetricsRegistry())
    assert got == _drive_registry(jobs.metrics.MetricsRegistry())
    assert got["histograms"]["step.latency_ms"]["window"] == 4
    assert got["histograms"]["empty"] == {"count": 0, "total": 0.0}


def test_phase_summary_matches_jax():
    for trc in (observability.tracing, jobs.tracing):
        trc.record_complete("compile", 100.0, 2500.0, {"path": "graph"})
        trc.record_complete("compile", 9000.0, 500.0)
        trc.record_complete("step-loop", 50.0, 12000.0)
    assert observability.tracing.phase_summary() == \
        jobs.tracing.phase_summary()
    evs = observability.tracing.events()
    assert [e["name"] for e in evs] == ["compile", "compile", "step-loop"]
    assert evs[0]["args"] == {"path": "graph"} and evs[0]["ph"] == "X"


def test_read_jsonl_torn_line_matches_jax(tmp_path):
    path = tmp_path / "flight_1.jsonl"
    path.write_text('{"kind": "a", "detail": ""}\nnot json\n'
                    '{"kind": "b"}\n{"kind": "c", "det')
    got = observability.recorder.read_jsonl(str(path))
    assert got == jobs.recorder.read_jsonl(str(path))
    assert [e["kind"] for e in got[0]] == ["a", "b"] and got[1] is True


def test_event_types_are_the_jax_packages():
    assert observability.recorder.EVENT_TYPES == jobs.recorder.EVENT_TYPES


# -- the Runner's loop ----------------------------------------------------------

def test_full_loop_emits_chrome_trace_with_all_phases(tmp_path):
    runner, batch = _build()
    state = runner.create_state()
    runner.run(state, _repeat(batch), 8, unroll=4)
    path = observability.flush_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    assert set(PHASES) | {"distributed-init"} <= names
    for e in spans:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert e["cat"] == "autodist" and "pid" in e and "tid" in e
    by_name = {e["name"]: e for e in spans}
    assert by_name["capture"]["ts"] <= by_name["strategy-build"]["ts"]
    loop, comp = by_name["step-loop"], by_name["compile"]
    assert loop["ts"] <= comp["ts"] <= loop["ts"] + loop["dur"]
    assert doc["metadata"]["host"] == 0
    instants = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "i"}
    assert {"mesh-built", "transform", "compile", "goodput", "memory",
            "attribution"} <= instants


def test_run_flushes_trace_into_default_trace_dir():
    runner, batch = _build()
    runner.run(runner.create_state(), _repeat(batch), 2)
    default = observability.tracing.default_trace_path()
    assert default.startswith(const.DEFAULT_TRACE_DIR)
    assert str(os.getpid()) in os.path.basename(default)
    with open(default) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("unroll", [1, 4])
def test_step_metrics_consistent_with_wall_clock(unroll, monkeypatch):
    # One flush, at the loop's end: the throughput gauge then covers the
    # same dispatches as the histogram's total.
    monkeypatch.setenv("AUTODIST_GUARD_CHECK_EVERY", "1000")
    runner, batch = _build()
    state = runner.create_state()
    state, _ = runner.run(state, _repeat(batch), unroll)  # capture first
    observability.registry().reset()
    steps = 12
    t0 = time.perf_counter()
    runner.run(state, _repeat(batch), steps, unroll=unroll)
    wall_ms = (time.perf_counter() - t0) * 1e3
    snap = observability.registry().snapshot()
    assert snap["counters"]["step.count"] == steps
    assert snap["counters"]["step.examples"] == steps * BATCH
    assert snap["counters"]["host_transfer.batches"] == steps // unroll
    hist = snap["histograms"]["step.latency_ms"]
    assert hist["count"] == steps // unroll
    # Per dispatch / K: the total x K is the loop's own wall clock.
    assert 0 < hist["total"] * unroll <= wall_ms * 1.05
    assert hist["min"] <= hist["p50"] <= hist["p90"] <= hist["max"]
    eps = snap["gauges"]["step.examples_per_sec"]
    implied = steps * BATCH / (hist["total"] * unroll / 1e3)
    assert eps == pytest.approx(implied, rel=1e-6, abs=0.05)
    assert snap["gauges"].get("step.unroll") == (unroll if unroll > 1
                                                 else None)


def test_step_data_wait_metric_populated():
    runner, batch = _build()
    state = runner.create_state()
    state, _ = runner.step(state, batch)

    def slow_iter():
        while True:
            time.sleep(0.02)
            yield batch

    observability.registry().reset()
    steps = 6
    runner.run(state, slow_iter(), steps)
    snap = observability.registry().snapshot()
    wait = snap["histograms"]["step.data_wait_ms"]
    assert wait["count"] == steps
    assert wait["min"] >= 15.0 and wait["total"] >= steps * 15.0
    lat = snap["histograms"]["step.latency_ms"]
    assert wait["total"] <= lat["total"] * 1.05
    assert observability.attribution.last_summary()["data_wait_ms"] >= 15.0


def test_compile_and_padding_metrics_populated():
    runner, batch = _build()
    assert observability.registry().snapshot()["gauges"][
        "padding.bytes"] == 0
    fn = runner.make_callable(batch, aot=True)
    state = runner.create_state()
    state, _ = fn(state, batch)
    snap = observability.registry().snapshot()
    assert snap["gauges"]["compile.ms"] > 0
    assert observability.phase_timings()["compile"]["count"] == 1
    fn(state, batch)  # a replay: no second compile
    assert observability.phase_timings()["compile"]["count"] == 1


def test_dispatch_clock_on_the_cpu():
    from autodist_tpu_torch.runner import DispatchClock
    clock = DispatchClock("cpu")
    assert not clock.cuda
    clock.start()
    time.sleep(0.01)
    clock.mark(4, 0.001)
    clock.mark(1, 0.0)
    done = clock.drain()
    assert [st for _, st, _, _ in done] == [4, 1]
    assert done[0][0] >= 0.009 and done[0][2] == 0.001
    assert [compiled for *_, compiled in done] == [False, False]
    assert clock.drain(final=True) == []
    clock.mark(1, 0.0)
    clock.start()
    assert clock.drain() == []


def test_profiler_mode_writes_a_torch_profiler_trace():
    os.environ["AUTODIST_TRACE"] = "profiler"
    try:
        observability.refresh()
        runner, batch = _build()
        runner.run(runner.create_state(), _repeat(batch), 4, unroll=2)
    finally:
        del os.environ["AUTODIST_TRACE"]
        observability.refresh()
    path = os.path.join(const.DEFAULT_TRACE_DIR, "trace-rank0.json")
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    loops = [e for e in evs if e.get("name") == "step-loop"
             and e.get("cat") == "user_annotation"]
    assert len(loops) == 1
    a, b = loops[0]["ts"], loops[0]["ts"] + loops[0]["dur"]
    # The 4 steps' two forward products at least, inside the range (the
    # ledgers' cost pass after the loop traces the loss on meta tensors,
    # outside it).
    mm = [e for e in evs if e.get("cat") == "cpu_op"
          and e.get("name") in ("aten::mm", "aten::addmm")
          and a <= e["ts"] <= b]
    assert len(mm) >= 4 * 2


def test_sync_single_process_returns_local_snapshot():
    runner, batch = _build()
    runner.run(runner.create_state(), _repeat(batch), 3)
    snaps = observability.cluster.gathered()
    assert len(snaps) == 1 and snaps[0]["host"] == 0
    assert snaps[0]["counters"]["step.count"] >= 3
    assert {"phases", "events", "attribution", "goodput", "memory"} <= \
        set(snaps[0])


def test_flight_recorder_unifies_resilience_events():
    from autodist_tpu_torch import resilience
    resilience.record_event("rollback", "divergence at step 7")
    ev = [e for e in observability.recorder.events()
          if e["kind"] == "rollback"][-1]
    assert ev["source"] == "resilience" and ev["detail"] == \
        "divergence at step 7"
    sidecar = observability.recorder.sidecar_path()
    assert os.path.basename(sidecar) == f"flight_{os.getpid()}.jsonl"
    lines = [json.loads(l) for l in open(sidecar) if l.strip()]
    assert any(e["kind"] == "rollback" for e in lines)


def test_checkpoint_manager_run_telemetry(tmp_path):
    from autodist_tpu_torch.checkpoint import CheckpointManager
    runner, batch = _build()
    mgr = CheckpointManager(runner, tmp_path / "ckpt", save_interval_steps=4)
    state, _ = mgr.run(runner.create_state(), _repeat(batch), 8, unroll=4)
    mgr.close()
    snap = observability.registry().snapshot()
    assert snap["counters"]["step.count"] == 8
    assert snap["counters"]["checkpoint.saves"] == 2
    assert snap["gauges"]["checkpoint.last_save_ms"] > 0
    assert snap["histograms"]["step.latency_ms"]["count"] == 2
    phases = observability.phase_timings()
    assert phases["checkpoint-save"]["count"] == 2
    assert phases["step-loop"]["count"] == 1
    assert observability.goodput.last_summary()["steps"] == 8
    kinds = [e["kind"] for e in observability.recorder.events()]
    assert kinds.count("checkpoint-save") == 2
    autodist_mod._reset_default()
    runner2, _ = _build()
    CheckpointManager(runner2, tmp_path / "ckpt").restore_or_init()
    assert observability.registry().snapshot()["counters"][
        "checkpoint.restores"] == 1
    assert observability.phase_timings()["restore"]["count"] == 1


def test_preemption_save_is_an_emergency_save_span(tmp_path):
    import signal
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.resilience import Preempted, PreemptionHandler
    runner, batch = _build()
    mgr = CheckpointManager(runner, tmp_path / "ckpt")
    handler = PreemptionHandler()
    handler.preempted, handler.signum = True, signal.SIGTERM
    with pytest.raises(Preempted):
        handler.check(mgr, 3, runner.create_state())
    assert observability.phase_timings()["emergency-save"]["count"] == 1
    kinds = [e["kind"] for e in observability.recorder.events()]
    assert "preemption" in kinds


# -- the off switch ---------------------------------------------------------------

def test_disabled_step_loop_makes_zero_telemetry_calls(monkeypatch,
                                                       tmp_path):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    observability.refresh()
    assert not observability.enabled()
    runner, batch = _build()  # the Runner caches the disabled handle
    state = runner.create_state()
    state, _ = runner.step(state, batch)

    calls = []

    def spy(label):
        def _record(*a, **k):
            calls.append(label)
        return _record

    from autodist_tpu_torch import runner as runner_mod
    from autodist_tpu_torch.pipeline import observe as pipe_observe
    from autodist_tpu_torch.tuner import calibration
    o = observability
    for target, name, label in (
            (o.tracing.Span, "__enter__", "span"),
            (o.tracing, "record_complete", "trace"),
            (o.tracing, "record_instant", "instant"),
            (o.recorder, "record", "recorder"),
            (o.metrics.Counter, "inc", "counter"),
            (o.metrics.Gauge, "set", "gauge"),
            (o.metrics.WindowHistogram, "observe_many", "histogram"),
            (o.metrics.WindowHistogram, "observe", "histogram"),
            (o.cluster, "sync", "sync"),
            (o.tracing, "flush", "flush"),
            (o.attribution.Ledger, "observe", "attribution"),
            (o.attribution, "terms_for_runner", "attribution-terms"),
            (o.attribution, "finalize", "attribution-finalize"),
            (o.goodput, "collect", "goodput-collect"),
            (o.goodput, "finalize", "goodput-finalize"),
            (o.goodput, "persist_segment", "goodput-persist"),
            (pipe_observe, "finalize", "pipeline-finalize"),
            (pipe_observe, "pipeline_shape", "pipeline-shape"),
            (o.memory, "MemoryLedger", "memory-ledger"),
            (o.memory, "predicted_for_runner", "memory-predict"),
            (o.memory, "measured_sample", "memory-sample"),
            (o.memory, "finalize", "memory-finalize"),
            (o.memory, "oom_report", "memory-oom"),
            (calibration.Calibration, "save", "calibration"),
            (calibration, "path_for", "calibration-path"),
            (runner_mod, "DispatchClock", "clock"),
            (time, "perf_counter", "clock")):
        monkeypatch.setattr(target, name, spy(label))
    for unroll in (1, 4):
        state, metrics_out = runner.run(state, _repeat(batch), 8,
                                        unroll=unroll)
        assert metrics_out is not None  # the loop itself still works
    monkeypatch.undo()
    assert calls == [], f"telemetry calls on the disabled loop: {calls}"
    for d in ("logs", "traces"):
        assert not (tmp_path / d).exists() or not [
            p for p in (tmp_path / d).iterdir()
            if not p.name.startswith("log_")]
    assert not (tmp_path / "cal.json").exists()


def test_disabled_runner_records_no_spans(monkeypatch):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    observability.refresh()
    observability.reset()
    runner, batch = _build()
    runner.run(runner.create_state(), _repeat(batch), 4, unroll=2)
    assert observability.tracing.events() == []
    assert observability.registry().snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}
    assert observability.sync_cluster() == []
    assert observability.flush_trace() is None


# -- flight-file rotation -----------------------------------------------------------

def test_flight_recorder_rotation_bounds_disk(tmp_path, monkeypatch):
    logdir = tmp_path / "logs"
    monkeypatch.setenv("AUTODIST_FLIGHT_MAX_MB", "1")
    for i in range(8000):
        observability.recorder.record("chaos:nan", "x" * 400, i=i)
    files = sorted(logdir.glob("flight_*.jsonl"))
    assert len(files) > 1, "the sidecar never rolled to a new segment"
    total = sum(f.stat().st_size for f in files)
    cap = 1 << 20
    assert total <= cap + (cap // 8) + (1 << 14), [f.name for f in files]
    assert f"flight_{os.getpid()}.jsonl" not in {f.name for f in files}
    newest = max(files, key=lambda f: f.stat().st_mtime)
    lines = [json.loads(l) for l in open(newest) if l.strip()]
    assert lines[-1]["i"] == 7999


# -- a gloo world: the chief gathers every rank's snapshot ---------------------------

_SYNC_RANK = r'''
import datetime, functools, itertools, json, os, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, observability
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce

mode = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
if mode == "run":  # a loaded test host may starve a rank past 10 s
    observability.cluster._GATHER_TIMEOUT_MS = 1000 * int(
        float(os.environ["WORLD_TIMEOUT_S"]))
dist.init_process_group("gloo", rank=rank, world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))


def loss_fn(params, batch):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean()


rng = np.random.RandomState(rank)
batch = (torch.tensor(rng.randn(8, 4), dtype=torch.float32),
         torch.tensor(rng.randn(8, 2), dtype=torch.float32))
ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
runner = ad.create_distributed_session(ad.capture(
    loss_fn, {"w": torch.zeros(4, 2)},
    functools.partial(torch.optim.SGD, lr=0.1), example_batch=batch))
state = runner.create_state()
if mode == "run":
    runner.run(state, itertools.repeat(batch), 4, unroll=2)
    out = {"gathered": [[s["host"], s["pid"], s["counters"]["step.count"],
                         sorted(s["attribution"])]
                        for s in observability.cluster.gathered()]}
else:  # rank 1 never publishes: the chief's wait ends at its timeout
    if rank == 0:
        snaps = observability.cluster.sync(timeout_ms=1500)
        out = {"gathered": [s["host"] for s in snaps],
               "events": [e["kind"] for e in observability.recorder.events()]}
    else:
        out = {"gathered": []}
dist.barrier()
dist.destroy_process_group()
print(json.dumps(dict(out, pid=os.getpid())))
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(world, args, cwd):
    for _ in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_",
                                    "LOCAL_", "AUTODIST_"))}
        env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", WORLD_TIMEOUT_S=str(WORLD_TIMEOUT_S),
                   AUTODIST_WORKING_DIR=str(cwd))
        procs = [subprocess.Popen(
            [sys.executable, "-c", _SYNC_RANK, *args], cwd=cwd,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs, err = [], ""
        try:
            for p in procs:
                out, e = p.communicate(timeout=RANK_TIMEOUT_S)
                if p.returncode != 0:
                    err = e[-4000:]
                    break
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not err:
            return outs, ""
        if "ddress already in use" not in err:
            break
    return None, err


def test_gloo_chief_gathers_every_ranks_snapshot(tmp_path):
    outs, err = _run_world(2, ["run"], tmp_path)
    assert outs is not None, err
    chief, worker = outs
    assert [g[0] for g in chief["gathered"]] == [0, 1]
    assert [g[1] for g in chief["gathered"]] == [chief["pid"], worker["pid"]]
    assert all(g[2] == 4 for g in chief["gathered"])
    assert all("wall_ms" in g[3] for g in chief["gathered"])
    assert [g[0] for g in worker["gathered"]] == [1]
    # One trace and one flight file per process.
    traces = sorted(p.name for p in (tmp_path / "traces").iterdir())
    assert traces == sorted(f"autodist_trace_{o['pid']}.json" for o in outs)
    flights = {p.name for p in (tmp_path / "logs").glob("flight_*.jsonl")}
    assert flights == {f"flight_{o['pid']}.jsonl" for o in outs}


def test_gloo_chief_fails_open_on_a_missing_rank(tmp_path):
    outs, err = _run_world(2, ["missing"], tmp_path)
    assert outs is not None, err
    assert outs[0]["gathered"] == [0]
    assert "straggler" in outs[0]["events"]


# -- names: the JAX package's, documented -------------------------------------------

def _port_calls():
    """(metric names, event kinds) the port's sources emit: the literal
    first arguments of ``.gauge`` / ``.counter`` / ``.histogram`` and of
    ``record_event`` / ``recorder.record`` (an f-string's literal parts
    with ``*`` for each field)."""
    metrics, events = set(), set()
    pkg = os.path.join(ROOT, "autodist_tpu_torch")
    for base, _, files in os.walk(pkg):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, fname)).read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and node.args and
                        isinstance(node.func, ast.Attribute)):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    text = arg.value
                elif isinstance(arg, ast.JoinedStr):
                    text = "".join(v.value if isinstance(v, ast.Constant)
                                   else "*" for v in arg.values)
                else:
                    continue
                name = node.func.attr
                if name in ("gauge", "counter", "histogram"):
                    metrics.add(text)
                elif name in ("record_event", "record") and "." not in text \
                        and " " not in text:
                    events.add(text)
    return metrics, events


def test_port_metric_names_are_documented():
    metrics, _ = _port_calls()
    docs = (open(os.path.join(ROOT, "docs", "observability.md")).read() +
            open(os.path.join(ROOT, "docs", "memory.md")).read())
    assert len(metrics) > 30
    missing = []
    for name in sorted(metrics):
        if "*" in name:  # the docs' `goodput.<i>`, `serve.replica<i>.x`
            ok = f"`{name.replace('*', '<i>')}`" in docs
        else:
            ok = f"`{name}`" in docs
        if not ok:
            missing.append(name)
    assert missing == []


def test_port_event_kinds_are_the_jax_packages():
    _, events = _port_calls()
    assert {"compile", "checkpoint-save", "checkpoint-restore",
            "strategy-ship", "transform", "mesh-built", "pipeline",
            "attribution", "goodput", "memory", "oom",
            "straggler"} <= events
    assert events <= jobs.recorder.EVENT_TYPES, \
        events - jobs.recorder.EVENT_TYPES
    from autodist_tpu_torch.observability import goodput
    assert events <= set(goodput.EVENT_CLASS)


def test_observability_imports_with_jax_made_unimportable():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'autodist_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import autodist_tpu_torch.observability as o\n"
            "import autodist_tpu_torch.tuner, autodist_tpu_torch.pipeline.observe\n"
            "print(sorted(o.__all__)[0])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "attribution"


def test_pipeline_gauges_from_the_cut(tmp_path):
    """``pipeline/observe.finalize`` on a ``Pipeline(2, 4)`` runner: the
    stage / microbatch gauges and the port's bubble (S-1)/(M+S-1)."""
    from autodist_tpu_torch.pipeline import observe as pipe_observe

    class _Prog:
        class strategy:
            class graph_config:
                pipeline_microbatches = 4

        class mesh:
            shape = {"data": 1, "pipe": 2}

    class _Runner:
        program = _Prog

    reg = observability.registry()
    reg.histogram("step.latency_ms").observe_many([10.0] * 3)
    out = pipe_observe.finalize(_Runner, reg)
    gauges = reg.snapshot()["gauges"]
    assert gauges["pipeline.stages"] == 2
    assert gauges["pipeline.microbatches"] == 4
    assert gauges["pipeline.bubble_fraction"] == round(1 / 5, 4)
    assert gauges["pipeline.bubble_ms_per_step"] == pytest.approx(
        10.0 * 0.2 * (1.0 + out["imbalance"]))
    _Prog.mesh.shape = {"data": 2}
    assert pipe_observe.finalize(_Runner, reg) is None
