"""The port's clock sync and skew decomposition against the JAX package.

* ``estimate_offset`` / ``_note_drift`` on the same synthetic samples:
  equal (the same float arithmetic; held at 1e-12);
* ``decompose`` on the same seeded snapshots (two and three ranks, an
  offset clock, a lagging rank, at ``unroll`` 1 and 4): every figure the
  JAX package reports, equal at 1e-12, and ``wire + skew_wait ==
  exposed_comms`` per rank and window to 1e-9; the port adds where each
  rank's ``exposed_comms`` came from (``sources``);
* the ping over a c10d store: two gloo ranks recover a planted clock
  shift within the estimate's own uncertainty (rtt/2), and a two-rank
  ``Runner.run`` decomposes both rings on the chief at its end;
* the Runner's ring: one window a dispatch, bounded by
  ``AUTODIST_SKEW_RING``, off at 0, and no ping, ring append or store
  call at all with telemetry off (a spy);
* ``attribution.feed_calibration`` subtracts the local skew wait, as in
  the JAX package (``tests/test_skew.py:287``).
"""
import functools
import json
import time

import numpy as np
import pytest
import torch

from autodist_tpu import observability as jobs
from autodist_tpu.observability import skew as jskew
from autodist_tpu_torch import AutoDist, const, observability
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.observability import attribution, skew, tracing
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from test_torch_ps_strategies import ROOT, _run_world

BATCH = 16
EXACT = 1e-12   # the same arithmetic on the same floats


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_SKEW_RING",
                 "AUTODIST_CLOCK_SYNC", "AUTODIST_TRACE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_WORKING_DIR", str(tmp_path))
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "c.json"))
    monkeypatch.setattr(const, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setattr(const, "DEFAULT_TRACE_DIR", str(tmp_path / "traces"))
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    yield
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    autodist_mod._reset_default()


# -- the estimator ------------------------------------------------------------

def _sample(true_offset_s, req_delay_s, rep_delay_s, t0=100.0, serve_s=0.0):
    """One ping sample against a reference clock the local clock runs
    ``true_offset_s`` ahead of (``tests/test_skew.py``'s fixture)."""
    t_recv = (t0 - true_offset_s) + req_delay_s
    t_send = t_recv + serve_s
    t1 = (t_send + true_offset_s) + rep_delay_s
    return (t0, t_recv, t_send, t1)


def _sample_sets():
    rng = np.random.RandomState(0)
    sets = []
    for true_ms in (-40.0, -0.5, 0.0, 3.0, 250.0):
        sets.append([_sample(true_ms / 1e3, rng.uniform(0, 2e-3),
                             rng.uniform(0, 2e-3), t0=50.0 + i)
                     for i in range(5)])
    sets.append([_sample(0.01, 6e-3, 0.0)])               # one-legged
    sets.append([_sample(0.005, 0.5, 0.0), _sample(0.005, 1e-4, 1e-4)])
    sets.append([_sample(0.002, 1e-4, 1e-4, serve_s=2.0)])
    sets.append([(0.0, 0.0, 10.0, 0.1)])                  # negative rtt
    sets.append([])
    return sets


@pytest.mark.parametrize("i", range(10))
def test_estimate_offset_matches_jax(i):
    samples = _sample_sets()[i]
    got, want = skew.estimate_offset(samples), jskew.estimate_offset(samples)
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=EXACT, abs=EXACT)
    if i < 5:  # the true offset lies within rtt/2 of the estimate
        true_ms = (-40.0, -0.5, 0.0, 3.0, 250.0)[i]
        assert abs(got["offset_ms"] - true_ms) <= got["uncertainty_ms"] \
            + 1e-9


def test_drift_matches_jax():
    for mod in (skew, jskew):
        mod._note_drift(3, {"offset_ms": 1.0}, now=1000.0)
    a, b = {"offset_ms": 3.0}, {"offset_ms": 3.0}
    skew._note_drift(3, a, now=1010.0)
    jskew._note_drift(3, b, now=1010.0)
    assert a == b and a["drift_ppm"] == pytest.approx(200.0)


# -- the decomposition ----------------------------------------------------------

def _attr(exposed=0.5, data_wait=0.1, compute=1.0, dispatch=0.2, steps=8,
          unroll=1, source="cost-model"):
    wall = data_wait + dispatch + compute + exposed
    return {"wall_ms": wall, "data_wait_ms": data_wait,
            "host_dispatch_ms": dispatch, "device_compute_ms": compute,
            "exposed_comms_ms": exposed, "residual_ms": 0.0,
            "raw_compute_ms": compute, "raw_comms_ms": exposed,
            "steps": steps, "dispatches": steps // unroll, "unroll": unroll,
            "sources": {"exposed_comms": source}}


def _snapshots(unroll, hosts, seed=0):
    """Seeded per-rank snapshots: rank h's clock runs ``offset`` ahead and
    its dispatches lag ``lag`` s; rank 1 is the data-starved one."""
    rng = np.random.RandomState(seed)
    n = 16 // unroll
    base = 1_700_000_000.0
    dur = rng.uniform(2e-3, 4e-3, n) * unroll
    ends = base + np.cumsum(dur)
    snaps = []
    for h in range(hosts):
        offset_ms = (0.0, 3.0, -1.5)[h]
        lag = (0.0, 5e-3, 2e-4)[h] + rng.uniform(0, 1e-4, n)
        shift = lag + offset_ms / 1e3
        ring = [{"i": i * unroll, "s": round(float(e - d + s), 6),
                 "e": round(float(e + s), 6), "k": unroll,
                 "w": round(float(rng.uniform(0, 1)), 4)}
                for i, (e, d, s) in enumerate(zip(ends, dur, shift))]
        attr = _attr(unroll=unroll, data_wait=(0.1, 6.0, 0.2)[h],
                     exposed=(0.5, 0.5, 0.7)[h], steps=16)
        snaps.append({"host": h, "attribution": attr,
                      "skew": {"offset_ms": offset_ms,
                               "uncertainty_ms": (0.0, 0.01, 0.02)[h],
                               "drift_ppm": None, "ring": ring}})
    return snaps


PORT_ONLY = ("exposed_comms_source", "sources")


def _drop(summary):
    out = {k: v for k, v in summary.items() if k not in PORT_ONLY}
    out["hosts"] = {h: {k: v for k, v in row.items() if k not in PORT_ONLY}
                    for h, row in summary["hosts"].items()}
    return out


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=EXACT, abs=EXACT), path
    else:
        assert got == want, path


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_decompose_matches_jax(unroll, hosts):
    snaps = _snapshots(unroll, hosts)
    got, want = skew.decompose(snaps), jskew.decompose(snaps)
    _assert_close(_drop(got), want)
    assert got["sources"] == {"exposed_comms": ["cost-model"]}
    for row in got["hosts"].values():
        assert row["exposed_comms_source"] == "cost-model"
        assert row["wire_ms"] + row["skew_wait_ms"] == pytest.approx(
            row["exposed_comms_ms"], abs=1e-9)
        for w in row["windows"]:
            assert w["wire_ms"] + w["skew_wait_ms"] == pytest.approx(
                w["exposed_comms_ms"], abs=1e-9)
            assert w["skew_wait_ms"] >= 0 and w["wire_ms"] >= 0
    if hosts > 1:
        assert got["straggler"]["host"] == 1
        assert got["straggler"]["cause"] == "data_wait"
        assert got["significant"]


def test_decompose_without_payload_is_none():
    assert skew.decompose([{"host": 0}]) is None is jskew.decompose(
        [{"host": 0}])


# -- the Runner's ring ----------------------------------------------------------

def _loss_fn(params, batch):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean()


def _runner():
    autodist_mod._reset_default()
    rng = np.random.RandomState(0)
    batch = (torch.tensor(rng.randn(BATCH, 8), dtype=torch.float32),
             torch.tensor(rng.randn(BATCH, 4), dtype=torch.float32))
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(_loss_fn, {"w": torch.zeros(8, 4)},
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _repeat(batch):
    while True:
        yield batch


@pytest.mark.parametrize("unroll", [1, 4])
def test_runner_feeds_one_window_a_dispatch(unroll):
    runner, batch = _runner()
    runner.run(runner.create_state(), _repeat(batch), 8, unroll=unroll)
    ring = skew.ring()
    assert [r["i"] for r in ring] == list(range(0, 8, unroll))
    assert all(r["k"] == unroll and r["e"] >= r["s"] for r in ring)
    # Epoch seconds, in dispatch order, within this test's run.
    assert abs(ring[-1]["e"] - time.time()) < 60
    assert all(a["e"] <= b["e"] + 1e-6 for a, b in zip(ring, ring[1:]))
    snap = observability.snapshot()
    assert snap["skew"]["ring"] == ring
    # One rank: sync_cluster decomposed the ring into pure wire.
    summ = skew.last_summary()
    assert summ["windows"] == len(ring) and summ["straggler"] is None
    row = summ["hosts"][0]
    assert row["skew_wait_ms"] == 0.0
    assert row["wire_ms"] == pytest.approx(row["exposed_comms_ms"])
    assert summ["sources"]["exposed_comms"] == ["cost-model"]
    gauges = observability.registry().snapshot()["gauges"]
    assert gauges["skew.wait_ms_per_step"] == 0.0
    # The billed window of the goodput ledger, one a loop.
    assert observability.phase_timings()["step-dispatches"]["count"] == 1


def test_ring_is_bounded_and_disabled_by_knob(monkeypatch):
    monkeypatch.setenv("AUTODIST_SKEW_RING", "4")
    runner, batch = _runner()
    runner.run(runner.create_state(), _repeat(batch), 12)
    assert [r["i"] for r in skew.ring()] == [8, 9, 10, 11]
    observability.reset()
    monkeypatch.setenv("AUTODIST_SKEW_RING", "0")
    runner, batch = _runner()
    runner.run(runner.create_state(), _repeat(batch), 4)
    assert skew.ring() == []
    assert observability.snapshot().get("skew") is None


def test_telemetry_off_sends_no_ping_and_appends_nothing(monkeypatch):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    observability.refresh()
    calls = []

    def spy(label):
        def f(*a, **k):
            calls.append(label)
        return f
    for name in ("_sync_clocks", "observe_dispatches", "_kv_channel",
                 "store_channel", "update_from_snapshots"):
        monkeypatch.setattr(skew, name, spy(name))
    runner, batch = _runner()
    runner.run(runner.create_state(), _repeat(batch), 4, unroll=2)
    assert observability.sync_cluster() == []
    assert skew.maybe_sync_clocks() is None
    monkeypatch.undo()
    assert calls == []
    assert skew.ring() == [] and skew.local_offset() is None


def test_dispatch_clock_windows_on_the_cpu():
    from autodist_tpu_torch.runner import DispatchClock
    clock = DispatchClock("cpu", windows=True)
    clock.start()
    time.sleep(0.01)
    clock.mark(4, 0.002)
    clock.mark(1, 0.0)
    done = clock.drain(final=True)
    wins = clock.take_windows()
    assert [(st, w) for _, _, st, w in wins] == [(4, 0.002), (1, 0.0)]
    assert [round(d, 9) for _, d, _, _ in wins] == \
        [round(d, 9) for d, _, _, _ in done]
    assert wins[0][1] >= 0.009 and clock.take_windows() == []
    spans = [e for e in tracing.events() if e["name"] == "step-dispatches"]
    assert len(spans) == 1 and spans[0]["dur"] >= 9_000
    assert DispatchClock("cpu").take_windows() == []


# -- the calibration correction ---------------------------------------------------

class _SpyCal:
    def __init__(self):
        self.terms = []

    def observe_term(self, term, predicted, measured, context=""):
        self.terms.append((term, predicted, measured))


@pytest.mark.parametrize("wait", [0.0, 1.5, 2.5])
def test_feed_calibration_subtracts_skew_wait_like_jax(wait):
    from autodist_tpu.observability import attribution as jattribution
    summary = _attr(exposed=2.0, source="scheduled-hlo")
    out = []
    for mod, attr_mod in ((skew, attribution), (jskew, jattribution)):
        mod._local_skew_wait = wait
        cal = _SpyCal()
        attr_mod.feed_calibration(summary, calibration=cal)
        out.append(cal.terms)
    assert out[0] == out[1]
    comms = [t for t in out[0] if t[0] == "comms"]
    if wait < 2.0:
        assert comms[0][2] == pytest.approx(2.0 - wait)
    else:
        assert comms == []


def test_flushed_trace_carries_the_clock_offset(tmp_path):
    skew._local_offset = {"offset_ms": 1.25, "uncertainty_ms": 0.5}
    tracing.record_complete("x", 0.0, 1.0)
    path = tracing.flush(str(tmp_path / "t.json"))
    meta = json.load(open(path))["metadata"]
    assert meta["clock_offset_ms"] == 1.25
    assert meta["clock_uncertainty_ms"] == 0.5


# -- two gloo ranks over the c10d store -----------------------------------------

_PING = r'''
import datetime, json, os, sys, time
import torch.distributed as dist
from autodist_tpu_torch import observability
from autodist_tpu_torch.observability import skew
rank, world = int(sys.argv[-2]), int(sys.argv[-1])
shift_ms = float(sys.argv[1])
dist.init_process_group("gloo", rank=rank, world_size=world, timeout=
                        datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
out = {"true": skew.maybe_sync_clocks()}
if rank == 1:
    skew._wall = lambda: time.time() + shift_ms / 1e3
out["shifted"] = skew.maybe_sync_clocks()
print(json.dumps({str(k): v for k, v in (out["shifted"] or {}).items()}))
print(json.dumps({str(k): v for k, v in (out["true"] or {}).items()}))
dist.destroy_process_group()
'''


def test_ping_over_the_store_recovers_a_planted_shift():
    shift_ms = 37.5
    outs, err = _run_world(_PING, 2, [str(shift_ms)], ROOT)
    assert outs is not None, err
    shifted, true = (json.loads(line) for line in
                     outs[0].strip().splitlines()[-2:])
    est = shifted["1"]
    assert est["samples"] == 3
    assert abs(est["offset_ms"] - shift_ms) <= est["uncertainty_ms"] + 1e-9
    # The same clock on one host: offset 0 within the uncertainty.
    assert abs(true["1"]["offset_ms"]) <= true["1"]["uncertainty_ms"] + 1e-9
    assert shifted["0"]["offset_ms"] == 0.0
    # The drift tracker saw the second exchange.
    assert est.get("drift_ppm") is not None
    # The worker's own estimate is the one the chief holds.
    worker = json.loads(outs[1].strip().splitlines()[-2])
    assert worker["1"]["offset_ms"] == est["offset_ms"]


_TRAIN = r'''
import datetime, functools, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from autodist_tpu_torch import AutoDist, observability
from autodist_tpu_torch.observability import skew
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
rank, world = int(sys.argv[-2]), int(sys.argv[-1])
dist.init_process_group("gloo", rank=rank, world_size=world, timeout=
                        datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
rng = np.random.RandomState(rank)
batch = (torch.tensor(rng.randn(8, 8), dtype=torch.float32),
         torch.tensor(rng.randn(8, 4), dtype=torch.float32))


def loss_fn(p, b):
    return ((b[0] @ p["w"] - b[1]) ** 2).mean()


ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
runner = ad.create_distributed_session(ad.capture(
    loss_fn, {"w": torch.zeros(8, 4)},
    functools.partial(torch.optim.SGD, lr=0.1), example_batch=batch))


def batches():
    while True:
        yield batch


runner.run(runner.create_state(), batches(), 6)
print(json.dumps({"ring": [r["i"] for r in skew.ring()],
                  "summary": skew.last_summary()}, default=str))
dist.destroy_process_group()
'''


def test_two_rank_run_decomposes_both_rings_on_the_chief():
    outs, err = _run_world(_TRAIN, 2, [], ROOT)
    assert outs is not None, err
    chief, worker = (json.loads(o.strip().splitlines()[-1]) for o in outs)
    assert chief["ring"] == worker["ring"] == list(range(6))
    summ = chief["summary"]
    assert summ["windows"] == 6 and set(summ["hosts"]) == {"0", "1"}
    for row in summ["hosts"].values():
        assert row["wire_ms"] + row["skew_wait_ms"] == pytest.approx(
            row["exposed_comms_ms"], abs=1e-9)
        assert abs(row["offset_ms"]) <= row["uncertainty_ms"] + 1e-9
