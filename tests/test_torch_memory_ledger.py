"""The port's HBM memory ledger against the JAX package's.

* ``MemoryLedger.summary()`` and ``memory.finalize``'s ``mem.*`` gauges:
  the same predicted breakdown and the same synthetic samples through
  both packages give equal summaries and gauges (exact);
* ``suggest_fallback`` / ``oom_report``'s verdicts: equal on the same
  breakdowns, but for a staging-bound breakdown at ``unroll=1``, where the
  JAX package's fusion-bucket cap (a knob the port does not have) becomes
  the prefetch queue's depth;
* the port's predicted classes sum exactly to its peak (``unroll`` 1 and
  4); sharded state families undercut replication; ``unroll`` grows the
  staging class only;
* the measured side off the card is the bytes of the tensors the Runner
  holds (each storage once), reconciled within 20% of the predicted
  resident classes on the zoo LM under ``PS()`` (the JAX package's bound
  for its ``live_arrays`` walk on the CPU);
* OOM forensics: a chaos ``oom_at`` run writes ``oom_report.json`` and an
  ``oom`` flight event and still raises; ``is_oom`` matches
  ``torch.OutOfMemoryError`` and "CUDA out of memory".
"""
import functools
import itertools
import json

import numpy as np
import pytest
import torch

from autodist_tpu import const as jconst
from autodist_tpu import observability as jobs
from autodist_tpu.observability import memory as jmemory
from autodist_tpu.tuner import cost_model as jcm
from autodist_tpu_torch import AutoDist, const, observability
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.observability import memory
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import PS, AllReduce
from autodist_tpu_torch.tuner import cost_model as cm
from test_torch_attribution_goodput import SPEC_8_GPUS
from test_torch_models import _flops_pair


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("AUTODIST_HBM_GB", "AUTODIST_MEM_HEADROOM", "AUTODIST_CHAOS",
                 "AUTODIST_TELEMETRY", "AUTODIST_DUMP_GRAPHS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "cal.json"))
    for mod in (const, jconst):
        monkeypatch.setattr(mod, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
        monkeypatch.setattr(mod, "DEFAULT_TRACE_DIR", str(tmp_path / "traces"))
    autodist_mod._reset_default()
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    yield
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    autodist_mod._reset_default()


def _breakdown(mod, **kw):
    base = dict(params_bytes=4e8, optimizer_bytes=8e8, gradients_bytes=4e8,
                sync_state_bytes=1e6, activations_bytes=1.5e8,
                staging_bytes=3e8, kv_cache_bytes=0.0, unroll=4,
                data_axis=1, capacity_bytes=80.0 * (1 << 30))
    base.update(kw)
    return mod.MemoryBreakdown(**base)


SAMPLES = [
    {"bytes_in_use": 1.3e9, "peak_bytes_in_use": 1.9e9,
     "typical_bytes_in_use": 1.3e9, "source": "memory_stats", "n_live": None},
    {"bytes_in_use": 1.25e9, "peak_bytes_in_use": 2.2e9,
     "typical_bytes_in_use": 1.2e9, "source": "memory_stats", "n_live": None},
    {"bytes_in_use": 1.31e9, "peak_bytes_in_use": 2.2e9,
     "typical_bytes_in_use": 1.31e9, "source": "memory_stats", "n_live": 7},
]
LEDGERS = {
    "predicted+measured": (dict(), SAMPLES, 1),
    "guarded": (dict(), SAMPLES, 2),
    "predicted-only": (dict(), [], 1),
    "measured-only": (None, SAMPLES[:2], 1),
    "no-capacity": (dict(capacity_bytes=0.0), SAMPLES[1:], 1),
    "infeasible": (dict(params_bytes=9e10), SAMPLES, 1),
}


@pytest.mark.parametrize("case", sorted(LEDGERS))
def test_memory_ledger_summary_and_gauges_match_jax(case, monkeypatch):
    kw, samples, copies = LEDGERS[case]
    out = []
    for mem_mod, cost_mod, obs_mod in ((memory, cm, observability),
                                       (jmemory, jcm, jobs)):
        it = iter(samples)
        monkeypatch.setattr(mem_mod, "measured_sample",
                            lambda *a, **k: next(it, None))
        predicted = None if kw is None else _breakdown(cost_mod, **kw)
        led = mem_mod.MemoryLedger(predicted=predicted, unroll=4,
                                   resident_copies=copies)
        for tag in ("loop-start", "flush", "loop-end"):
            led.sample(tag)
        summary = mem_mod.finalize(led, obs_mod.registry())
        out.append((summary, obs_mod.registry().snapshot()["gauges"],
                    [e["kind"] for e in obs_mod.recorder.events()]))
    assert out[0] == out[1]
    summary = out[0][0]
    if kw is not None:
        assert sum(summary["predicted"].values()) == \
            summary["predicted_peak_bytes"]
    assert memory.CLASSES == jmemory.CLASSES
    assert memory.RESIDENT_CLASSES == jmemory.RESIDENT_CLASSES


@pytest.mark.parametrize("dominant,knobs", [
    ("staging_bytes", {}), ("gradients_bytes", {}),
    ("activations_bytes", {}), ("optimizer_bytes", {"unroll": 2})])
def test_suggest_fallback_matches_jax(dominant, knobs):
    kw = {dominant: 1e11}
    if dominant == "activations_bytes":
        kw["microbatches"] = 4
    assert memory.suggest_fallback(_breakdown(cm, **kw), knobs) == \
        jmemory.suggest_fallback(_breakdown(jcm, **kw), knobs)


@pytest.mark.parametrize("depth,knob,value", [
    (2, "prefetch_depth", 1), (3, "prefetch_depth", 1),
    (0, "batch_size", "halve the per-device batch")])
def test_staging_fallback_at_unroll_1_is_the_prefetch_queue(
        monkeypatch, depth, knob, value):
    monkeypatch.setenv("AUTODIST_PREFETCH_DEPTH", str(depth))
    got = memory.suggest_fallback(_breakdown(cm, staging_bytes=1e11,
                                             unroll=1))
    assert (got["knob"], got["value"]) == (knob, value)


def test_oom_report_matches_jax(tmp_path):
    exc = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
    got, path = memory.oom_report(exc, predicted=_breakdown(cm),
                                  context="step-loop step 3",
                                  knobs={"unroll": 4})
    assert json.load(open(path)) == got
    want, _ = jmemory.oom_report(exc, predicted=_breakdown(jcm),
                                 context="step-loop step 3",
                                 knobs={"unroll": 4})
    for key in ("error", "context", "predicted", "predicted_peak_gb",
                "dominant_class", "capacity_gb", "suggestion"):
        assert got[key] == want[key], key
    assert memory.last_oom_report() == got
    assert [e["kind"] for e in observability.recorder.events()] == ["oom"]


# -- the port's predicted breakdown -------------------------------------------

def _spec(tmp_path):
    path = tmp_path / "spec.yml"
    path.write_text(SPEC_8_GPUS)
    return ResourceSpec(str(path))


def _adam_item():
    _, item = _flops_pair("bert")
    item.optimizer_name = "adam"
    return item


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("builder", ["allreduce", "zero1", "stale"])
def test_predicted_classes_sum_exactly_to_peak(tmp_path, unroll, builder):
    item = _adam_item()
    strategy = {"allreduce": AllReduce(), "zero1": PS(),
                "stale": PS(staleness=2)}[builder].build(item,
                                                         _spec(tmp_path))
    mem = cm.CostModel(cm.Topology(8)).strategy_memory(strategy, item,
                                                       unroll=unroll)
    assert mem.peak_bytes == sum(mem.get(c, 0.0)
                                 for c in cm.MemoryBreakdown.CLASSES)
    assert mem.peak_bytes > 0 and mem["unroll"] == unroll
    assert mem.dominant_class() in cm.MemoryBreakdown.CLASSES


def test_sharded_state_families_undercut_replication(tmp_path):
    item = _adam_item()
    model = cm.CostModel(cm.Topology(8))
    zero1 = model.strategy_memory(PS().build(item, _spec(tmp_path)), item)
    stale = model.strategy_memory(PS(staleness=2).build(item,
                                                        _spec(tmp_path)),
                                  item)
    assert zero1["optimizer_bytes"] < stale["optimizer_bytes"]
    assert zero1["gradients_bytes"] < stale["gradients_bytes"]
    assert zero1.peak_bytes < stale.peak_bytes


def test_unroll_grows_staging_only(tmp_path):
    item = _adam_item()
    strategy = AllReduce().build(item, _spec(tmp_path))
    model = cm.CostModel(cm.Topology(8))
    m1 = model.strategy_memory(strategy, item, unroll=1)
    m8 = model.strategy_memory(strategy, item, unroll=8)
    assert m8["staging_bytes"] > m1["staging_bytes"]
    for cls in ("params_bytes", "optimizer_bytes", "gradients_bytes",
                "sync_state_bytes", "activations_bytes"):
        assert m8[cls] == m1[cls]


def test_capacity_resolution(monkeypatch):
    topo = cm.Topology(4, hbm_capacity_bytes=16 * (1 << 30))
    assert topo.hbm_capacity_bytes == 16 * (1 << 30)
    monkeypatch.setenv("AUTODIST_HBM_GB", "2.5")
    assert topo.hbm_capacity_bytes == 2.5 * (1 << 30)
    monkeypatch.delenv("AUTODIST_HBM_GB")
    # No card here: the CPU row of the capacity table, as in the JAX
    # package's CPU container.
    assert cm.Topology(4).hbm_capacity_bytes == 64.0 * (1 << 30)


# -- the measured side off the card -------------------------------------------

def test_measured_sample_counts_each_storage_once():
    a = torch.zeros(256, 256)
    held = [a, a, a[:10], a.view(-1), torch.ones(100, dtype=torch.float64),
            torch.empty(4, device="meta")]
    s1 = memory.measured_sample(held=lambda: held)
    s2 = memory.measured_sample(held=lambda: held)
    assert s1 == s2
    assert s1["source"] == "held_tensors"
    assert s1["bytes_in_use"] == 256 * 256 * 4 + 100 * 8
    assert memory.measured_sample() is None  # nothing held, no card
    top = memory.top_live_buffers(limit=2, held=lambda: held)
    assert top[0] == {"shape": [256, 256], "dtype": "torch.float32",
                      "nbytes": 256 * 256 * 4}
    assert len(top) == 2


def _lm_runner(builder, adam=True):
    cfg = lm.lm_tiny(max_len=32)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = lm.synthetic_batch(cfg, batch_size=8, seq_len=32)
    opt = (functools.partial(torch.optim.Adam, lr=1e-3) if adam else
           functools.partial(torch.optim.SGD, lr=0.1))
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(lm.make_loss_fn(cfg), params, opt, example_batch=batch)
    return ad.create_distributed_session(item), batch


@pytest.mark.parametrize("unroll", [1, 4])
def test_runner_ledger_reconciles_within_20pct(unroll):
    runner, batch = _lm_runner(PS())
    state = runner.create_state()
    runner.run(state, itertools.repeat(batch), 4, unroll=unroll)
    summ = memory.last_summary()
    assert summ["measured_source"] == "held_tensors"
    assert summ["samples"] >= 3
    assert summ["feasible"] is True
    assert abs(summ["prediction_error_pct"]) <= 20.0
    gauges = observability.registry().snapshot()["gauges"]
    for name in ("mem.params_gb", "mem.optimizer_gb", "mem.predicted_peak_gb",
                 "mem.measured_peak_gb", "mem.prediction_error_pct",
                 "mem.capacity_gb"):
        assert name in gauges
    assert observability.snapshot()["memory"]["dominant_class"] == \
        summ["dominant_class"]


def test_guarded_loop_counts_the_snapshot():
    from autodist_tpu_torch.resilience import StepGuard
    runner, batch = _lm_runner(AllReduce())
    runner.run(runner.create_state(), itertools.repeat(batch), 4,
               step_guard=StepGuard(check_every=2))
    summ = memory.last_summary()
    assert summ["resident_copies"] == 2
    assert abs(summ["prediction_error_pct"]) <= 20.0


def test_memory_json_sidecar_under_dump_graphs(monkeypatch, tmp_path):
    monkeypatch.setattr(const, "DEFAULT_GRAPH_DUMP_DIR",
                        str(tmp_path / "graphs"))
    monkeypatch.setenv("AUTODIST_DUMP_GRAPHS", "1")
    runner, batch = _lm_runner(AllReduce(), adam=False)
    runner.run(runner.create_state(), itertools.repeat(batch), 2)
    doc = json.load(open(tmp_path / "graphs" / "memory.json"))
    assert doc["predicted_peak_bytes"] > 0 and doc["samples"] >= 2


# -- OOM forensics ------------------------------------------------------------

@pytest.mark.parametrize("unroll", [1, 4])
def test_forced_oom_writes_report_and_event(tmp_path, monkeypatch, unroll):
    monkeypatch.setenv("AUTODIST_CHAOS", f"oom_at={unroll + 1}")
    from autodist_tpu_torch.resilience import chaos
    monkeypatch.setattr(chaos, "_fired", set())
    runner, batch = _lm_runner(AllReduce(), adam=False)
    with pytest.raises(RuntimeError, match="CUDA out of memory"):
        runner.run(runner.create_state(), itertools.repeat(batch), 8,
                   unroll=unroll)
    path = tmp_path / "logs" / "oom_report.json"
    with open(path) as f:
        report = json.load(f)
    assert "CUDA out of memory" in report["error"]
    assert report["context"] == f"step-loop step {unroll + 1}"
    assert report["dominant_class"] in cm.MemoryBreakdown.CLASSES
    assert report["suggestion"]["knob"] and report["predicted"]
    assert report["top_live_buffers"][0]["nbytes"] > 0
    assert memory.last_oom_report() == report
    kinds = [e["kind"] for e in observability.recorder.events()]
    assert "chaos:oom" in kinds and kinds[-1] == "oom"


def test_no_forensics_with_telemetry_off(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    monkeypatch.setenv("AUTODIST_CHAOS", "oom_at=2")
    from autodist_tpu_torch.resilience import chaos
    monkeypatch.setattr(chaos, "_fired", set())
    observability.refresh()
    runner, batch = _lm_runner(AllReduce(), adam=False)
    with pytest.raises(RuntimeError, match="CUDA out of memory"):
        runner.run(runner.create_state(), itertools.repeat(batch), 4)
    assert not (tmp_path / "logs" / "oom_report.json").exists()
    assert memory.last_oom_report() is None


@pytest.mark.parametrize("exc,want", [
    (torch.OutOfMemoryError("CUDA error"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 GiB"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: foo"), True),
    (ValueError("shape mismatch"), False),
    (RuntimeError("CUDA error: an illegal memory access"), False)])
def test_is_oom(exc, want):
    assert memory.is_oom(exc) is want
    if not isinstance(exc, torch.OutOfMemoryError):
        assert jmemory.is_oom(exc) is want
