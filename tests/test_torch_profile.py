"""The port's per-layer profile against the JAX package, and its
``torch.profiler`` source on the CPU.

* ``collapse`` / ``scope_of``: the same keys (exact);
* ``model_scope_costs`` of the tiny BERT under ``AllReduce`` on one
  8-GPU spec, priced on the same ``Topology`` figures: compute, comms and
  wire bytes per scope at ``COST_RTOL`` (only the FLOPs' summation order
  can differ);
* ``Profile.reconcile`` on the same measured / predicted rows and ledger
  summary: equal (exact);
* the measured source: under ``AUTODIST_TRACE=profiler`` an eager
  ``Runner.run`` of the tiny BERT on the CPU attributes the trace's aten
  ops' self time to named scopes. Every batched product (``aten::bmm``:
  only the plain attention's two einsums issue one), forward and
  backward (linked through the autograd sequence number), lands in
  ``layer{i}/attn``; attributed + unattributed time is the
  trace's total; the compute rows sum to the ledger's
  ``device_compute_ms``. The same trace without the backward linking
  leaves the backward ops unattributed;
* ``named_scope`` opens a ``record_function`` only in profiler mode; the
  knob and telemetry off make no profiling call (a spy).
"""
import functools
import json
import types

import numpy as np
import pytest
import torch

from autodist_tpu import observability as jobs
from autodist_tpu.observability import profile as jprofile
from autodist_tpu.tuner import cost_model as jcm
from autodist_tpu_torch import AutoDist, const, observability
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import strategy as S
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.observability import attribution, profile
from autodist_tpu_torch.observability import tracing
from autodist_tpu_torch.utils import scope as scope_mod
from test_torch_attribution_goodput import (COST_RTOL, _bert_items, _specs,
                                            _topologies)
from autodist_tpu import strategy as JS

UNATTRIBUTED = profile.UNATTRIBUTED


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_TRACE", "AUTODIST_PROFILE",
                 "AUTODIST_PROFILE_TOPK", "AUTODIST_DUMP_GRAPHS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_WORKING_DIR", str(tmp_path))
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "c.json"))
    for name in ("DEFAULT_LOG_DIR", "DEFAULT_TRACE_DIR",
                 "DEFAULT_GRAPH_DUMP_DIR"):
        monkeypatch.setattr(const, name, str(tmp_path / name.lower()))
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    yield
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    autodist_mod._reset_default()


@pytest.mark.parametrize("text", [
    "layer0/attn/bhqd,bhkd->bhqk", "layer0/attn/query/kernel", "embed",
    "stage0/block1/conv", "jit(f)/transpose(jvp(layer0))/attn/dot_general",
    "", "mlm_head/dense/bias", "nothing/known"])
def test_collapse_and_scope_of_match_jax(text):
    known = {"layer0/attn", "embed", "stage0/block1", "mlm_head"}
    assert profile.collapse(text) == jprofile.collapse(text)
    assert profile.scope_of(text, known) == jprofile.scope_of(text, known)


# -- the model side -------------------------------------------------------------

def _program(item, strategy, devices):
    mesh = types.SimpleNamespace(size=devices, devices=np.empty(devices))
    return types.SimpleNamespace(program=types.SimpleNamespace(
        graph_item=item, mesh=mesh, strategy=strategy))


def test_model_scope_costs_match_jax(tmp_path, monkeypatch):
    spec, jspec = _specs(tmp_path)
    jitem, item = _bert_items()
    topology, jtopology = _topologies(8, 1)
    monkeypatch.setattr(jcm, "Topology",
                        lambda n, num_hosts=1: jtopology)
    got, known = profile.model_scope_costs(
        _program(item, S.AllReduce(chunk_size=4).build(item, spec), 8),
        topology=topology)
    want, jknown = jprofile.model_scope_costs(
        _program(jitem, JS.AllReduce(chunk_size=4).build(jitem, jspec), 8))
    assert known == jknown and sorted(got) == sorted(want)
    assert {"layer0/attn", "layer1/mlp", "embed", "mlm_head"} <= known
    for scope, w in want.items():
        for k in ("compute_ms", "comms_ms", "wire_bytes"):
            assert got[scope][k] == pytest.approx(w[k], rel=COST_RTOL,
                                                  abs=1e-15), (scope, k)


def _rows(seed):
    rng = np.random.RandomState(seed)
    out = {}
    for s in ("layer0/attn", "layer0/mlp", "embed", UNATTRIBUTED):
        out[s] = {"compute_ms": float(rng.uniform(0, 2)),
                  "comms_ms": float(rng.uniform(0, 0.5)),
                  "wire_bytes": float(rng.randint(0, 1 << 20)),
                  "ops": int(rng.randint(1, 40))}
    return out


@pytest.mark.parametrize("case", ["ledger", "no-ledger", "zero-measured"])
def test_reconcile_matches_jax(case):
    measured, predicted = _rows(0), _rows(1)
    attr = {"device_compute_ms": 3.25, "exposed_comms_ms": 0.75, "steps": 8}
    if case == "no-ledger":
        attr = None
    if case == "zero-measured":
        for r in measured.values():
            r["comms_ms"] = 0.0
    sources = {"compute": "aten-flops", "comms": "strategy-model"}
    got = profile.Profile(measured, predicted, sources, unroll=4) \
        .reconcile(attr)
    want = jprofile.Profile(measured, predicted, sources, unroll=4) \
        .reconcile(attr)
    assert got == want
    if case == "ledger":
        total = sum(r["compute_ms"] for r in got["scopes"].values()) + \
            got["unattributed"]["compute_ms"]
        assert total == pytest.approx(3.25, rel=1e-6)


# -- the torch.profiler source ---------------------------------------------------

def _bert_runner(layers=2):
    autodist_mod._reset_default()
    cfg = bert.bert_tiny(max_len=16)
    cfg.num_layers = layers
    batch = bert.synthetic_batch(cfg, 4, 16, 3, seed=0)
    ad = AutoDist(strategy_builder=S.AllReduce(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(cfg),
        bert.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
        functools.partial(torch.optim.Adam, lr=1e-3), example_batch=batch))
    return cfg, runner, batch


def _repeat(batch):
    while True:
        yield batch


STEPS = 2


@pytest.fixture
def profiled(monkeypatch):
    monkeypatch.setenv("AUTODIST_TRACE", "profiler")
    observability.refresh()
    cfg, runner, batch = _bert_runner()
    runner.run(runner.create_state(), _repeat(batch), STEPS)
    path = f"{const.DEFAULT_TRACE_DIR}/trace-rank0.json"
    return cfg, runner, profile.last_profile(), json.load(open(path))


BMM = "aten::bmm"   # the attention's q.k and p.v, and their gradients


def test_profiler_run_attributes_the_attention_backward_included(profiled):
    cfg, runner, summ, trace = profiled
    assert summ["sources"]["compute"] == "torch-profiler"
    info = summ["trace"]
    assert info["mode"] == "cpu-ops" and info["steps"] == STEPS
    attn = {f"layer{i}/attn" for i in range(cfg.num_layers)}
    per = info["by_kernel"][BMM]
    assert set(per) == attn, per
    # The forward products and a gradient product at least for each.
    assert sum(per.values()) >= 4 * cfg.num_layers * STEPS
    # Every unit lands in exactly one row.
    assert info["kernel_ms"] == pytest.approx(
        info["attributed_ms"] + info["unattributed_ms"], rel=1e-12)
    total = sum(r["compute_ms"] for r in summ["scopes"].values()) + \
        summ["unattributed"]["compute_ms"]
    attr = attribution.last_summary()
    # Each row is rounded to 1e-6 ms (the JAX package's reconcile).
    assert total == pytest.approx(attr["device_compute_ms"], rel=1e-6,
                                  abs=5e-7 * (len(summ["scopes"]) + 1))
    assert attn <= set(summ["scopes"])
    assert info["unlinked"] == 0 and info["attributed_ms"] > 0
    gauges = observability.registry().snapshot()["gauges"]
    assert gauges["profile.scopes"] == len(summ["scopes"])


def test_unlinked_attribution_leaves_the_backward_unattributed(profiled):
    cfg, runner, summ, trace = profiled
    linked = summ["trace"]["by_kernel"][BMM]
    known = profile.model_scope_costs(runner)[1]
    _, info = profile.trace_scope_costs(trace, known, steps=STEPS,
                                        link_backward=False)
    per = info["by_kernel"][BMM]
    n = cfg.num_layers * STEPS
    # The forward products keep their scope; the gradients' go nowhere.
    assert set(per) == set(linked) | {UNATTRIBUTED}
    assert sum(per.values()) == sum(linked.values())
    assert per[UNATTRIBUTED] >= 2 * n
    assert all(0 < per[s] < linked[s] for s in linked)
    assert info["unlinked"] >= per[UNATTRIBUTED]


def test_without_a_trace_the_model_source_stays(monkeypatch):
    cfg, runner, batch = _bert_runner()
    runner.run(runner.create_state(), _repeat(batch), 2)
    summ = profile.last_profile()
    assert summ["sources"] == {"compute": "aten-flops",
                               "comms": "strategy-model"}
    assert "trace" not in summ and summ["reconciled"]
    prof = profile.profile_runner(runner, trace={"traceEvents": []})
    assert prof.sources["compute"] == "aten-flops"
    assert prof.sources["trace"] == "no device time in the trace"


def _kernel_trace():
    """A synthetic CUDA trace: a forward kernel launched inside a scope,
    its backward on autograd's thread, a graph replay's kernel, a
    collective and an orphan."""
    def x(cat, name, ts, dur, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "tid": tid, "args": args}
    return {"traceEvents": [
        x("user_annotation", "scope:layer0/attn", 0, 100, 1),
        x("cpu_op", "FlashAttn", 10, 50, 1, **{"Sequence number": 7,
                                               "Fwd thread id": 0}),
        x("cuda_runtime", "cudaLaunchKernel", 20, 2, 1, correlation=1),
        x("kernel", "flash_fwd_wgmma_kernel", 30, 40, 7, correlation=1),
        x("cpu_op", "autograd::engine::evaluate_function: FlashAttnBackward",
          200, 50, 2, **{"Sequence number": 7, "Fwd thread id": 1}),
        x("cuda_runtime", "cudaLaunchKernel", 210, 2, 2, correlation=2),
        x("kernel", "flash_bwd_dq_wgmma_kernel", 220, 60, 7, correlation=2),
        x("cuda_runtime", "cudaGraphLaunch", 400, 2, 1, correlation=3),
        x("kernel", "ampere_gemm", 410, 30, 7, correlation=3),
        x("kernel", "ncclDevKernel_AllReduce", 450, 20, 7, correlation=4),
        x("kernel", "orphan", 480, 10, 7, correlation=99),
    ]}


@pytest.mark.parametrize("link", [True, False])
def test_trace_scope_costs_on_kernels(link):
    scopes, info = profile.trace_scope_costs(
        _kernel_trace(), {"layer0/attn"}, steps=2, link_backward=link)
    assert info["mode"] == "kernels"
    assert info["graph_replay_kernels"] == 1 and info["comms_kernels"] == 1
    assert info["graph_replay_ms"] == pytest.approx(0.015)
    assert info["no_launch"] == 1
    bwd = info["by_kernel"]["flash_bwd_dq_wgmma_kernel"]
    if link:
        assert scopes["layer0/attn"]["compute_ms"] == pytest.approx(0.05)
        assert bwd == {"layer0/attn": 1}
    else:
        assert scopes["layer0/attn"]["compute_ms"] == pytest.approx(0.02)
        assert bwd == {UNATTRIBUTED: 1} and info["unlinked"] == 1
    assert info["kernel_ms"] == pytest.approx(0.055)


def test_named_scope_opens_record_function_only_under_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with scope_mod.named_scope("layer0"), scope_mod.named_scope("attn"):
        assert scope_mod.current_scope() == "layer0/attn"
    assert opened == []
    monkeypatch.setenv("AUTODIST_TRACE", "profiler")
    tracing.refresh()
    with scope_mod.named_scope("layer0"), scope_mod.named_scope("attn"):
        pass
    assert opened == ["scope:layer0", "scope:layer0/attn"]
    assert scope_mod.current_scope() == ""


@pytest.mark.parametrize("knob", ["AUTODIST_PROFILE", "AUTODIST_TELEMETRY"])
def test_profile_off_makes_no_profiling_call(monkeypatch, knob):
    monkeypatch.setenv(knob, "0")
    observability.refresh()
    calls = []
    for name in ("profile_runner", "finalize", "model_scope_costs",
                 "trace_scope_costs"):
        monkeypatch.setattr(profile, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    cfg, runner, batch = _bert_runner(layers=1)
    runner.run(runner.create_state(), _repeat(batch), 2)
    assert calls == [] and profile.last_profile() is None


def test_sidecar_under_dump_graphs_and_monitor_rows(monkeypatch):
    monkeypatch.setenv("AUTODIST_DUMP_GRAPHS", "1")
    monkeypatch.setenv("AUTODIST_PROFILE_TOPK", "3")
    cfg, runner, batch = _bert_runner(layers=1)
    runner.run(runner.create_state(), _repeat(batch), 2)
    summ = profile.last_profile()
    doc = json.load(open(f"{const.DEFAULT_GRAPH_DUMP_DIR}/profile.json"))
    assert doc["top"] == summ["top"] and len(summ["top"]) == 3
    rows = profile.last_summary_rows()
    assert [s for s, _ in rows] == summ["top"]
    kinds = [e["kind"] for e in observability.recorder.events()]
    assert "profile" in kinds
