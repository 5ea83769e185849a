"""The port's transform report and step text against the JAX package's.

``autodist_tpu_torch/report.py`` renders the JAX page from the port's
records; ``Runner._step_text`` stands where the JAX Runner's compiled HLO
stands. Every page these tests render goes to ``tmp_path``. Held here
(tolerance 0 throughout: this is text):

* the variable rows (less the storage column, a stated difference), the
  graph-config bits and the set of section headings (less their
  parentheticals) of both packages' pages, on ``tests/test_report.py``'s
  MLP under ``PS()`` and on BERT-tiny under ``AllReduce()``;
* the auto-render at a Runner's first eager step and at a graph capture,
  the per-strategy page, the ``report.html`` alias and the history footer
  (``tests/test_report.py:36-91``); no telemetry section with telemetry
  off;
* each dict-fed renderer gives the JAX package's fragment, byte for byte,
  on the same seeded input (the skew section's tool name aside);
* ``write_report`` / ``dump_compiled`` change no state (params, optimizer
  state, step, a graph step's static buffers, the guard's snapshot) and
  launch nothing, the step text is deterministic, and ``dump_compiled``'s
  failure contract under ``AUTODIST_DUMP_GRAPHS`` on and off;
* on two gloo ranks: the set of collective kinds of the step text equals
  the JAX one over the 8-device mesh's HLO for AllReduce, PS (zero1),
  PartitionedPS (fsdp), PS(local_proxy_variable=True) (zero1) and
  UnevenPartitionedPS (fsdp); the gradient sync's all-reduces number
  ``len(bucket_plan())``; ``replica_group_sizes`` reads the model and
  expert axes of TP and EP programs; ``einsum_result_lead_dims`` reads the
  JAX value, E/ep, on the MoE layer; the pipeline's and the ring's hops
  are ``collective-permute`` lines and Ulysses' ``all-to-all``; and a
  ``write_report`` on rank 0 alone returns while rank 1 waits at a
  barrier (no collective ran).
"""
import functools
import json
import os
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import const as jconst
from autodist_tpu import observability as jobs
from autodist_tpu import report as jreport
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.models import bert as jbert
from autodist_tpu.parallel import moe as jmoe
from autodist_tpu_torch import AutoDist, const, convert, observability, report
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import strategy
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.resilience import StepGuard
from autodist_tpu_torch.utils.tree import leaves
from test_torch_ps_strategies import ROOT, _run_world

ADAM = functools.partial(torch.optim.Adam, lr=1e-3)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_TRACE", "AUTODIST_DUMP_GRAPHS",
                 "AUTODIST_SKEW_RING", "AUTODIST_CLOCK_SYNC"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "c.json"))
    for mod in (const, jconst):
        for attr, sub in (("DEFAULT_WORKING_DIR", ""), ("DEFAULT_LOG_DIR",
                          "logs"), ("DEFAULT_TRACE_DIR", "traces"),
                          ("DEFAULT_GRAPH_DUMP_DIR", "graphs"),
                          ("DEFAULT_SERIALIZATION_DIR", "strategies")):
            monkeypatch.setattr(mod, attr, str(tmp_path / sub))
    from autodist_tpu import automap, retune, tuner
    from autodist_tpu import resilience as jres
    from autodist_tpu.retune import selfheal
    from autodist_tpu_torch import resilience
    for mod in (resilience, jres):  # another test's events would render
        monkeypatch.setattr(mod, "_events", [])
    # The JAX page's Tuner, Automap, Re-tuning and Self-heal sections read
    # process state another JAX test may leave; the port's page has none
    # of them (ROADMAP A12).
    for mod, fn in ((tuner, "last_result"), (automap, "last_result"),
                    (retune, "last_controller"), (selfheal, "healer")):
        monkeypatch.setattr(mod, fn, lambda: None)
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    autodist_mod._reset_default()
    _jreset()
    yield
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    autodist_mod._reset_default()
    _jreset()


# -- the fixtures of both packages --------------------------------------------

def _jmlp_loss(params, batch):
    x, y = batch
    h = jax.nn.relu(x @ params["w1"])
    return jnp.mean((h @ params["w2"] - y) ** 2)


def _mlp_loss(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    return ((h @ params["w2"] - y) ** 2).mean()


def _mlp():
    """``tests/test_report.py``'s MLP: (params on the host, batch)."""
    rng = np.random.RandomState(0)
    params = {"w1": np.zeros((16, 32), np.float32),
              "w2": np.zeros((32, 4), np.float32)}
    return params, (rng.randn(16, 16).astype(np.float32),
                    rng.randn(16, 4).astype(np.float32))


def _port_runner(model, builder, telemetry=None):
    if model == "mlp":
        params, batch = _mlp()
        loss, params = _mlp_loss, convert.params_from_jax(params, "cpu")
    else:
        cfg = bert.bert_tiny(max_len=16)
        params = bert.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        loss, batch = bert.make_loss_fn(cfg), bert.synthetic_batch(
            cfg, 8, 16, 3, seed=0)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    return ad.create_distributed_session(
        ad.capture(loss, params, ADAM, example_batch=batch)), batch


def _jax_runner(model, builder, spec):
    if model == "mlp":
        params, batch = _mlp()
        loss = _jmlp_loss
    else:
        jcfg = jbert.bert_tiny(max_len=16)
        params = jax.device_get(jbert.init(jax.random.PRNGKey(0), jcfg))
        loss, batch = jbert.make_loss_fn(jcfg), bert.synthetic_batch(
            bert.bert_tiny(max_len=16), 8, 16, 3, seed=0)
    ad = JAutoDist(resource_spec_file=spec, strategy_builder=builder)
    return ad.create_distributed_session(
        ad.capture(loss, params, optax.adam(1e-3), example_batch=batch)), batch


def _rows(page):
    """The variable rows, each cell but the last (the storage column)."""
    return [re.findall(r"<td>(.*?)</td>", row)[:-1] for row in
            re.findall(r"<tr><td><code>[^<]*</code></td><td>\(.*?</tr>",
                       page)]


def _headings(page):
    """The page's section headings, each less its parenthetical."""
    return {re.sub(r" \(.*\)$", "", h).replace("&middot;", "·")
            for h in re.findall(r"<h[23]>(.*?)</h[23]>", page)}


def _graph_config(page):
    return re.search(r"graph config: (.*?)</p>", page, re.S).group(1)


@pytest.mark.parametrize("model,builder", [("mlp", "PS"),
                                           ("bert", "AllReduce")])
def test_rows_config_and_headings_match_the_jax_page(model, builder,
                                                     tmp_path):
    spec = tmp_path / "spec.yml"
    spec.write_text("nodes:\n  - address: localhost\n    cpus: [0]\n"
                    "    chief: true\n")
    jrunner, batch = _jax_runner(model, getattr(jstrategy, builder)(),
                                 str(spec))
    jstate = jrunner.create_state()
    jstate, _ = jrunner.run(jstate, iter([batch] * 2), 2)
    jpath = jrunner.write_report(batch)
    jpage = open(jpath).read()
    runner, batch = _port_runner(model, getattr(strategy, builder)())
    state = runner.create_state()
    state, _ = runner.run(state, iter([batch] * 2), 2)
    page = open(runner.write_report(batch)).read()
    assert _rows(page) == _rows(jpage) and len(_rows(page)) == \
        len(runner.program.graph_item.variables)
    assert _graph_config(page) == _graph_config(jpage)
    assert _headings(page) == _headings(jpage)
    for h in ("1 · Capture", "2 · Strategy &amp; 3 · Shardings",
              "4 · Compiled step", "6 · Telemetry", "9 · Run goodput",
              "10 · Where the HBM goes", "Where the step goes"):
        assert h in _headings(page), h


def test_resilience_events_section_matches_the_jax_page(tmp_path,
                                                       monkeypatch):
    from autodist_tpu import resilience as jres
    from autodist_tpu_torch import resilience
    spec = tmp_path / "spec.yml"
    spec.write_text("nodes:\n  - address: localhost\n    cpus: [0]\n"
                    "    chief: true\n")
    pages = []
    for mod in (jres, resilience):
        mod.record_event("rollback", "nan at step 3 -> step 2")
        mod.record_event("retry", "write <ckpt> attempt 2/4")
    jrunner, _ = _jax_runner("mlp", jstrategy.PS(), str(spec))
    pages.append(open(jreport.render_report(
        jrunner.program, out_path=str(tmp_path / "j.html"))).read())
    runner, _ = _port_runner("mlp", strategy.PS())
    pages.append(open(report.render_report(
        runner.program, out_path=str(tmp_path / "p.html"))).read())
    sections = [page.split("<h2>5 · Resilience events</h2>")[1].split(
        "<h2>")[0] for page in pages]
    rows = [re.findall(r"<td><span class=badge>(.*?)</span></td>"
                       r"<td>(.*?)</td>", sec) for sec in sections]
    assert rows[0] == rows[1] == [
        ("rollback", "nan at step 3 -&gt; step 2"),
        ("retry", "write &lt;ckpt&gt; attempt 2/4")]


# -- the page, its alias and its history --------------------------------------

def test_report_auto_rendered_at_the_first_step_and_graph_capture():
    runner, batch = _port_runner("mlp", strategy.PS())
    alias = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR, "report.html")
    state = runner.create_state()
    assert not os.path.exists(alias)
    state, _ = runner.step(state, batch)
    page = open(alias).read()
    assert "<code>w1</code>" in page and "<code>w2</code>" in page
    assert "PS dest=" in page and "storage (this rank)" in page
    assert "gspmd path · eager" in page
    assert "Not captured this run" in page  # no step text without a call
    # An always-on report never starts the capture's trace.
    assert "captured op trace" not in page
    assert runner.program.graph_item._trace is None
    assert "6 &middot; Telemetry" in page
    os.remove(alias)
    state, _ = runner.step(state, batch)  # later steps render nothing
    assert not os.path.exists(alias)
    call = runner.make_callable(batch, shard_inputs=True, aot=True)
    state, _ = call(state, batch)  # the graph step's capture renders
    assert "gspmd path · CUDA graph" in open(alias).read()
    os.remove(alias)
    state, _ = call(state, batch)  # a replay renders nothing
    assert not os.path.exists(alias)


def test_report_written_per_strategy_with_stable_alias_and_history():
    runner, batch = _port_runner("mlp", strategy.PS())
    state = runner.create_state()
    runner.step(state, batch)
    sid = runner.program.strategy.id
    graphs = const.DEFAULT_GRAPH_DUMP_DIR
    per_id = os.path.join(graphs, f"report_{sid}.html")
    stable = os.path.join(graphs, "report.html")
    assert open(per_id).read() == open(stable).read()
    autodist_mod._reset_default()
    runner2, batch2 = _port_runner("mlp", strategy.PS())
    runner2.step(runner2.create_state(), batch2)
    sid2 = runner2.program.strategy.id
    assert sid2 != sid
    per_id2 = os.path.join(graphs, f"report_{sid2}.html")
    assert os.path.exists(per_id) and os.path.exists(per_id2)
    assert sid2 in open(stable).read()
    assert f"report_{sid}.html" in open(per_id2).read()
    # Atomic writes leave no temporary file behind.
    assert sorted(os.listdir(graphs)) == sorted(
        ["report.html", f"report_{sid}.html", f"report_{sid2}.html"])


def test_telemetry_off_page_has_no_telemetry_section(monkeypatch):
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    observability.refresh()
    runner, batch = _port_runner("mlp", strategy.AllReduce())
    state = runner.create_state()
    state, _ = runner.step(state, batch)
    # The loop writes nothing with telemetry off: no auto-render either.
    assert not os.path.exists(const.DEFAULT_GRAPH_DUMP_DIR) or \
        not os.listdir(const.DEFAULT_GRAPH_DUMP_DIR)
    page = open(runner.write_report(batch)).read()
    assert "Telemetry" not in page and "Compiled step" in page
    assert "Run goodput" not in page


def test_serving_program_renders():
    """``render_report`` takes a server's program, as the JAX tests call
    it on one (``tests/test_serve.py:330``)."""
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.serve.engine import ServeEngine
    cfg = bert.bert_tiny()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    example = (rng.randint(0, cfg.vocab, (4, 16)).astype(np.int32),
               rng.randint(0, 2, (4, 16)).astype(np.int32))
    engine = ServeEngine(lambda p, b: T.encode(p, cfg, b[0],
                                               segment_ids=b[1]),
                         params, example, (4,), device="cpu")
    out = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR, "serve.html")
    page = open(report.render_report(engine.program, out_path=out)).read()
    assert "2 · Strategy &amp; 3 · Shardings" in page
    assert len(_rows(page)) == len(engine.program.graph_item.variables)
    assert "storage (this rank)" in page and "<code>ar</code>" in page


# -- the dict-fed renderers, byte for byte ------------------------------------

def _agg():
    rng = np.random.RandomState(0)
    hosts = {}
    for h in range(3):
        parts = dict(zip(("data_wait_ms", "host_dispatch_ms",
                          "device_compute_ms", "exposed_comms_ms"),
                         map(float, rng.uniform(0.1, 5.0, 4))))
        wall = sum(parts.values()) + float(rng.uniform(-1, 1))
        hosts[h] = {"attribution": dict(parts, wall_ms=wall, residual_ms=(
            wall - sum(parts.values())), steps=int(rng.randint(1, 50)),
            unroll=int(rng.choice([1, 4])))}
    hosts[3] = {}
    return {"hosts": hosts}


def _profile():
    rng = np.random.RandomState(1)
    scopes = {f"layer{i}/{p}": {
        "compute_ms": float(rng.uniform(0, 3)),
        "comms_ms": float(rng.uniform(0, 1)),
        "predicted_compute_ms": float(rng.uniform(0, 3)),
        "predicted_comms_ms": float(rng.uniform(0, 1)),
        "wire_bytes": float(rng.randint(0, 1 << 24)),
        "ops": int(rng.randint(1, 40))} for i in range(12)
        for p in ("attn", "mlp")}
    return {"scopes": scopes, "coverage_pct": 93.25,
            "unattributed": {"compute_ms": 0.5, "comms_ms": 0.25},
            "sources": {"compute": "torch-profiler", "comms": "aten-flops"}}


def _skew():
    rng = np.random.RandomState(2)
    hosts = {}
    for h in range(2):
        windows = []
        for i in range(4):
            s = 1000.0 + i * 0.05 + float(rng.uniform(0, 0.01))
            windows.append({"i": i, "s": s, "e": s + 0.03, "k": 1,
                            "skew_wait_ms": float(rng.uniform(0, 2)) * h,
                            "wire_ms": float(rng.uniform(0, 1)),
                            "exposed_comms_ms": 2.5, "straggler": 1})
        hosts[h] = {"offset_ms": 0.5 * h, "uncertainty_ms": 0.05 * h,
                    "drift_ppm": None if h == 0 else 3.25,
                    "exposed_comms_ms": 2.5, "wire_ms": 0.5 + h,
                    "skew_wait_ms": 2.0 - h, "straggler_windows": 3 * h,
                    "windows": windows}
    return {"hosts": hosts, "windows": 4, "significant": True,
            "straggler": {"host": 1, "detail": "host 1 is the straggler in "
                          "3/4 windows; dominant term data_wait"}}


def _goodput():
    classes = {c: float(i) * 3.5 for i, c in enumerate(
        jobs.goodput.BADPUT_CLASSES)}
    return {"wall_ms": 2000.0, "goodput_ms": 1200.25, "goodput_pct": 60.0125,
            "classes": classes, "steps": 40, "mfu": 0.0931, "hfu": 0.1125}


def _memory():
    predicted = {c: float(i + 1) * (1 << 28)
                 for i, c in enumerate(jobs.memory.CLASSES)}
    return {"predicted": predicted,
            "predicted_peak_bytes": sum(predicted.values()),
            "predicted_peak_gb": sum(predicted.values()) / (1 << 30),
            "dominant_class": "kv_cache_bytes", "capacity_gb": 79.1,
            "headroom": 0.9, "feasible": True, "measured_peak_gb": 6.5,
            "measured_source": "allocator", "samples": 7,
            "prediction_error_pct": -3.25}


def _serving(o):
    reg = o.registry()
    reg.counter("serve.requests").inc(37)
    reg.counter("serve.batches").inc(9)
    reg.counter("serve.padded_rows").inc(5)
    reg.gauge("serve.queue_depth").set(2)
    for v in np.random.RandomState(3).uniform(1, 30, 37):
        reg.histogram("serve.latency_ms").observe(float(v))
    for i in range(2):
        reg.counter(f"serve.replica{i}.dispatches").inc(4 + i)
        reg.gauge(f"serve.replica{i}.outstanding").set(i)
        reg.gauge(f"serve.replica{i}.utilization").set(0.5 + i / 4)


def _pipeline_program(stages, micro):
    from autodist_tpu.proto import strategy_pb2
    proto = strategy_pb2.Strategy()
    proto.graph_config.pipeline_microbatches = micro
    return types.SimpleNamespace(
        strategy=types.SimpleNamespace(graph_config=proto.graph_config),
        mesh=types.SimpleNamespace(shape={"data": 1, "pipe": stages}))


def _cut():
    from autodist_tpu_torch.pipeline.cutter import StageCut
    rng = np.random.RandomState(4)
    stages = [{"scopes": [f"layer{i}" for i in range(j * 4, j * 4 + 7)],
               "flops": float(rng.uniform(1e9, 2e9)), "bytes": 0.0}
              for j in range(2)]
    return StageCut(stages, sum(s["flops"] for s in stages), 8, "layer",
                    source="explicit")


@pytest.mark.parametrize("section", ["attribution", "profile", "skew",
                                     "goodput", "memory", "serving",
                                     "pipeline", "pipeline_cut"])
def test_dict_fed_renderer_gives_the_jax_fragment(section, monkeypatch):
    from autodist_tpu.pipeline import cutter as jcutter
    from autodist_tpu_torch.pipeline import cutter
    cut = _cut() if section == "pipeline_cut" else None
    for mod in (cutter, jcutter):  # process state another test may set
        monkeypatch.setattr(mod, "_last_cut", cut)
    if section == "attribution":
        agg = _agg()
        got, want = (report._render_attribution(agg),
                     jreport._render_attribution(agg))
    elif section.startswith("pipeline"):
        prog = _pipeline_program(2, 3)
        got, want = (report._render_pipeline(prog),
                     jreport._render_pipeline(prog))
        assert ("stage-cut imbalance" in got) == (cut is not None)
    else:
        for mod, o in ((report, observability), (jreport, jobs)):
            if section == "profile":
                o.profile.set_last_profile(_profile())
            elif section == "skew":
                o.skew.set_last_summary(_skew())
            elif section == "goodput":
                o.goodput.set_last_summary(_goodput())
            elif section == "memory":
                o.memory.set_last_summary(_memory())
            else:
                _serving(o)
        fn = "_render_" + section
        got, want = getattr(report, fn)(), getattr(jreport, fn)()
        if section == "skew":  # each names its own package's tool
            want = want.replace("autodist_tpu.tools.timeline",
                                "autodist_tpu_torch.tools.timeline")
    assert got and got == want


# -- write_report / dump_compiled ----------------------------------------------

def _state_bytes(runner, state, graph=None, guard=None):
    out = [t.detach().clone() for t in leaves(state.params)]
    out += [v.clone() for _, t in runner._update_tensors(state)
            for v in state.opt_state.state.get(t, {}).values()]
    out.append(state.step.clone())
    if graph is not None:
        out += [t.clone() for t in graph._static]
    if guard is not None:
        out += [c.clone() for _, c in guard._snapshot.tensors]
    return out


def test_write_report_and_dump_compiled_change_no_state_and_launch_nothing():
    runner, batch = _port_runner("bert", strategy.AllReduce())
    guard = StepGuard(check_every=1)
    state = runner.create_state()
    state, _ = runner.run(state, iter([batch] * 2), 2, step_guard=guard)
    call = runner.make_callable(batch, shard_inputs=True, aot=True)
    state, _ = call(state, batch)
    graph = next(c.cell_contents for c in call.__closure__
                 if hasattr(c.cell_contents, "_static"))
    before = _state_bytes(runner, state, graph, guard)
    counts = [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                   fa.flash_bwd_dkv)]
    text = runner._step_text(batch)
    page = open(runner.write_report(batch)).read()
    path = runner.dump_compiled(batch)
    after = _state_bytes(runner, state, graph, guard)
    assert len(before) == len(after) and all(
        torch.equal(a, b) for a, b in zip(before, after))
    assert [f.launches for f in (fa.flash_fwd, fa.flash_bwd_dq,
                                 fa.flash_bwd_dkv)] == counts
    assert path == os.path.join(const.DEFAULT_GRAPH_DUMP_DIR,
                                "3-transformed-step.txt")
    assert open(path).read() == text == runner._step_text(batch)
    layers = bert.bert_tiny().num_layers
    for target in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert text.count(f'custom_call_target="{target}"') == layers
        assert f"<code>{target}</code> &times;{layers}" in page
    phases = set(re.findall(r", phase=([\w-]+), ", text))
    assert phases == {"forward", "backward", "grad-sync", "update",
                      "metrics"}
    assert "4 · Compiled step (op text)" in page
    assert "<tr><td>all-reduce</td><td>2</td></tr>" in page
    # Section 1 shows the capture's op trace once it was traced (the run's
    # memory ledger traced it).
    assert "captured op trace" in page


def test_dump_compiled_failure_contract(monkeypatch):
    runner, batch = _port_runner("mlp", strategy.AllReduce())
    runner.step(runner.create_state(), batch)
    bad = (batch[0][:, :5], batch[1])  # a batch the program cannot take
    msg = runner.dump_compiled(bad)
    assert isinstance(msg, str) and msg.startswith("step text dump failed:")
    monkeypatch.setenv("AUTODIST_DUMP_GRAPHS", "1")
    with pytest.raises(RuntimeError):
        runner.dump_compiled(bad)
    assert runner.dump_compiled(batch).endswith("3-transformed-step.txt")


def test_step_text_parsers_read_the_jax_forms():
    text = ('%3 = f32[4] all-reduce(%2), replica_groups=[2,4]<=[8], '
            'phase=grad-sync, op_name=""\n'
            '%5 = f32[2,6,16] aten.bmm.default(%4, %p.up), phase=forward, '
            'op_name="moe/ecd,edh->ech"\n'
            '%6 = f32[8] all-gather(%5), replica_groups=[4,2]<=[8], '
            'phase=forward, op_name="x"\n')
    for mod in (report, jreport):
        assert mod.collective_summary(text) == {"all-reduce": 1,
                                                "all-gather": 1}
        assert mod.replica_group_sizes(text) == {4, 2}
        assert mod.einsum_result_lead_dims(text, ("ecd,edh->ech",)) == [2]


# -- two gloo ranks -------------------------------------------------------------

BUILDERS = [("all_reduce", "AllReduce()"), ("zero1", "PS()"),
            ("fsdp", "PartitionedPS()"),
            ("zero1_proxy", "PS(local_proxy_variable=True)"),
            ("fsdp_uneven", "UnevenPartitionedPS()")]
E, EP_SIZE = 8, 2

_RANK = r'''
import datetime, functools, json, os, pickle, sys, time
workdir, rank, world = sys.argv[-3], int(sys.argv[-2]), int(sys.argv[-1])
os.environ["AUTODIST_WORKING_DIR"] = workdir
os.environ["AUTODIST_TELEMETRY"] = "1"
import numpy as np
import torch
import torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.parallel import moe
from autodist_tpu_torch.strategy import *  # noqa: F401,F403
from autodist_tpu_torch.utils.tree import leaves
dist.init_process_group("gloo", rank=rank, world_size=world, timeout=
                        datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
BUILDERS = json.loads(sys.argv[-4])
ADAM = functools.partial(torch.optim.Adam, lr=1e-3)
rng = np.random.RandomState(0)
mlp_params = {"w1": torch.zeros(16, 32), "w2": torch.zeros(32, 4)}
mlp_batch = (rng.randn(16, 16).astype(np.float32),
             rng.randn(16, 4).astype(np.float32))
mine = tuple(a[rank * 8:(rank + 1) * 8] for a in mlp_batch)


def mlp_loss(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    return ((h @ params["w2"] - y) ** 2).mean()


def session(builder, loss, params, batch):
    autodist_mod._reset_default(keep_world=True)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    return ad.create_distributed_session(
        ad.capture(loss, params, ADAM, example_batch=batch))


res = {}
for name, expr in BUILDERS:
    runner = session(eval(expr), mlp_loss, mlp_params, mine)
    state, _ = runner.step(runner.create_state(), mine)
    res[name] = {"text": runner._step_text(mine),
                 "buckets": len(runner.bucket_plan()),
                 "kinds": sorted({k for k, _ in runner.var_kinds.values()})}

# TP: BERT-tiny on {data: 1, model: 2}; every rank takes the same rows.
cfg = bert.bert_tiny(max_len=16)
tp_batch = bert.synthetic_batch(cfg, 4, 16, 3, seed=0)
runner = session(S.ModelParallel(S.AllReduce(), model_axis=2),
                 bert.make_loss_fn(cfg),
                 bert.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu"), tp_batch)
runner.step(runner.create_state(), tp_batch)
res["tp"] = {"text": runner._step_text(tp_batch),
             "mesh": dict(runner.program.mesh.shape)}

# EP: the MoE layer of tests/test_torch_moe.py on {data: 1, expert: 2}.
mcfg = moe.MoEConfig(num_experts=8, top_k=2, d_model=16, d_hidden=32)
g = torch.Generator().manual_seed(0)
moe_params = {"moe": moe.init(g, mcfg, device="cpu"),
              "head": {"kernel": torch.randn(16, 4, generator=g) * 0.1}}
moe_batch = (rng.randn(16, 16).astype(np.float32),
             rng.randint(0, 4, (16,)).astype(np.int32))


def moe_loss(p, batch):
    x, labels = batch
    h, aux = moe.apply(p["moe"], mcfg, x)
    logits = h @ p["head"]["kernel"]
    ce = -torch.log_softmax(logits, -1)[
        torch.arange(labels.shape[0]), labels.long()].mean()
    return ce + 0.01 * aux


runner = session(S.ModelParallel(S.AllReduce(), model_axis=2,
                                 rules=moe.EXPERT_RULES, mesh_axis="expert"),
                 moe_loss, moe_params, moe_batch)
runner.step(runner.create_state(), moe_batch)
res["ep"] = {"text": runner._step_text(moe_batch),
             "mesh": dict(runner.program.mesh.shape)}

# The hops: lm_tiny on {pipe: 2} and on {seq: 2} (ring, Ulysses).
from autodist_tpu_torch.models import lm
lm_batch = rng.randint(0, 256, (4, 65)).astype(np.int32)
for name, builder, stacked in (
        ("pp", S.Pipeline(num_stages=2, num_microbatches=2), True),
        ("sp_ring", S.SequenceParallel("ring", 2), False),
        ("sp_ulysses", S.SequenceParallel("ulysses", 2), False)):
    lcfg = lm.lm_tiny(max_len=64)
    lcfg.scan_layers = stacked
    runner = session(builder, lm.make_loss_fn(lcfg),
                     lm.init(lcfg, torch.Generator().manual_seed(0),
                             device="cpu"), lm_batch)
    runner.step(runner.create_state(), lm_batch)
    res[name] = {"text": runner._step_text(lm_batch),
                 "mesh": dict(runner.program.mesh.shape)}

# The chief alone writes the report while rank 1 waits at a barrier.
runner = session(S.AllReduce(), mlp_loss, mlp_params, mine)
state, _ = runner.step(runner.create_state(), mine)
if rank == 0:
    before = [t.detach().clone() for t in leaves(state.params)]
    before += [v.clone() for _, t in runner._update_tensors(state)
               for v in state.opt_state.state[t].values()]
    t0 = time.perf_counter()
    page = open(runner.write_report(mine)).read()
    res["dump"] = runner.dump_compiled(mine)
    res["chief_s"] = time.perf_counter() - t0
    after = [t.detach().clone() for t in leaves(state.params)]
    after += [v.clone() for _, t in runner._update_tensors(state)
              for v in state.opt_state.state[t].values()]
    res["unchanged"] = all(torch.equal(a, b) for a, b in zip(before, after))
    res["page_all_reduce"] = "<tr><td>all-reduce</td><td>" in page
t0 = time.perf_counter()
dist.barrier()
res["barrier_s"] = time.perf_counter() - t0
state, _ = runner.step(state, mine)  # the world still works
res["loss_after"] = float(_["loss"])
with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import pickle
    out = tmp_path_factory.mktemp("report_world")
    outs, err = _run_world(_RANK, 2, [json.dumps(BUILDERS), str(out)], ROOT)
    assert outs is not None, err
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _jax_mlp_text(expr):
    _jreset()
    params, batch = _mlp()
    ad = JAutoDist(strategy_builder=eval("jstrategy." + expr))
    runner = ad.create_distributed_session(
        ad.capture(_jmlp_loss, params, optax.adam(1e-3), example_batch=batch))
    state = runner.create_state()
    runner.step(state, batch)
    return runner._aot_executable(runner.remapper.shard_batch(batch)).as_text()


def _grad_sync_all_reduces(text):
    return len(re.findall(r"\ball-reduce\([^\n]*phase=grad-sync", text))


@pytest.mark.parametrize("name,expr", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_collective_kinds_match_the_jax_hlo(world, name, expr):
    want = set(jreport.collective_summary(_jax_mlp_text(expr)))
    for rank in world:
        res = rank[name]
        got = report.collective_summary(res["text"])
        assert set(got) == want, (got, want)
        assert _grad_sync_all_reduces(res["text"]) == res["buckets"]
        # The loss's mean is the one other all-reduce.
        assert got["all-reduce"] == res["buckets"] + 1
        assert res["kinds"] == sorted({name.split("_")[0]} if name !=
                                      "all_reduce" else {"ar"})
        assert report.replica_group_sizes(res["text"]) == {2}
    assert world[0][name]["text"] == world[1][name]["text"]


def test_replica_group_sizes_read_the_model_and_expert_axes(world):
    for key, axis in (("tp", "model"), ("ep", "expert")):
        for rank in world:
            assert rank[key]["mesh"] == {"data": 1, axis: 2}
            sizes = report.replica_group_sizes(rank[key]["text"])
            assert 2 in sizes and sizes <= {1, 2}
            model = [l for l in rank[key]["text"].splitlines()
                     if re.search(r"replica_groups=\[1,2\]", l) and
                     "phase=forward" in l]
            assert model, f"no forward collective spans the {axis} axis"


@pytest.mark.parametrize("name,axis,kind", [
    ("pp", "pipe", "collective-permute"),
    ("sp_ring", "seq", "collective-permute"),
    ("sp_ulysses", "seq", "all-to-all")])
def test_step_text_records_each_axis_hops(world, name, axis, kind):
    """The pipeline's and the ring's hops (an all-to-all with one peer)
    are ``collective-permute`` lines, Ulysses' exchanges ``all-to-all``,
    as in the JAX package's HLO; the flash kernels' calls are one line
    each, forward and backward, through the pipeline schedule's autograd
    ``Function`` and the ring's hops alike."""
    for rank in world:
        text = rank[name]["text"]
        assert rank[name]["mesh"] == {"data": 1, axis: 2}
        counts = report.collective_summary(text)
        assert counts.get(kind, 0) > 0, counts
        for target in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert f'custom_call_target="{target}"' in text
        assert report.replica_group_sizes(text) <= {1, 2}


def test_expert_products_lead_dims_equal_the_jax_value(world):
    _jreset()
    cfg = jmoe.MoEConfig(num_experts=E, top_k=2, d_model=16, d_hidden=32)
    k = jax.random.PRNGKey(1)
    params = {"moe": jmoe.init(k, cfg),
              "head": {"kernel": jax.random.normal(k, (16, 4)) * 0.1}}

    def loss(p, b):
        x, labels = b
        h, aux = jmoe.apply(p["moe"], cfg, x)
        logits = h @ p["head"]["kernel"]
        return -jnp.mean(jax.nn.log_softmax(logits)[
            jnp.arange(labels.shape[0]), labels]) + 0.01 * aux

    rng = np.random.RandomState(0)
    batch = (rng.randn(64, 16).astype(np.float32),
             rng.randint(0, 4, (64,)).astype(np.int32))
    ad = JAutoDist(strategy_builder=jstrategy.ModelParallel(
        jstrategy.AllReduce(), model_axis=EP_SIZE, rules=jmoe.EXPERT_RULES,
        mesh_axis="expert"))
    runner = ad.create_distributed_session(
        ad.capture(loss, params, optax.adam(1e-3), example_batch=batch))
    runner.step(runner.create_state(), batch)
    text = runner._aot_executable(runner.remapper.shard_batch(batch)).as_text()
    labels = ("ecd,edh->ech", "ech,ehd->ecd")
    want = set(jreport.einsum_result_lead_dims(text, labels))
    assert want == {E // EP_SIZE}
    for rank in world:
        assert set(report.einsum_result_lead_dims(rank["ep"]["text"],
                                                  labels)) == want


def test_chief_alone_writes_the_report_while_the_worker_waits(world):
    chief, worker = world
    assert chief["unchanged"] and chief["page_all_reduce"]
    assert chief["dump"].endswith("3-transformed-step.txt")
    # The worker sat at the barrier for the chief's whole report: no
    # collective of the step was entered, or the world would have hung
    # until WORLD_TIMEOUT_S.
    assert chief["chief_s"] < 60.0
    assert worker["barrier_s"] >= 0.5 * chief["chief_s"]
    assert np.isfinite(chief["loss_after"]) and \
        chief["loss_after"] == worker["loss_after"]
