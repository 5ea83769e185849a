"""The port's attribution and goodput ledgers, its calibration and the
priced part of its cost model, against the JAX package.

* ``Ledger.summary()``: the same synthetic observations through both
  packages' ledgers give equal summaries (exact: the same float
  arithmetic and rounding);
* ``goodput.collect``: the same spans, metrics and clock through both
  packages give equal segments (``pid`` aside);
* ``Calibration``: the same observations give the same scales; the step
  loops keep one file per card, program and unroll, and concurrent
  processes' locked updates all land;
* ``CostModel.strategy_cost`` of the same strategies (each package's
  builders, one spec of 8 GPUs) on one ``Topology`` (the same links and
  seeds on both sides) agree at ``COST_RTOL`` on BERT's tiny fixture,
  where the FLOPs agree; under ``Pipeline(2, 4)`` on the stacked LM the
  port counts the ``blocks`` scope's FLOPs L times (a ``lax.scan`` body
  traces once in JAX), so there the compute terms are held to L x the
  JAX ones' blocks share instead, and the stage cut's imbalance to JAX's;
* the Runner's ledgers end to end on a one-rank gloo world: components
  sum to ``wall_ms`` at ``unroll`` 1 and 4, goodput classes to the wall.
"""
import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from autodist_tpu import const as jconst
from autodist_tpu import observability as jobs
from autodist_tpu.observability import attribution as jattribution
from autodist_tpu.observability import goodput as jgoodput
from autodist_tpu.resource_spec import Connectivity as JConn
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu import strategy as JS
from autodist_tpu.tuner import calibration as jcalibration
from autodist_tpu.tuner import cost_model as jcm
from autodist_tpu_torch import AutoDist, const, observability
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import strategy as S
from autodist_tpu_torch.observability import attribution, goodput, tracing
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.tuner import calibration
from autodist_tpu_torch.tuner import cost_model as cm
from test_torch_models import _flops_pair
from test_torch_scope_costs import _pair

BATCH = 16
# strategy_cost / strategy_memory against the JAX package: the same
# formulas over the same counts, so only the FLOPs' summation order can
# differ (the scope costs agree at 1e-9).
COST_RTOL = 1e-9
SPEC_8_GPUS = """
nodes:
  - address: 10.0.0.1
    gpus: [0, 1, 2, 3, 4, 5, 6, 7]
    chief: true
"""


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Telemetry on, buffers empty, and every file the ledgers write (the
    calibration, goodput segments, flight files, traces) under tmp_path,
    in both packages."""
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_TRACE", "AUTODIST_RUN_ID",
                 "AUTODIST_RUN_GENERATION", "AUTODIST_PEAK_TFLOPS",
                 "AUTODIST_HBM_GB", "AUTODIST_CHAOS", "AUTODIST_DUMP_GRAPHS"):
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


def _loss_fn(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    return ((h @ params["w2"] - y) ** 2).mean()


def _build(builder=None, hidden=16):
    rng = np.random.RandomState(0)
    params = {"w1": torch.zeros(8, hidden), "w2": torch.zeros(hidden, 4)}
    batch = (torch.tensor(rng.randn(BATCH, 8), dtype=torch.float32),
             torch.tensor(rng.randn(BATCH, 4), dtype=torch.float32))
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder or AllReduce(), device="cpu")
    item = ad.capture(_loss_fn, params,
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _repeat(batch):
    while True:
        yield batch


# -- attribution: the ledger against the JAX package's ------------------------

OBSERVATIONS = {
    "unroll1": (1, [(10.0, 1.0, 1), (12.0, 2.0, 1), (11.0, 0.5, 1)]),
    "unroll4": (4, [(40.0, 4.0, 4), (44.0, 2.0, 4), (38.5, 0.25, 4)]),
    "ragged": (4, [(40.0, 4.0, 4), (9.0, 0.0, 1), (11.5, 1.0, 1)]),
    "overpriced": (1, [(1.0, 0.0, 1), (2.0, 0.1, 1)]),
}
TERMS = {"host_dispatch_ms": 0.8, "device_compute_ms": 3.25,
         "exposed_comms_ms": 0.75, "raw_compute_ms": 3.0,
         "raw_comms_ms": 0.5,
         "sources": {"host_dispatch": "seed",
                     "device_compute": "cost-model-roofline"}}


@pytest.mark.parametrize("case", sorted(OBSERVATIONS))
def test_ledger_summary_matches_jax(case):
    unroll, obs = OBSERVATIONS[case]
    got = attribution.Ledger(attribution.ModelTerms(**TERMS), unroll=unroll)
    want = jattribution.Ledger(jattribution.ModelTerms(**TERMS),
                               unroll=unroll)
    for wall, wait, steps in obs:
        got.observe(wall, wait, steps)
        want.observe(wall, wait, steps)
    s = got.summary()
    assert s == want.summary()
    assert sum(s[c] for c in attribution.COMPONENTS) == pytest.approx(
        s["wall_ms"], abs=1e-4)
    assert attribution.COMPONENTS == jattribution.COMPONENTS


def test_empty_ledger_summary_is_empty():
    assert attribution.Ledger(attribution.ModelTerms()).summary() == {}


def test_attribution_finalize_gauges_and_calibration_match_jax(tmp_path,
                                                               monkeypatch):
    """finalize: the ``attr.*`` gauges, the stashed summary and the
    per-term calibration each package's feed writes."""
    out = {}
    for name, attr_mod, obs_mod in (("port", attribution, observability),
                                    ("jax", jattribution, jobs)):
        monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION",
                           str(tmp_path / f"cal_{name}.json"))
        led = attr_mod.Ledger(attr_mod.ModelTerms(**TERMS), unroll=4)
        for wall, wait, steps in OBSERVATIONS["unroll4"][1]:
            led.observe(wall, wait, steps)
        summary = attr_mod.finalize(led, obs_mod.registry())
        cal = json.load(open(tmp_path / f"cal_{name}.json"))
        out[name] = (summary, obs_mod.registry().snapshot()["gauges"],
                     cal["term_scales"], cal["scale"],
                     [e["kind"] for e in obs_mod.recorder.events()])
    assert out["port"] == out["jax"]
    assert out["port"][4] == ["attribution"]


# -- calibration --------------------------------------------------------------

def test_calibration_matches_jax(tmp_path):
    """The same observations give the same scales, samples (less their
    timestamps) and MFU anchor; and the file reloads in both."""
    ops = [("observe", 10.0, 12.0), ("observe_term", "compute", 3.0, 9.0),
           ("observe_term", "comms", 1.0, 0.5), ("observe", 8.0, 4.0),
           ("note_mfu", 0.093), ("observe_term", "compute", 3.0, 300.0)]
    cals = [calibration.Calibration(path=str(tmp_path / "p.json")),
            jcalibration.Calibration(path=str(tmp_path / "j.json"))]
    for cal in cals:
        for op in ops:
            getattr(cal, op[0])(*op[1:])
    got, want = cals
    assert got.scale == want.scale
    assert got.term_scales == want.term_scales
    assert got.compute_scale == want.compute_scale
    assert got.comms_scale == want.comms_scale
    assert got.last_mfu == want.last_mfu
    strip = [{k: v for k, v in s.items() if k != "t"} for s in got.samples]
    assert strip == [{k: v for k, v in s.items() if k != "t"}
                     for s in want.samples]
    # Each package's file, read back by the port (rounded to 6 places).
    back = calibration.Calibration.load(str(tmp_path / "p.json"))
    jback = calibration.Calibration.load(str(tmp_path / "j.json"))
    assert back.term_scales == jback.term_scales
    assert back.scale == jback.scale and back.last_mfu == jback.last_mfu
    assert back.prediction_error_pct() == want.prediction_error_pct()


def test_calibration_link_overrides_and_host_dispatch(tmp_path):
    cal = calibration.Calibration(host_dispatch_ms=0.42,
                                  link_overrides={"ici": {"bandwidth": 1e9,
                                                          "latency": 2e-6}},
                                  path=str(tmp_path / "c.json"))
    cal.save()
    back = calibration.Calibration.load(str(tmp_path / "c.json"))
    assert back.host_dispatch_ms == pytest.approx(0.42)
    links = back.apply_link_overrides(cm.DEFAULT_LINKS)
    assert links[cm.Connectivity.ICI] == (1e9, 2e-6)
    assert links[cm.Connectivity.DCN] == cm.DEFAULT_LINKS[cm.Connectivity.DCN]


def _keyed_store(monkeypatch, tmp_path):
    """No AUTODIST_TUNER_CALIBRATION: the step loops' per-program files
    under tmp_path's working dir."""
    monkeypatch.delenv("AUTODIST_TUNER_CALIBRATION")
    monkeypatch.setattr(const, "DEFAULT_WORKING_DIR", str(tmp_path / "wd"))
    return tmp_path / "wd" / "tuner_calibration"


def test_calibration_file_per_card_program_and_unroll(tmp_path, monkeypatch):
    store = _keyed_store(monkeypatch, tmp_path)
    a, _ = _build()
    paths = {calibration.path_for(a, 1), calibration.path_for(a, 4),
             calibration.path_for(_build(hidden=32)[0], 1),
             calibration.path_for(_build(AllReduce(chunk_size=1))[0], 1)}
    assert len(paths) == 4
    assert {os.path.dirname(p) for p in paths} == {str(store)}
    assert os.path.basename(calibration.path_for(a, 4)).startswith(
        "cpu-n1-u4-")
    # The same program built again keys the same file.
    assert calibration.path_for(_build()[0], 1) == \
        calibration.path_for(a, 1)
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "x.json"))
    assert calibration.path_for(a, 4) == str(tmp_path / "x.json")


def test_one_programs_runs_leave_anothers_scales_alone(tmp_path, monkeypatch):
    _keyed_store(monkeypatch, tmp_path)
    small, batch = _build()
    small.run(small.create_state(), _repeat(batch), 4)
    path = calibration.path_for(small, 1)
    with open(path) as f:
        before = f.read()
    # (On the CPU the roofline rounds to 0 ms, so the memory ledger's
    # term is the one fed.)
    assert [x["context"] for x in json.loads(before)["samples"]] == \
        ["memory"]
    wide, batch = _build(hidden=64)
    wide.run(wide.create_state(), _repeat(batch), 4)
    with open(path) as f:
        assert f.read() == before
    assert calibration.Calibration.load(
        calibration.path_for(wide, 1)).samples


_LOCKED_WORKER = """
import sys
from autodist_tpu_torch.tuner.calibration import Calibration
for i in range(int(sys.argv[2])):
    with Calibration.locked(sys.argv[1]) as cal:
        cal.observe_term("compute", 1.0, 2.0, context=sys.argv[3])
"""


def test_locked_updates_from_concurrent_processes_all_land(tmp_path):
    import subprocess
    import sys
    path, n, procs = str(tmp_path / "cal.json"), 10, 4
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    workers = [subprocess.Popen([sys.executable, "-c", _LOCKED_WORKER, path,
                                 str(n), f"p{i}"], cwd=root)
               for i in range(procs)]
    assert [w.wait(timeout=120) for w in workers] == [0] * procs
    samples = calibration.Calibration.load(path).samples
    assert len(samples) == n * procs
    assert sorted({x["context"] for x in samples}) == [
        f"p{i}" for i in range(procs)]


@pytest.mark.parametrize("chunk_size", [1, 128])
def test_strategy_cost_prices_one_bucket_per_runner_bucket(chunk_size):
    runner, _ = _build(AllReduce(chunk_size=chunk_size))
    prog = runner.program
    bd = cm.CostModel(cm.Topology(8)).strategy_cost(prog.strategy,
                                                    prog.graph_item)
    assert bd["n_buckets"] == len(runner.bucket_plan()) == \
        (2 if chunk_size == 1 else 1)


def test_terms_for_runner_sources_and_host_dispatch(tmp_path, monkeypatch):
    calibration.Calibration(host_dispatch_ms=0.42).save()
    runner, _ = _build()
    terms = attribution.terms_for_runner(runner, unroll=2)
    assert terms.host_dispatch_ms == pytest.approx(0.42)
    assert terms.sources["host_dispatch"] == "bench-calibrated"
    assert terms.sources["device_compute"] == "cost-model-roofline"
    assert terms.sources["exposed_comms"] == "cost-model"
    assert "scheduled_hlo" not in terms.sources
    # A measured exposed-comms gauge (a profiled loop's) takes its place.
    observability.registry().gauge("comms.exposed_ms_per_step").set(0.125)
    measured = attribution.terms_for_runner(runner, unroll=2)
    assert measured.sources["exposed_comms"] == "torch-profiler"
    assert measured.exposed_comms_ms == pytest.approx(0.125)
    assert terms.raw_compute_ms > 0


# -- the cost model against the JAX package's ---------------------------------

LINKS = {"ICI": (450e9, 5e-6), "LOCAL": (64e9, 5e-6), "DCN": (50e9, 1e-5)}
TOPOLOGIES = {"1host": (8, 1), "2hosts": (8, 2)}


def _topologies(devices, hosts):
    seeds = dict(device_flops=989e12, hbm_bytes_per_s=3.35e12,
                 hbm_capacity_bytes=80 * (1 << 30))
    return (cm.Topology(devices, hosts, links={
        getattr(cm.Connectivity, k): v for k, v in LINKS.items()}, **seeds),
        jcm.Topology(devices, hosts, links={
            getattr(JConn, k): v for k, v in LINKS.items()}, **seeds))


def _specs(tmp_path):
    path = tmp_path / "spec.yml"
    path.write_text(SPEC_8_GPUS)
    return ResourceSpec(str(path)), JResourceSpec(str(path))


BUILDERS = {
    "allreduce": (lambda m: m.AllReduce(chunk_size=4)),
    "zero1": (lambda m: m.PS()),
    "fsdp": (lambda m: m.PartitionedPS()),
    "parallax": (lambda m: m.Parallax()),
    "stale": (lambda m: m.PS(staleness=2)),
}


def _bert_items():
    jitem, item = _flops_pair("bert")
    for it in (jitem, item):  # Adam's two moments in the optimizer class
        it.optimizer_name = "adam"
    return jitem, item


def _close(got, want, skip=()):
    assert set(want) - set(skip) <= set(got)
    for k, v in want.items():
        if k in skip:
            continue
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=COST_RTOL, abs=1e-30), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("unroll", [1, 4])
def test_strategy_cost_matches_jax(tmp_path, builder, topo, unroll):
    """The JAX package's defaults (no overlap schedule, one bucket per
    fusion group) are the only schedule the port prices: the breakdown's
    ``overlap`` / ``bucket_mb`` badges of the JAX knobs are not in it."""
    spec, jspec = _specs(tmp_path)
    jitem, item = _bert_items()
    strategy = BUILDERS[builder](S).build(item, spec)
    jstrategy = BUILDERS[builder](JS).build(jitem, jspec)
    topology, jtopology = _topologies(*TOPOLOGIES[topo])
    got = cm.CostModel(topology).strategy_cost(strategy, item, unroll=unroll)
    want = jcm.CostModel(jtopology).strategy_cost(jstrategy, jitem,
                                                  unroll=unroll)
    assert (want["overlap"], want["bucket_mb"]) == (False, 0)
    _close(got, want, skip=("overlap", "bucket_mb"))
    assert got.total_ms == pytest.approx(want.total_ms, rel=COST_RTOL)


@pytest.mark.parametrize("builder", sorted(BUILDERS))
@pytest.mark.parametrize("unroll", [1, 4])
def test_strategy_memory_matches_jax(tmp_path, builder, unroll):
    """Every class at COST_RTOL but the activations, which are the port's
    own ``activation_live_bytes`` (aten outputs, not jaxpr equations) at
    the same per-device scaling."""
    spec, jspec = _specs(tmp_path)
    jitem, item = _bert_items()
    strategy = BUILDERS[builder](S).build(item, spec)
    jstrategy = BUILDERS[builder](JS).build(jitem, jspec)
    topology, jtopology = _topologies(8, 2)
    got = cm.CostModel(topology).strategy_memory(strategy, item,
                                                 unroll=unroll)
    want = jcm.CostModel(jtopology).strategy_memory(jstrategy, jitem,
                                                    unroll=unroll)
    _close(got, want, skip=("activations_bytes",))
    assert got["activations_bytes"] == pytest.approx(
        item.activation_live_bytes() / got["data_axis"], rel=COST_RTOL)
    assert got.peak_bytes == sum(got[c] for c in cm.MemoryBreakdown.CLASSES)
    assert got.dominant_class() in cm.MemoryBreakdown.CLASSES


def test_pipeline_cost_and_memory_match_jax(tmp_path):
    """``Pipeline(2, 4)`` on the stacked LM: the stage cut's imbalance, the
    bubble's shape and every sync / update / memory term as the JAX
    package prices them; the compute term from the port's own FLOPs (its
    ``blocks`` scope counts the L layers the JAX scan body counts once)."""
    spec, jspec = _specs(tmp_path)
    jitem, item = _pair("lm_stacked")
    for it in (jitem, item):
        it.optimizer_name = "sgd"
    strategy = S.Pipeline(2, 4).build(item, spec)
    jstrategy = JS.Pipeline(2, 4).build(jitem, jspec)
    topology, jtopology = _topologies(8, 1)
    model, jmodel = cm.CostModel(topology), jcm.CostModel(jtopology)
    assert model._pipeline_imbalance(item, 2) == pytest.approx(
        jmodel._pipeline_imbalance(jitem, 2), rel=COST_RTOL)
    got = model.strategy_cost(strategy, item)
    want = jmodel.strategy_cost(jstrategy, jitem)
    _close(got, want, skip=("compute_ms", "bubble_ms", "total_ms",
                            "overlap", "bucket_mb"))
    assert got["microbatches"] == 4 and got["pipeline_stages"] == 2
    busy = 3.0 * item.flops_estimate() / (8 * 989e12) * 1e3 * (
        1.0 + got["pipeline_imbalance"])
    assert got["compute_ms"] == pytest.approx(busy * (4 + 2 - 1) / 4,
                                              rel=COST_RTOL)
    mem = model.strategy_memory(strategy, item)
    jmem = jmodel.strategy_memory(jstrategy, jitem)
    _close(mem, jmem, skip=("activations_bytes",))
    assert mem["hold_depth"] == jmem["hold_depth"] == 4
    assert mem["activations_bytes"] == pytest.approx(
        item.activation_live_bytes() / mem["data_axis"] / 2, rel=COST_RTOL)


def test_cost_model_seeds_are_the_cards():
    """The seeds are the H100 SXM's datasheet figures, not the JAX
    package's TPU v5e ones; the capacity fallback is the H100 row."""
    assert cm.DEFAULT_DEVICE_FLOPS == 989e12
    assert cm.DEFAULT_HBM_BYTES_PER_S == 3.35e12
    assert cm.DEFAULT_LINKS[cm.Connectivity.ICI][0] == 450e9
    assert cm.PLATFORM_FALLBACK_HBM_GB == 80.0
    assert cm.DEFAULT_DEVICE_FLOPS != jcm.DEFAULT_DEVICE_FLOPS
    topo = cm.Topology(4)
    assert topo.device_flops == 989e12 and topo.num_hosts == 1


@pytest.mark.parametrize("g", [2, 4, 8])
def test_collective_costs_ordered(g):
    """More bytes cost more, a faster link less, and a group across hosts
    no less than the same group on one host."""
    one = cm.Topology(8, 1)
    two = cm.Topology(8, 2)
    fast = cm.Topology(8, 1, links={cm.Connectivity.ICI: (900e9, 5e-6)})
    for fn in ("all_reduce_cost", "reduce_scatter_cost", "all_gather_cost"):
        assert getattr(one, fn)(2e6, g) >= getattr(one, fn)(1e6, g) > 0
        assert getattr(fast, fn)(1e6, g) <= getattr(one, fn)(1e6, g)
        assert getattr(two, fn)(1e6, g) >= getattr(one, fn)(1e6, g)


def test_topology_for_mesh_reads_the_world(monkeypatch):
    class _Mesh:
        size = 8
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert cm.Topology.for_mesh(_Mesh()).num_hosts == 1
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    topo = cm.Topology.for_mesh(_Mesh())
    assert (topo.num_devices, topo.num_hosts) == (8, 2)


# -- goodput: collect / stitch against the JAX package's ----------------------

def _feed(tracing_mod, reg, loop=True):
    reg.histogram("step.latency_ms").observe_many([2.0] * 10)
    reg.counter("step.count").inc(10)
    reg.histogram("step.data_wait_ms").observe_many([0.5] * 10)
    if loop:
        tracing_mod.record_complete("step-loop", 0.0, 25_000.0)
        tracing_mod.record_complete("compile", 1_000.0, 3_000.0)
        # The dispatches end at 12 ms: half of the 4 ms save after them.
        tracing_mod.record_complete("step-dispatches", 0.0, 12_000.0)
        tracing_mod.record_complete("checkpoint-save", 10_000.0, 4_000.0)
    tracing_mod.record_complete("compile", 100_000.0, 50_000.0)
    tracing_mod.record_complete("restore", 160_000.0, 7_000.0)
    reg.gauge("checkpoint.reshard_ms").set(2.0)
    tracing_mod.record_complete("capture", 200_000.0, 4_000.0)
    tracing_mod.record_complete("emergency-save", 210_000.0, 9_000.0)


@pytest.mark.parametrize("loop", [True, False])
def test_goodput_collect_matches_jax(monkeypatch, loop):
    """The same spans, metrics and clock through both packages. Inside a
    step loop they differ by design: the JAX package subtracts every save
    in the step-loop span from the billed step time, the port only the
    part that overlapped the loop's billed dispatch windows
    (``step-dispatches``): here 2 of the save's 4 ms came after the last
    dispatch. Those 2 ms were never billed, so the port's goodput is 2 ms
    higher and its rollback class (loop time the steps did not bill) 2 ms
    lower; every other class, and the residual, agree exactly."""
    monkeypatch.setenv("AUTODIST_RUN_ID", "parity")
    start = 1_000_000.0
    out = []
    for gp, trc, obs in ((goodput, tracing, observability),
                         (jgoodput, jobs.tracing, jobs)):
        monkeypatch.setattr(gp, "_process_start", start)
        gp._cached.update(flops_per_step=3e9, devices=8,
                          peak_per_device=1e12)
        _feed(trc, obs.registry(), loop)
        s = dict(gp.collect(now=start + 1.0))
        s.pop("pid")
        out.append(s)
    got, want = out
    if loop:
        unbilled = 2.0
        assert got["goodput_ms"] == want["goodput_ms"] + unbilled == 10.0
        assert got["classes"]["rollback_ms"] == \
            want["classes"]["rollback_ms"] - unbilled == 3.0
        differ = ("goodput_ms", "goodput_pct", "hfu", "classes")
        assert {k: v for k, v in got.items() if k not in differ} == \
            {k: v for k, v in want.items() if k not in differ}
        assert {k: v for k, v in got["classes"].items()
                if k != "rollback_ms"} == \
            {k: v for k, v in want["classes"].items() if k != "rollback_ms"}
    else:
        assert got == want
    assert got["goodput_ms"] + sum(got["classes"].values()) == \
        pytest.approx(got["wall_ms"], abs=0.05)
    assert goodput.BADPUT_CLASSES == jgoodput.BADPUT_CLASSES
    assert goodput.EVENT_CLASS == jgoodput.EVENT_CLASS


def test_run_identity(monkeypatch):
    rid = goodput.run_id()
    assert rid == goodput.run_id() and rid.startswith("run")
    monkeypatch.setenv("AUTODIST_RUN_ID", "job-7")
    monkeypatch.setenv("AUTODIST_RUN_GENERATION", "2")
    assert goodput.run_id() == "job-7" and goodput.generation() == 2
    assert (goodput.run_id(), goodput.generation()) == \
        (jgoodput.run_id(), jgoodput.generation())


def test_peak_tables_by_device_name(monkeypatch):
    """The JAX tables' GPU rows, keyed by ``torch.cuda.get_device_name``."""
    gpus = ("h100", "a100", "v100")
    assert goodput.PEAK_TFLOPS_TABLE == tuple(
        row for row in jgoodput.PEAK_TFLOPS_TABLE if row[0] in gpus)
    assert goodput.PEAK_HBM_GB_TABLE == tuple(
        row for row in jgoodput.PEAK_HBM_GB_TABLE if row[0] in gpus)
    for ours, theirs in ((goodput.PLATFORM_DEFAULT_TFLOPS,
                          jgoodput.PLATFORM_DEFAULT_TFLOPS),
                         (goodput.PLATFORM_DEFAULT_HBM_GB,
                          jgoodput.PLATFORM_DEFAULT_HBM_GB)):
        assert ours == {k: theirs[k] for k in ("gpu", "cpu")}
    monkeypatch.setattr(goodput, "device_kind",
                        lambda device=None: ("nvidia h100 80gb hbm3", "gpu"))
    assert goodput.peak_flops_per_device() == 989e12
    assert goodput.peak_hbm_bytes_per_device() == 80 * (1 << 30)
    monkeypatch.setenv("AUTODIST_PEAK_TFLOPS", "123.5")
    assert goodput.peak_flops_per_device() == pytest.approx(123.5e12)
    monkeypatch.undo()
    assert goodput.device_kind("cpu") == ("", "cpu")
    assert goodput.peak_flops_per_device("cpu") == 0.05e12


# -- the Runner end to end ----------------------------------------------------

@pytest.mark.parametrize("unroll", [1, 4])
def test_runner_attribution_invariant(unroll):
    """On a runner whose graph is captured (the capture's dispatch is a
    compile, which the ledger leaves out: the next test)."""
    runner, batch = _build()
    state = runner.create_state()
    state, _ = runner.run(state, _repeat(batch), unroll, unroll=unroll)
    observability.reset()
    state, _ = runner.run(state, _repeat(batch), 8, unroll=unroll)
    gauges = observability.registry().snapshot()["gauges"]
    total = sum(gauges[f"attr.{c}"] for c in attribution.COMPONENTS)
    assert total == pytest.approx(gauges["attr.wall_ms"], abs=2e-3)
    assert gauges["attr.wall_ms"] > 0
    summ = attribution.last_summary()
    assert summ["steps"] == 8 and summ["unroll"] == unroll
    assert summ["dispatches"] == 8 // unroll
    hist = observability.registry().snapshot()["histograms"][
        "step.latency_ms"]
    assert summ["wall_ms"] == pytest.approx(hist["total"] / hist["count"],
                                            rel=0.05)
    assert observability.snapshot()["attribution"] == summ


def test_capture_dispatch_is_left_out_of_the_ledger():
    runner, batch = _build()
    runner.run(runner.create_state(), _repeat(batch), 12, unroll=4)
    summ = attribution.last_summary()
    assert (summ["steps"], summ["dispatches"]) == (8, 2)
    snap = observability.registry().snapshot()
    assert snap["counters"]["step.count"] == 12
    assert snap["histograms"]["step.latency_ms"]["count"] == 3


@pytest.mark.parametrize("unroll", [1, 4])
def test_runner_goodput_reconciles_and_mfu_sane(unroll, monkeypatch):
    monkeypatch.setenv("AUTODIST_RUN_ID", f"e2e-u{unroll}")
    runner, batch = _build()
    state = runner.create_state()
    state, _ = runner.run(state, _repeat(batch), 8, unroll=unroll)
    s = goodput.last_summary()
    assert s is not None and s["steps"] == 8
    total = s["goodput_ms"] + sum(s["classes"].values())
    assert total == pytest.approx(s["wall_ms"], rel=0.05, abs=1.0)
    assert s["goodput_ms"] > 0
    assert s["mfu"] is not None and 0 < s["mfu"] <= 1
    assert s["hfu"] is not None and 0 < s["hfu"]
    gauges = observability.registry().snapshot()["gauges"]
    for name in ("goodput.pct", "goodput.wall_ms", "goodput.goodput_ms",
                 "goodput.mfu", "goodput.hfu", "run.generation"):
        assert name in gauges
    for cls in goodput.BADPUT_CLASSES:
        assert f"goodput.{cls}" in gauges
    assert set(s["goodput_breakdown"]) == set(attribution.COMPONENTS)
    segs = goodput.segments_for()
    assert len(segs) == 1 and segs[0]["steps"] == 8
    assert calibration.Calibration.load().last_mfu == pytest.approx(
        s["mfu"], abs=1e-6)
    if unroll > 1:  # the graph step's capture is a compile
        assert s["classes"]["compile_ms"] > 0


def test_goodput_json_sidecar_under_dump_graphs(monkeypatch, tmp_path):
    monkeypatch.setattr(const, "DEFAULT_GRAPH_DUMP_DIR",
                        str(tmp_path / "graphs"))
    runner, batch = _build()
    runner.run(runner.create_state(), _repeat(batch), 2)
    monkeypatch.setenv("AUTODIST_DUMP_GRAPHS", "1")
    goodput.finalize(runner, observability.registry())
    doc = json.load(open(tmp_path / "graphs" / "goodput.json"))
    assert doc["steps"] == 2 and "classes" in doc


WRITER_SLEEP_S = 0.6


def test_checkpoint_manager_run_bills_only_the_save_stalls(monkeypatch,
                                                           tmp_path):
    """A ``CheckpointManager.run`` whose last step saves, with a writer
    slow enough (a filesystem that sleeps) that each save's span, which
    waits for the previous write, outlasts the steps between saves. Only
    the stall of the mid-loop save was billed to a dispatch; the last
    save and the writer's final wait came after the last dispatch. The
    JAX arithmetic on the same spans (every in-loop save subtracted) reads
    0; the port's goodput is the billed step time less the billed stall,
    which is the steps' own time, and the unbilled save time keeps its
    checkpoint class instead of landing in rollback."""
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.checkpoint import saver as saver_mod
    inner = saver_mod._write_staged

    def slow_write(*args, **kwargs):
        time.sleep(WRITER_SLEEP_S)
        return inner(*args, **kwargs)
    monkeypatch.setattr(saver_mod, "_write_staged", slow_write)
    runner, batch = _build()
    step_s = []
    step = runner.step

    def timed_step(state, b):
        t0 = time.perf_counter()
        out = step(state, b)
        step_s.append(time.perf_counter() - t0)
        return out
    runner.step = timed_step
    mgr = CheckpointManager(runner, tmp_path / "ckpt", save_interval_steps=4)
    mgr.run(runner.create_state(), _repeat(batch), 8, unroll=1)
    mgr.close()
    s = goodput.last_summary()
    assert s["steps"] == 8 and mgr.all_steps() == [1, 4, 8]
    snap = observability.registry().snapshot()
    lat = snap["histograms"]["step.latency_ms"]
    billed = lat["total"]
    phases = observability.phase_timings()
    saves = phases["checkpoint-save"]["total_ms"]
    wait = phases["checkpoint-wait"]["total_ms"]
    # The writer outlasts the steps: the save at 4 stalls for the write of
    # step 1, the one at 8 for that of step 4, and the final wait for 8.
    assert saves > WRITER_SLEEP_S * 1e3 and wait > 0.5 * WRITER_SLEEP_S * 1e3
    assert saves + wait > billed
    steps_ms = 1e3 * sum(step_s)
    # Billed = the steps + the host's loop overhead + the one billed stall.
    assert s["goodput_ms"] >= 0.9 * steps_ms
    assert s["goodput_ms"] <= billed - 0.5 * WRITER_SLEEP_S * 1e3
    assert s["classes"]["checkpoint_save_ms"] == pytest.approx(
        saves + wait, abs=0.01)
    assert s["classes"]["rollback_ms"] < 0.25 * WRITER_SLEEP_S * 1e3
    assert s["goodput_ms"] + sum(s["classes"].values()) == pytest.approx(
        s["wall_ms"], abs=0.05)
    # The JAX package's arithmetic on the same spans and metrics.
    for e in observability.tracing.events():
        if e.get("ph") == "X":
            jobs.tracing.record_complete(e["name"], e["ts"], e["dur"])
    jreg = jobs.registry()
    jreg.histogram("step.latency_ms").observe_many(
        [billed / lat["count"]] * lat["count"])
    jreg.counter("step.count").inc(snap["counters"]["step.count"])
    monkeypatch.setattr(jgoodput, "_process_start", goodput._process_start)
    j = jgoodput.collect(now=s["end"])
    assert j["goodput_ms"] == 0.0 and j["goodput_pct"] == 0.0
    assert s["goodput_pct"] > 0
