"""The port's overlap scheduler against the JAX package and against itself.

* ``bucket_plan`` / ``plan_fingerprint`` / ``bucket_bytes_cap`` equal to
  the JAX functions on the same members (with and without a cap that
  splits a fusion key);
* ``grad_production_order`` on ``tests/test_overlap.py``'s MLP: reverse
  layer order, as the JAX function's (the numbers are aten positions, not
  jaxpr positions: only the order agrees), deterministic across captures,
  ``{}`` without a signal;
* on a 4-rank gloo world, ``AUTODIST_OVERLAP=1`` against overlap off,
  bitwise equal params (Adam 1e-2, 8 steps): ``AllReduce`` and ``PS``
  (zero1) at K = 1 (steps) and K = 4 (``run(unroll=4)``), the zero1
  all-gather moved by ``AUTODIST_ZERO1_AG_SCOPE=step`` and ``use``, the
  bucket cap (``AUTODIST_AR_BUCKET_MB=1`` splits the 1 MiB layer off), and
  an int8 wire issued from the backward;
* the measured exposed comms: synthetic kernel windows with a known
  answer (compute on another stream hides part of a collective; on its
  own stream none), the CPU's gloo stand-ins, and a profiled
  ``Runner.run`` on the world setting ``comms.exposed_ms_per_step``, the
  attribution's ``torch-profiler`` source on every rank, and
  ``dump_scheduled``'s JSON.
"""
import fcntl
import functools
import pickle

import numpy as np
import pytest
import torch

from autodist_tpu.kernel import overlap as joverlap
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.kernel import overlap
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce

WORLD = 4
HIDDEN = 512   # w2 is 1 MiB: a 1 MiB cap splits it from w3


def _loss_fn(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    h = torch.relu(h @ params["w2"])
    return torch.mean((h @ params["w3"] - y) ** 2)


def _params(hidden=16):
    return {"w1": torch.zeros(8, hidden), "w2": torch.zeros(hidden, hidden),
            "w3": torch.zeros(hidden, 4)}


# -- the plan ------------------------------------------------------------------

MEMBERS = [("w1", (0, 0, "", "f32"), 4096.0), ("w2", (0, 0, "", "f32"),
                                               2 << 20),
           ("w3", (0, 0, "", "f32"), 1024.0), ("e", (1, 5, "", "f32"), 300.0),
           ("b", (0, 0, "", "bf16"), 64.0), ("z", (0, 0, "", "f32"), 8.0)]
ORDERS = [None, {"w3": 10, "w2": 20, "w1": 30, "e": 5, "b": 25},
          {"w1": 1, "w2": 1, "w3": 1}]


@pytest.mark.parametrize("order", range(len(ORDERS)))
@pytest.mark.parametrize("cap", [0, 1 << 20, 5000, 3 << 20])
def test_bucket_plan_equals_jax(order, cap):
    got = overlap.bucket_plan(MEMBERS, ORDERS[order], cap)
    want = joverlap.bucket_plan(MEMBERS, ORDERS[order], cap)
    assert [tuple(b) for b in got] == [tuple(b) for b in want]
    assert overlap.plan_fingerprint(got) == joverlap.plan_fingerprint(want)


def test_bucket_cap_splits_a_key():
    plan = overlap.bucket_plan(MEMBERS, ORDERS[1], 1 << 20)
    f32 = [b.names for b in plan if b.key == (0, 0, "", "f32")]
    # z has no production index: it sorts after the known ones' count
    # (len(order) + len(members) + 1 = 12), so before w2 (20).
    assert f32 == [("w3", "z"), ("w2",), ("w1",)]


@pytest.mark.parametrize("mb", [None, 0, 1, 16])
def test_bucket_bytes_cap_equals_jax(mb, monkeypatch):
    monkeypatch.setenv("AUTODIST_AR_BUCKET_MB", "3")
    assert overlap.bucket_bytes_cap(mb) == joverlap.bucket_bytes_cap(mb)


def _capture(params=None):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    rng = np.random.RandomState(0)
    batch = (torch.tensor(rng.randn(32, 8), dtype=torch.float32),
             torch.tensor(rng.randn(32, 4), dtype=torch.float32))
    item = ad.capture(_loss_fn, params or _params(),
                      functools.partial(torch.optim.Adam, lr=1e-2),
                      example_batch=batch)
    return ad, item


def test_grad_production_order_is_reverse_layer_order():
    """The backward produces w3's gradient first, then w2's, then w1's:
    the JAX function's order on the same MLP."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.graph_item import GraphItem as JGraphItem

    def jloss(params, batch):
        x, y = batch
        h = jax.nn.relu(x @ params["w1"])
        h = jax.nn.relu(h @ params["w2"])
        return jnp.mean((h @ params["w3"] - y) ** 2)
    _, item = _capture()
    got = overlap.grad_production_order(item)
    jitem = JGraphItem.capture(
        jloss, {k: jnp.zeros(tuple(v.shape)) for k, v in _params().items()},
        example_batch=(np.zeros((32, 8), np.float32),
                       np.zeros((32, 4), np.float32)))
    want = joverlap.grad_production_order(jitem)
    assert sorted(got, key=got.get) == sorted(want, key=want.get) == \
        ["w3", "w2", "w1"]
    autodist_mod._reset_default()


def test_runner_plan_deterministic_across_captures():
    runs = []
    for _ in range(3):
        ad, item = _capture()
        runner = ad.create_distributed_session(item)
        plan = runner.bucket_plan()
        runs.append((plan, overlap.plan_fingerprint(plan),
                     runner.grad_production_order()))
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0][0].names == ("w3", "w2", "w1")
    autodist_mod._reset_default()


def test_grad_production_order_without_a_signal():
    class Item:
        loss_fn = None
        batch_struct = None
    assert overlap.grad_production_order(Item()) == {}
    _, item = _capture()
    item.loss_fn = lambda p, b: (_ for _ in ()).throw(RuntimeError("opaque"))
    assert overlap.grad_production_order(item) == {}
    autodist_mod._reset_default()


# -- measured exposed comms ------------------------------------------------------

def _kernel(name, ts, dur, stream):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream}}


def test_exposed_ms_on_synthetic_kernels():
    """An all-reduce of 100 us on stream 20, with compute on stream 7 over
    [30, 60) and [50, 80) (a union of 50 us inside it) and a kernel on its
    own stream (hides nothing): 50 us exposed. A reduce-scatter of 40 us
    with nothing beside it: wholly exposed. Two steps: 45 us a step."""
    trace = {"traceEvents": [
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 100, 20),
        _kernel("sm90_gemm", 30, 30, 7), _kernel("elementwise", 50, 30, 7),
        _kernel("other_on_nccl_stream", 10, 20, 20),
        _kernel("ncclKernel_ReduceScatter_RING", 200, 40, 20),
        _kernel("after", 300, 10, 7),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5}]}
    coll, comp = overlap.trace_events(trace)
    windows = overlap.collective_windows(coll, comp)
    assert [w["op"] for w in windows] == ["all-reduce", "reduce-scatter"]
    assert windows[0]["hidden_ms"] == pytest.approx(0.05)
    assert windows[0]["exposed_ms"] == pytest.approx(0.05)
    assert windows[0]["window_ops"] == 2
    assert windows[1]["exposed_ms"] == pytest.approx(0.04)
    assert overlap.exposed_collective_ms(windows, steps=2) == \
        pytest.approx(0.045)
    assert overlap.overlap_share(windows) == pytest.approx(50 / 140)


def test_exposed_ms_on_gloo_work():
    """No NCCL kernel: gloo's work ranges on its worker thread are the
    collectives. On the CPU the caller's ops running meanwhile hide them
    (an all-reduce over [10, 70) beside a matmul over [50, 100): 20 of
    60 us); the caller's enqueue op (``c10d::``) is neither."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": "c10d::allreduce_",
           "ts": 0, "dur": 5, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "gloo:all_reduce",
           "ts": 10, "dur": 60, "tid": 9},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
           "ts": 50, "dur": 50, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
           "ts": 200, "dur": 10, "tid": 1}]
    coll, comp = overlap.trace_events({"traceEvents": ev})
    assert [c[1] for c in coll] == ["all-reduce"] and len(comp) == 2
    windows = overlap.collective_windows(coll, comp)
    assert windows[0]["hidden_ms"] == pytest.approx(0.02)
    assert windows[0]["exposed_ms"] == pytest.approx(0.04)
    # gloo staging CUDA tensors: the card's kernels are the compute (the
    # caller's ops only launch them), hiding 15 of the 60 us.
    cuda = {"traceEvents": ev + [_kernel("gemm", 0, 15, 7),
                                 _kernel("elementwise", 60, 10, 7),
                                 _kernel("late", 300, 5, 7)]}
    coll, comp = overlap.trace_events(cuda)
    assert len(comp) == 3 and [c[1] for c in coll] == ["all-reduce"]
    windows = overlap.collective_windows(coll, comp)
    assert windows[0]["hidden_ms"] == pytest.approx(0.015)
    assert windows[0]["window_ops"] == 2


# -- the 4-rank gloo world -------------------------------------------------------

_RANK = r'''
import datetime, functools, json, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, observability, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.observability import attribution

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
os.environ["AUTODIST_WORKING_DIR"] = os.path.join(out, f"wd{rank}")
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
hidden = inp["hidden"]


def loss_fn(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    h = torch.relu(h @ params["w2"])
    return torch.mean((h @ params["w3"] - y) ** 2)


batches = [(torch.from_numpy(x[rank::world].copy()),
            torch.from_numpy(y[rank::world].copy()))
           for x, y in inp["batches"]]
KNOBS = ("AUTODIST_OVERLAP", "AUTODIST_AR_BUCKET_MB",
         "AUTODIST_ZERO1_AG_SCOPE", "AUTODIST_TELEMETRY")


def train(expr, env, unroll, trace=False):
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    observability.refresh()
    observability.reset()
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=eval(expr, vars(S)), device="cpu")
    rng = np.random.RandomState(1)
    params = {"w1": torch.from_numpy(rng.randn(8, hidden).astype(np.float32) * 0.1),
              "w2": torch.from_numpy(rng.randn(hidden, hidden).astype(np.float32) * 0.05),
              "w3": torch.from_numpy(rng.randn(hidden, 4).astype(np.float32) * 0.1)}
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.Adam, lr=1e-2),
                      example_batch=batches[0])
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    n = len(batches)
    extra = {}
    if unroll == 1 and not trace:
        for b in batches:
            state, m = runner.step(state, b)
    else:
        kw = {"trace_dir": os.path.join(out, f"tr{rank}")} if trace else {}
        state, m = runner.run(state, iter(batches), n, unroll=unroll, **kw)
    if trace:
        gauges = observability.registry().snapshot().get("gauges") or {}
        summ = attribution.last_summary() or {}
        path = runner.dump_scheduled(batches[0])
        with open(path) as f:
            dumped = json.load(f)
        extra = {"exposed": gauges.get("comms.exposed_ms_per_step"),
                 "overlap_gauge": gauges.get("step.overlap"),
                 "wire_ici": gauges.get("comms.wire_ici_bytes"),
                 "source": (summ.get("sources") or {}).get("exposed_comms"),
                 "attr_exposed": summ.get("exposed_comms_ms"),
                 "dumped": dumped}
    return {"params": {k: v.detach().numpy().copy() for k, v in
                       runner.logical_params(state).items()},
            "kinds": dict(runner.var_kinds), "overlap": runner._overlap,
            "buckets": [list(b.names) for b in runner.bucket_plan()],
            "loss": float(m["loss"].reshape(-1)[-1]), **extra}


res = {}
for name, (expr, env, unroll) in inp["cases"].items():
    res[name] = train(expr, env, unroll)
res["profiled"] = train("AllReduce()", {"AUTODIST_OVERLAP": "1"}, 1,
                        trace=True)
dist.barrier()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''

ON = {"AUTODIST_OVERLAP": "1"}
CASES = {
    "ar/k1/off": ("AllReduce()", {}, 1),
    "ar/k1/on": ("AllReduce()", ON, 1),
    "ar/k4/off": ("AllReduce()", {}, 4),
    "ar/k4/on": ("AllReduce()", ON, 4),
    "ar/cap/on": ("AllReduce()", dict(ON, AUTODIST_AR_BUCKET_MB="1"), 4),
    "ar/cap/off": ("AllReduce()", {"AUTODIST_AR_BUCKET_MB": "1"}, 4),
    "ar/cap/k1/on": ("AllReduce()", dict(ON, AUTODIST_AR_BUCKET_MB="1"), 1),
    "ar/cap/k1/off": ("AllReduce()", {"AUTODIST_AR_BUCKET_MB": "1"}, 1),
    "ps/k1/off": ("PS()", {}, 1),
    "ps/k1/on": ("PS()", ON, 1),
    "ps/k4/off": ("PS()", {}, 4),
    "ps/k4/step": ("PS()", dict(ON, AUTODIST_ZERO1_AG_SCOPE="step"), 4),
    "ps/k4/use": ("PS()", dict(ON, AUTODIST_ZERO1_AG_SCOPE="use"), 4),
    "int8/k1/off": ("AllReduce(compressor='Int8Compressor')", {}, 1),
    "int8/k1/on": ("AllReduce(compressor='Int8Compressor')", ON, 1),
    "ef/k4/off": ("AllReduce(compressor='Int8CompressorEF')", {}, 4),
    "ef/k4/on": ("AllReduce(compressor='Int8CompressorEF')", ON, 4),
}
PAIRS = [("ar/k1/on", "ar/k1/off"), ("ar/k4/on", "ar/k4/off"),
         ("ar/k4/off", "ar/k1/off"), ("ar/cap/on", "ar/cap/off"),
         ("ar/cap/k1/on", "ar/cap/k1/off"), ("ar/cap/off", "ar/cap/k1/off"),
         ("ps/k1/on", "ps/k1/off"),
         ("ps/k4/step", "ps/k4/off"), ("ps/k4/use", "ps/k4/off"),
         ("ps/k4/off", "ps/k1/off"), ("int8/k1/on", "int8/k1/off"),
         ("ef/k4/on", "ef/k4/off")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-rank case, run once per test session on a 4-rank gloo
    world (the first xdist worker to need it runs it under a file lock)."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "overlap_world"
    with open(shared / "overlap_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            rng = np.random.RandomState(0)
            batches = [(rng.randn(32, 8).astype(np.float32),
                        rng.randn(32, 4).astype(np.float32))
                       for _ in range(8)]
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({"batches": batches, "cases": CASES,
                             "hidden": HIDDEN}, f)
            outs, err = _run_world(_RANK, WORLD, [str(out)], str(out))
            (out / "error").write_text(err if outs is None else "")
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    per_rank = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    return {name: [res[name] for res in per_rank] for name in per_rank[0]}


@pytest.mark.parametrize("pair", PAIRS, ids=["|".join(p) for p in PAIRS])
def test_overlap_on_is_bitwise_overlap_off(world, pair):
    got, want = pair
    for r in range(WORLD):
        a, b = world[got][r], world[want][r]
        for k in b["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                          err_msg=f"{got} vs {want}: {k}")
    assert world[got][0]["overlap"] == ("on" in got.split("/")[-1] or
                                        got.split("/")[-1] in ("step", "use"))


def test_the_cases_ran_what_they_name(world):
    """PS lowers every layer to zero1 on 4 ranks; the plan issues w3's
    gradient first; the 1 MiB cap splits the buckets; training moved."""
    for case in ("ps/k4/use", "ps/k4/step", "ps/k1/on"):
        assert {k for k, _ in world[case][0]["kinds"].values()} == {"zero1"}
    assert world["ar/k1/on"][0]["buckets"] == [["w3", "w2", "w1"]]
    assert world["ar/cap/on"][0]["buckets"] == [["w3"], ["w2"], ["w1"]]
    assert np.isfinite(world["ar/k4/on"][0]["loss"])
    assert world["ar/k4/on"][0]["loss"] < 2.0


def test_bucket_cap_changes_only_the_sums_order(world):
    """Split buckets reduce the same sums in another ring order: equal to
    the uncapped run within rounding, not bitwise (gloo's ring sums an
    element in an order that depends on its place in the bucket)."""
    for r in range(WORLD):
        for k, v in world["ar/k1/off"][r]["params"].items():
            np.testing.assert_allclose(world["ar/cap/k1/off"][r]["params"][k],
                                       v, rtol=1e-5, atol=1e-6)


def test_profiled_run_measures_exposed_comms(world):
    """Each rank's measured ``comms.exposed_ms_per_step`` (gloo's
    collective ops' self times on the CPU), the attribution's
    ``exposed_comms`` its own with source ``torch-profiler``, the overlap
    badge, the wire gauge, and ``dump_scheduled``'s windows."""
    for res in world["profiled"]:
        assert res["exposed"] is not None and res["exposed"] > 0
        assert res["source"] == "torch-profiler"
        assert res["attr_exposed"] == pytest.approx(res["exposed"])
        assert res["overlap_gauge"] == 1
        assert res["wire_ici"] > 0
        dumped = res["dumped"]
        assert dumped["source"] == "torch-profiler" and dumped["overlap"]
        assert dumped["windows"] and dumped["exposed_ms_per_step"] > 0
        assert {w["op"] for w in dumped["windows"]} >= {"all-reduce"}
