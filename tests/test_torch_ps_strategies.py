"""The PS-family and partitioned strategies in the port against the JAX
package: builders, the sharded / padded / stale lowerings, and shipping.

* Each builder's proto equals the JAX builder's, node config for node
  config, on the same captured bert_tiny and linreg with 1, 4 and 8
  devices (``PSLoadBalancing.loads`` too).
* One 8-rank gloo world (one subprocess per rank, 600 s each) runs every
  multi-rank case once; each case below reads its part of that run:
  the ``STRATEGIES`` matrix of ``tests/test_e2e_linreg.py:43-53`` (each
  rank feeds its 4 of every 32-row batch) against the JAX package's
  Runner on its 8-device CPU mesh at that test's tolerance (rtol 1e-5,
  atol 1e-6); the 513-row uneven cases of ``tests/test_uneven_partition.py``
  (stored 1024 rows, 128 per rank, logical 513); ``PS(staleness=1)``'s
  storage; ``PS(staleness=3)``'s per-device trajectories; a spy on
  ``torch.distributed`` for a ZeRO-1 program (the counterpart of
  ``tests/test_hlo_lowering.py:60-86``) and its Adam state per rank;
  bert_tiny under Parallax at the zoo tolerances of
  ``tests/test_torch_train.py`` (rtol 1e-4, atol 1e-5); and the graph
  paths (``make_callable(aot=True)``, ``run(unroll=2)``) of every kind
  bitwise against the eager steps.
* Strategy shipping on a 4-rank world.
"""
import fcntl
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import resource_spec as jrs
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import path_to_name as jpath_to_name
from autodist_tpu.graph_item import VariableItem as JVariableItem
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.models import bert as jbert
from autodist_tpu_torch import AutoDist, convert
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import strategy
from autodist_tpu_torch.graph_item import GraphItem, VariableItem
from autodist_tpu_torch.kernel import partitioner
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve import engine
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every gloo world of the port's tests (its rank scripts read it from
# WORLD_TIMEOUT_S, set by _run_world) gives a collective this long before
# it errors: a rank of one world can sit at a collective while the rank it
# waits on writes and fsyncs a checkpoint or is starved of the CPU by the
# other test workers, and a mismatched collective must still error, not
# hang. Each rank's process gets twice that.
WORLD_TIMEOUT_S = 300
RANK_TIMEOUT_S = 2 * WORLD_TIMEOUT_S
WORLD = 8

#: The graph paths against the eager steps, on a world's ranks: appended to
#: a rank script that imports torch and defines ``named(tree)`` (logical
#: params by name, as numpy).
GRAPH_PATHS = r'''

def graph_paths(runner, batches):
    """From fresh states, over this rank's ``batches`` (an even count):
    the eager steps, ``make_callable(aot=True)``, ``megastep`` over
    consecutive pairs and ``run(unroll=2)``: {path: (losses, logical
    params)} (``unroll2``: the last block's losses)."""
    def block(pair):
        return tuple(torch.stack([torch.as_tensor(a) for a in leaf])
                     for leaf in zip(*pair))

    out = {}
    state, losses = runner.create_state(), []
    for b in batches:
        state, m = runner.step(state, b)
        losses.append(float(m["loss"]))
    out["eager"] = (losses, named(runner.logical_params(state)))
    fn = runner.make_callable(batches[0], aot=True, shard_inputs=True)
    state, losses = runner.create_state(), []
    for b in batches:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
    out["aot"] = (losses, named(runner.logical_params(state)))
    state, losses = runner.create_state(), []
    for i in range(0, len(batches), 2):
        state, m = runner.megastep(state, block(batches[i:i + 2]))
        losses += [float(v) for v in m["loss"]]
    out["megastep"] = (losses, named(runner.logical_params(state)))
    state, m = runner.run(runner.create_state(), iter(batches),
                          len(batches), unroll=2)
    out["unroll2"] = ([float(v) for v in m["loss"]],
                      named(runner.logical_params(state)))
    return out


def first_call_raises(runner, batch):
    """What the graph step's first call raises on ``batch`` (None)."""
    try:
        runner.make_callable(batch, aot=True)(runner.create_state(), batch)
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None
'''


def jax_graph_paths(runner, batches, aot=True, megastep=True):
    """The JAX package's compiled steps from fresh states over ``batches``
    (global batches; an even count): ``make_callable(aot=aot)`` a batch
    and, with ``megastep``, ``megastep`` over consecutive pairs:
    {path: (losses, logical params by name)}. (Under a seq axis this
    jaxlib's AOT executable takes one input too few and its megastep leaks
    a tracer: there the jit step alone is the reference.)"""
    def logical(state):
        return {jpath_to_name(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(jax.device_get(
                    runner.logical_params(state)))[0]}

    out = {}
    fn = runner.make_callable(batches[0], shard_inputs=True, aot=aot)
    state, losses = runner.create_state(), []
    for b in batches:
        state, m = fn(state, b)
        losses.append(float(jax.device_get(m["loss"])))
    out["aot"] = (losses, logical(state))
    if megastep:
        state, losses = runner.create_state(), []
        for i in range(0, len(batches), 2):
            block = jax.tree_util.tree_map(
                lambda *a: np.stack([np.asarray(x) for x in a]),
                *batches[i:i + 2])
            state, m = runner.megastep(state, block)
            losses += [float(v) for v in np.asarray(m["loss"])]
        out["megastep"] = (losses, logical(state))
    return out


def held_graph_paths(ranks, want, rtol, atol):
    """Each rank's graph paths bitwise its eager steps, and held to the
    JAX package's compiled steps ``want`` (:func:`jax_graph_paths`) at
    ``rtol`` / ``atol``."""
    for r, res in enumerate(ranks):
        losses, params = res["eager"]
        for path in ("aot", "megastep", "unroll2"):
            got, got_params = res[path]
            assert got == (losses if path != "unroll2" else losses[-2:]), \
                (r, path, got, losses)
            assert sorted(got_params) == sorted(params)
            for k, v in params.items():
                np.testing.assert_array_equal(got_params[k], v,
                                              err_msg=f"rank {r} {path} {k}")
        for path, (wl, wp) in want.items():
            got, got_params = res[path]
            np.testing.assert_allclose(got, wl, rtol=rtol, atol=atol,
                                       err_msg=f"rank {r} {path}")
            for k, v in wp.items():
                np.testing.assert_allclose(got_params[k], v, rtol=rtol,
                                           atol=atol,
                                           err_msg=f"rank {r} {path} {k}")

# tests/test_e2e_linreg.py:43-53, as expressions both packages evaluate.
STRATEGIES = [
    ("ps", "PS()"),
    ("ps_proxy", "PS(local_proxy_variable=True)"),
    ("ps_lb", "PSLoadBalancing(shard_threshold_bytes=32)"),
    ("partitioned_ps", "PartitionedPS()"),
    ("uneven_ps", "UnevenPartitionedPS()"),
    ("all_reduce", "AllReduce(chunk_size=2)"),
    ("partitioned_ar", "PartitionedAR()"),
    ("random_axis_ar", "RandomAxisPartitionAR(seed=3)"),
    ("parallax", "Parallax()"),
]
# The builders whose protos are compared, as expressions.
BUILDERS = [expr for _, expr in STRATEGIES] + [
    "PS(staleness=2)", "PS(sync=False, gspmd_update=True)",
    "PSLoadBalancing()", "PartitionedPS(staleness=1)",
    "Parallax(chunk_size=3, all_reduce_spec='ICI')",
    "RandomAxisPartitionAR(chunk_size=2, seed=11)", "AllReduce()"]
# The graph paths, one builder per kind of variable it lowers to.
GRAPH_CASES = [("zero1", "PS()"), ("fsdp", "PartitionedPS()"),
               ("stale", "PS(staleness=1)"), ("ar", "Parallax()")]


def _jax_builder(expr):
    return eval(expr, vars(jstrategy))  # noqa: S307 - a fixed test table


def _port_builder(expr):
    return eval(expr, vars(strategy))  # noqa: S307


@pytest.fixture(autouse=True)
def _reset_port_singleton():
    autodist_mod._reset_default()
    yield
    autodist_mod._reset_default()


# -- the builders' protos ----------------------------------------------------

def _spec_text(n):
    return ("nodes:\n  - address: 10.0.0.1\n    gpus: [" +
            ", ".join(str(i) for i in range(n)) + "]\n    chief: true\n")


def _linreg_jax_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def _linreg_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


@functools.lru_cache(maxsize=None)
def _items(model):
    """(JAX graph item, port graph item) of the same program."""
    if model == "linreg":
        x, y = _make_data()
        jparams = {"w": np.zeros((16, 1), np.float32),
                   "b": np.zeros((1,), np.float32)}
        return (JGraphItem.capture(_linreg_jax_loss, jparams, optax.sgd(0.1),
                                   example_batch=(x[:8], y[:8])),
                GraphItem.capture(_linreg_loss, convert.params_from_jax(
                    jparams, "cpu"), None, example_batch=(x[:8], y[:8])))
    jparams, jloss, batch = jbert.tiny_fixture(seed=0)
    jparams = jax.device_get(jparams)
    return (JGraphItem.capture(jloss, jparams, optax.sgd(0.1),
                               example_batch=batch),
            GraphItem.capture(bert.make_loss_fn(bert.bert_tiny()),
                              convert.params_from_jax(jparams, "cpu"), None,
                              example_batch=batch))


@pytest.mark.parametrize("devices", [1, 4, 8])
@pytest.mark.parametrize("model", ["bert_tiny", "linreg"])
@pytest.mark.parametrize("expr", BUILDERS)
def test_builder_proto_matches_jax(tmp_path, expr, model, devices):
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    jspec, spec = jrs.ResourceSpec(str(path)), ResourceSpec(str(path))
    jitem, item = _items(model)
    jb, b = _jax_builder(expr), _port_builder(expr)
    js, s = jb.build(jitem, jspec), b.build(item, spec)
    assert len(s.node_config) == len(js.node_config) > 0
    for node, jnode in zip(s.node_config, js.node_config):
        assert node.SerializeToString() == jnode.SerializeToString(), \
            (node, jnode)
    s.proto.id = js.proto.id = ""
    assert s.proto.SerializeToString() == js.proto.SerializeToString()
    if isinstance(b, strategy.PSLoadBalancing):
        assert b.loads == jb.loads and len(b.loads) == devices


@pytest.mark.parametrize("shape,want", [
    ((513, 64), (None, "data")),   # the dim 8 divides, though not dim 0
    ((513, 63), ("data", None)),   # none divides: the largest, padded
    ((5,), ()),                    # no dim as large as the axis
    ((64, 128), (None, "data")), ((), ())])
def test_choose_state_sharding_spec_cases_match_jax(shape, want):
    """``tests/test_uneven_partition.py::test_uneven_zero1_state_shards``."""
    got = partitioner.choose_state_sharding_spec(
        VariableItem("w", shape, torch.float32), "data", 8)
    jgot = jpart.choose_state_sharding_spec(
        JVariableItem("w", shape, jnp.float32), "data", 8)
    assert tuple(got) == want == tuple(jgot)


@pytest.mark.parametrize("name", [
    "ps", "parallax", "partitionedps", "uneven_partitioned_ps",
    "random_axis_ar", "ps_lb", "allreduce", "partitioned_ar",
    "modelparallel", "model_parallel", "pipeline"])
def test_strategy_names_resolve_in_autodist_and_serving(monkeypatch, name):
    from autodist_tpu.tuner.auto import builder_from_name as jfrom_name
    monkeypatch.setenv("AUTODIST_STRATEGY", name)
    ad = AutoDist(device="cpu")
    assert type(ad._strategy_builder).__name__ == \
        type(jfrom_name(name)).__name__
    assert type(engine._resolve_serve_builder(None)).__name__ == \
        type(jfrom_name(name)).__name__


def test_auto_and_unported_names_raise(monkeypatch):
    for name, item in (("auto", "item 12"), ("automap", "item 12")):
        monkeypatch.setenv("AUTODIST_STRATEGY", name)
        with pytest.raises(NotImplementedError, match=item):
            AutoDist(device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            engine._resolve_serve_builder(None)
    monkeypatch.setenv("AUTODIST_STRATEGY", "no_such_builder")
    with pytest.raises(ValueError, match="names no known builder"):
        AutoDist(device="cpu")


def test_strategy_serializes_and_loads_by_id(monkeypatch, tmp_path):
    """``Strategy.serialize`` / ``deserialize`` round trip, and
    ``AUTODIST_STRATEGY_ID`` loads the artifact instead of building."""
    _, item = _items("linreg")
    built = strategy.PartitionedPS().build(item, ResourceSpec.local("cpu"))
    path = built.serialize(str(tmp_path / built.id))
    loaded = strategy.Strategy.deserialize(path=path)
    assert loaded.proto == built.proto and loaded.path == path
    from autodist_tpu_torch import const
    monkeypatch.setattr(const, "DEFAULT_SERIALIZATION_DIR", str(tmp_path))
    monkeypatch.setenv("AUTODIST_STRATEGY_ID", built.id)
    ad = AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    assert ad._build_or_load_strategy(item).proto == built.proto


def test_one_rank_ps_lowers_to_the_replicated_update_for_any_optimizer():
    """A rank mesh of one rank: PS lowers to the replicated update (every
    kind ``ar``) and any optimizer runs; on a world of several ranks the
    shard-local update needs an element-by-element optimizer (the
    8-rank case ``lbfgs_refused``)."""
    x, y = _make_data()
    ad = AutoDist(device="cpu")  # PS()
    item = ad.capture(_linreg_loss, {"w": torch.zeros(16, 1),
                                     "b": torch.zeros(1)},
                      functools.partial(torch.optim.LBFGS, lr=0.1),
                      example_batch=(x[:8], y[:8]))
    runner = ad.create_distributed_session(item)
    assert isinstance(ad._strategy_builder, strategy.PS)
    assert set(runner.var_kinds.values()) == {("ar", None)}
    runner.create_state()


# -- the 8-rank gloo world ---------------------------------------------------

_RANK = r'''
import datetime, functools, os, pickle, sys, traceback
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
data = dict(np.load(os.path.join(out, "data.npz")))
with open(os.path.join(out, "cases.pkl"), "rb") as f:
    cases = pickle.load(f)
with open(os.path.join(out, "bert.pkl"), "rb") as f:
    bert_params, bert_batch = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
x, y = data["x"], data["y"]
SGD = functools.partial(torch.optim.SGD, lr=0.05)


def named(tree):
    return {path_to_name(p): t.detach().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}


def session(expr, loss_fn, params, opt, example):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=eval(expr, vars(S)), device="cpu")
    item = ad.capture(loss_fn, params, opt, example_batch=example)
    return ad.create_distributed_session(item)


def linreg_loss(p, b):
    bx, by = b
    return torch.mean((bx @ p["w"] + p["b"] - by) ** 2)


def linreg_params():
    return {"w": torch.from_numpy(data["w0"]),
            "b": torch.from_numpy(data["b0"])}


def mine(a, i, per=32):  # this rank's rows of batch i
    local = per // world
    return a[i * per + rank * local:i * per + (rank + 1) * local]


def linreg(expr):
    r = session(expr, linreg_loss, linreg_params(), SGD, (x[:4], y[:4]))
    state = r.create_state()
    losses = []
    for i in range(5):
        state, m = r.step(state, (mine(x, i), mine(y, i)))
        losses.append(float(m["loss"]))
    return {"losses": losses, "kinds": r.var_kinds,
            "params": named(r.logical_params(state)),
            "stored": {k: v.shape for k, v in named(state.params).items()}}


def uneven_loss(p, b):
    bx, by = b
    return torch.mean((bx @ p["emb"] @ p["head"] - by) ** 2)


def uneven(expr, steps=3):
    params = {"emb": torch.from_numpy(data["emb"]),
              "head": torch.from_numpy(data["head"])}
    ux, uy = data["ux"], data["uy"]
    r = session(expr, uneven_loss, params, SGD, (ux[:4], uy[:4]))
    state = r.create_state()
    stored = {k: v.shape for k, v in named(state.params).items()}
    losses = []
    for _ in range(steps):
        state, m = r.step(state, (mine(ux, 0), mine(uy, 0)))
        losses.append(float(m["loss"]))
    return {"losses": losses, "stored": stored, "kinds": r.var_kinds,
            "paddings": r.program.paddings(),
            "params": named(r.logical_params(state))}


def stale3():
    r = session("PS(staleness=3)", linreg_loss, linreg_params(), SGD,
                (x[:4], y[:4]))
    state = r.create_state()
    losses, ws = [], []
    for i in range(8):
        state, m = r.step(state, (mine(x, i % 8), mine(y, i % 8)))
        losses.append(float(m["loss"]))
        ws.append(named(r.logical_params(state))["w"])
    return {"losses": losses, "w": ws, "kinds": r.var_kinds}


def hlo_loss(p, b):
    bx, by = b
    h = torch.relu(bx @ p["w1"])
    return torch.mean((h @ p["w2"] + p["b"] - by) ** 2)


def spy():
    counts = []
    real = {n: getattr(dist, n) for n in (
        "all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")}

    def wrap(n):
        def call(tensor, *a, **k):
            whole = a[0] if n == "reduce_scatter_tensor" else tensor
            counts[-1].append((n, whole.numel()))
            return real[n](tensor, *a, **k)
        return call
    params = {k: torch.from_numpy(data[k]) for k in ("w1", "w2", "hb")}
    params["b"] = params.pop("hb")
    hx, hy = data["hx"], data["hy"]
    r = session("PS()", hlo_loss, params, functools.partial(
        torch.optim.Adam, lr=1e-3, eps=1e-6), (hx[:4], hy[:4]))
    state = r.create_state()
    losses = []
    try:
        for n in real:
            setattr(dist, n, wrap(n))
        for i in range(3):
            counts.append([])
            state, m = r.step(state, (mine(hx, i), mine(hy, i)))
            losses.append(float(m["loss"]))
    finally:
        for n, f in real.items():
            setattr(dist, n, f)
    opt = state.opt_state
    adam = sorted((tuple(st["exp_avg"].shape), tuple(st["exp_avg_sq"].shape))
                  for st in opt.state.values())
    return {"counts": counts, "losses": losses, "kinds": r.var_kinds,
            "adam": adam, "params": named(r.logical_params(state))}


def lbfgs_refused():
    r = session("PS()", linreg_loss, linreg_params(),
                functools.partial(torch.optim.LBFGS, lr=0.1), (x[:4], y[:4]))
    try:
        r.create_state()
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def bert_parallax():
    from autodist_tpu_torch.models import bert
    r = session("Parallax()", bert.make_loss_fn(bert.bert_tiny()),
                bert_params,
                functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6),
                tuple(a[:1] for a in bert_batch))
    state = r.create_state()
    losses = []
    for _ in range(3):
        state, m = r.step(state, tuple(a[rank:rank + 1] for a in bert_batch))
        losses.append(float(m["loss"]))
    return {"losses": losses, "kinds": r.var_kinds,
            "params": named(r.logical_params(state))}


def graph_paths(expr):
    r = session(expr, linreg_loss, linreg_params(), SGD, (x[:4], y[:4]))
    batches = [(mine(x, i), mine(y, i)) for i in range(4)]
    out = {"kinds": r.var_kinds}
    state = r.create_state()
    eager = []
    for b in batches:
        state, m = r.step(state, b)
        eager.append(float(m["loss"]))
    out["eager"] = (eager, named(r.logical_params(state)))
    aot = r.make_callable(batches[0], aot=True, shard_inputs=True)
    state = r.create_state()
    losses = []
    for b in batches:
        state, m = aot(state, b)
        losses.append(float(m["loss"]))
    out["aot"] = (losses, named(r.logical_params(state)))
    state, m = r.run(r.create_state(), iter(batches), 4, unroll=2)
    out["unroll2"] = ([float(v) for v in m["loss"]],
                      named(r.logical_params(state)))
    return out


results = {}
for name, fn, args in cases:
    try:
        results[name] = globals()[fn](*args)
    except Exception:
        results[name] = {"exception": traceback.format_exc()}
    autodist_mod._reset_default()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(results, f)
dist.barrier()
dist.destroy_process_group()
print("done")
'''


def _make_data(n=256, seed=123):
    rng = np.random.RandomState(seed)  # tests/test_e2e_linreg.py:make_data
    x = rng.randn(n, 16).astype(np.float32)
    y = x @ np.full((16, 1), 3.0, np.float32) + 2.0 + \
        0.01 * rng.randn(n, 1).astype(np.float32)
    return x, y.astype(np.float32)


def _uneven_fixture(rows=513):
    rng = np.random.RandomState(0)  # tests/test_uneven_partition.py:_fixture
    emb = rng.randn(rows, 64).astype(np.float32) * 0.1
    head = rng.randn(64, 8).astype(np.float32) * 0.1
    batch = (rng.randn(32, rows).astype(np.float32),
             rng.randn(32, 8).astype(np.float32))
    return emb, head, batch


def _hlo_fixture():
    rng = np.random.RandomState(0)  # tests/test_hlo_lowering.py:_fixture
    params = {"w1": (rng.randn(64, 128) * 0.1).astype(np.float32),
              "w2": (rng.randn(128, 8) * 0.1).astype(np.float32),
              "b": np.zeros((8,), np.float32)}
    batch = (rng.randn(96, 64).astype(np.float32),
             rng.randn(96, 8).astype(np.float32))
    return params, batch


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(script, world, args, cwd):
    """Run ``script`` on ``world`` gloo ranks (argv: args + rank + world);
    returns (stdouts, "") or (None, the failing rank's stderr). A free
    port can be taken before rank 0 binds: one retry."""
    for _ in range(2):
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_",
                                    "LOCAL_", "AUTODIST_"))}
        env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", WORLD_TIMEOUT_S=str(WORLD_TIMEOUT_S))
        procs = [subprocess.Popen(
            [sys.executable, "-c", script, *args, str(r), str(world)],
            cwd=cwd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs, err = [], ""
        try:
            for p in procs:
                out, e = p.communicate(timeout=RANK_TIMEOUT_S)
                if p.returncode != 0:
                    err = e[-4000:]
                    break
                outs.append(out)
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


def _shared_dir(tmp_path_factory):
    """A directory every pytest-xdist worker of this session shares (the
    parent of the workers' base directories), or this process's own base
    directory without xdist."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-rank case, run once per test session on one 8-rank gloo
    world (the first xdist worker to need it runs it under a file lock;
    the others read its results): {case: [rank 0's result, ...]}."""
    shared = _shared_dir(tmp_path_factory)
    out = shared / "ps_world"
    with open(shared / "ps_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            err = _run_ps_world(out)
            (out / "error").write_text(err)
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    per_rank = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    return {name: [res[name] for res in per_rank] for name in per_rank[0]}


def _run_ps_world(out):
    """Write the world's inputs to ``out`` and run it; "" or the failing
    rank's stderr."""
    x, y = _make_data()
    w0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 1)) * 0.1)
    emb, head, (ux, uy) = _uneven_fixture()
    hparams, (hx, hy) = _hlo_fixture()
    np.savez(out / "data.npz", x=x, y=y, w0=w0, b0=np.zeros((1,), np.float32),
             emb=emb, head=head, ux=ux, uy=uy, w1=hparams["w1"],
             w2=hparams["w2"], hb=hparams["b"], hx=hx, hy=hy)
    jparams, _, batch = jbert.tiny_fixture(seed=0)
    with open(out / "bert.pkl", "wb") as f:
        pickle.dump((convert.params_from_jax(jax.device_get(jparams), "cpu"),
                     batch), f)
    cases = ([(f"linreg/{n}", "linreg", (e,)) for n, e in STRATEGIES] +
             [(f"uneven/{e}", "uneven", (e,)) for e in
              ("UnevenPartitionedPS()", "PartitionedPS()")] +
             [("gspmd_update", "linreg", ("PS(gspmd_update=True)",)),
              ("stale1", "uneven", ("PS(staleness=1)", 1)),
              ("stale3", "stale3", ()), ("spy", "spy", ()),
              ("lbfgs_refused", "lbfgs_refused", ()),
              ("bert_parallax", "bert_parallax", ())] +
             [(f"graph/{k}", "graph_paths", (e,)) for k, e in GRAPH_CASES])
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    outs, err = _run_world(_RANK, WORLD, [str(out)], str(out))
    return err if outs is None else ""


def _case(world, name):
    ranks = world[name]
    for r, res in enumerate(ranks):
        assert "exception" not in res, f"rank {r}: {res['exception']}"
    return ranks


def _jax_linreg(expr, steps=5):
    """The JAX Runner's run of tests/test_e2e_linreg.py: optax.sgd(0.05),
    32-row batches on the 8-device mesh; (losses, params after each
    step)."""
    _jreset()
    x, y = _make_data()
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (16, 1)) * 0.1,
              "b": jnp.zeros((1,))}
    ad = JAutoDist(strategy_builder=_jax_builder(expr))
    item = ad.capture(_linreg_jax_loss, params, optax.sgd(0.05),
                      example_batch=(x[:8], y[:8]))
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    losses, trail = [], []
    for i in range(steps):
        rows = slice((i % 8) * 32, (i % 8) * 32 + 32)
        state, metrics = runner.step(state, (x[rows], y[rows]))
        losses.append(float(metrics["loss"]))
        trail.append({k: np.asarray(v) for k, v in jax.device_get(
            runner.logical_params(state)).items()})
    _jreset()
    return losses, trail


@pytest.mark.parametrize("name,expr", STRATEGIES,
                         ids=[s[0] for s in STRATEGIES])
def test_linreg_strategy_on_eight_gloo_ranks_matches_jax(world, name, expr):
    ranks = _case(world, f"linreg/{name}")
    want_losses, trail = _jax_linreg(expr)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        for k in ("w", "b"):
            np.testing.assert_allclose(res["params"][k], trail[-1][k],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(res["params"][k],
                                          ranks[0]["params"][k])
    assert want_losses[-1] < want_losses[0]
    kinds = {k: v[0] for k, v in ranks[0]["kinds"].items()}
    expected = {"ps": "zero1", "ps_proxy": "zero1", "ps_lb": "zero1",
                "partitioned_ps": "fsdp", "uneven_ps": "fsdp",
                "partitioned_ar": "fsdp", "random_axis_ar": "fsdp",
                "all_reduce": "ar", "parallax": "ar"}[name]
    assert kinds == {"w": expected, "b": "ar"}
    if expected == "fsdp":  # (16, 1) in 8 pieces of 2 rows
        assert ranks[3]["stored"]["w"] == (2, 1)


def test_gspmd_update_takes_the_replicated_update_and_matches_jax(world):
    """``PS(gspmd_update=True)``: the JAX package's GSPMD lowering (any
    optimizer); the port's replicated all-reduce update, the same values
    with whole optimizer state on every rank."""
    ranks = _case(world, "gspmd_update")
    want_losses, trail = _jax_linreg("PS(gspmd_update=True)")
    for res in ranks:
        assert res["kinds"] == {"w": ("ar", None), "b": ("ar", None)}
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5,
                                   atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(res["params"][k], trail[-1][k],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("expr", ["UnevenPartitionedPS()", "PartitionedPS()"])
def test_513_rows_shard_padded_on_eight_gloo_ranks(world, expr):
    """``tests/test_uneven_partition.py::test_513_rows_shard_on_8_devices``:
    stored (1024, 64) in 128-row pieces, logical (513, 64), the same
    trajectory as the JAX Runner's."""
    ranks = _case(world, f"uneven/{expr}")
    _jreset()
    emb, head, batch = _uneven_fixture()

    def loss_fn(p, b):
        return jnp.mean((b[0] @ p["emb"] @ p["head"] - b[1]) ** 2)
    ad = JAutoDist(strategy_builder=_jax_builder(expr))
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, {"emb": jnp.asarray(emb), "head": jnp.asarray(head)},
        optax.sgd(0.05), example_batch=batch))
    state = runner.create_state()
    assert state.params["emb"].shape == (1024, 64)
    losses = []
    for _ in range(3):
        state, metrics = runner.step(state, batch)
        losses.append(float(metrics["loss"]))
    want = jax.device_get(runner.logical_params(state))
    for r, res in enumerate(ranks):
        assert res["paddings"] == {"emb": (0, 513, 1024)}
        assert res["stored"]["emb"] == (128, 64), r
        assert res["kinds"]["emb"] == ("fsdp", 0)
        assert res["params"]["emb"].shape == (513, 64)
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5,
                                   atol=1e-6)
        for k in ("emb", "head"):
            np.testing.assert_allclose(res["params"][k], np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)


def test_staleness_one_stores_whole_copies_on_eight_gloo_ranks(world):
    """``test_uneven_partition.py::test_explicit_path_skips_padding_plan``:
    a stale variable is not padded; the JAX Runner stores every device's
    copy in one (8, 513, 64) array, each rank here its own (513, 64), equal
    to that array's row for its device."""
    ranks = _case(world, "stale1")
    _jreset()
    emb, head, batch = _uneven_fixture()

    def loss_fn(p, b):
        return jnp.mean((b[0] @ p["emb"] @ p["head"] - b[1]) ** 2)
    ad = JAutoDist(strategy_builder=jstrategy.PS(staleness=1))
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, {"emb": jnp.asarray(emb), "head": jnp.asarray(head)},
        optax.sgd(0.05), example_batch=batch))
    state, metrics = runner.step(runner.create_state(), batch)
    want = jax.device_get(runner.logical_params(state))
    assert want["emb"].shape == (8, 513, 64)
    for r, res in enumerate(ranks):
        assert res["stored"]["emb"] == (513, 64)
        assert res["paddings"] == {}
        assert res["kinds"] == {"emb": ("stale", None),
                                "head": ("stale", None)}
        np.testing.assert_allclose(res["losses"][0], float(metrics["loss"]),
                                   rtol=1e-5, atol=1e-6)
        for k in ("emb", "head"):
            np.testing.assert_allclose(res["params"][k],
                                       np.asarray(want[k])[r], rtol=1e-5,
                                       atol=1e-6)


def test_staleness_three_trajectories_per_rank_match_jax(world):
    """``tests/test_e2e_linreg.py::test_staleness_local_sgd``: every
    rank's copy equal after a sync step (steps 4 and 8), and each rank's
    trajectory that of the JAX array's row for its device."""
    ranks = _case(world, "stale3")
    want_losses, trail = _jax_linreg("PS(staleness=3)", steps=8)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], want_losses, rtol=1e-5,
                                   atol=1e-6)
        for step, (w, want) in enumerate(zip(res["w"], trail)):
            np.testing.assert_allclose(w, want["w"][r], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} step {step + 1}")
    for step in (3, 7):
        for res in ranks:
            np.testing.assert_array_equal(res["w"][step], ranks[0]["w"][step])
    assert any(not np.array_equal(ranks[r]["w"][0], ranks[0]["w"][0])
               for r in range(1, WORLD))  # between syncs copies diverge
    assert want_losses[-1] < want_losses[0]


def test_zero1_program_reduce_scatters_and_gathers_without_all_reduce(world):
    """``tests/test_hlo_lowering.py::test_ps_zero1_lowers_to_reduce_scatter``
    as a spy on ``torch.distributed``: per step one reduce-scatter and one
    all-gather of each PS variable's whole size, and the only all-reduce
    the loss's; the trajectory (Adam) the JAX Runner's."""
    ranks = _case(world, "spy")
    sizes = {"w1": 64 * 128, "w2": 128 * 8, "b": 8}
    for res in ranks:
        assert res["kinds"] == {"b": ("zero1", 0), "w1": ("zero1", 1),
                                "w2": ("zero1", 0)}
        for step in res["counts"]:
            by_op = {}
            for op, numel in step:
                by_op.setdefault(op, []).append(numel)
            assert sorted(by_op["reduce_scatter_tensor"]) == \
                sorted(sizes.values())
            assert sorted(by_op["all_gather_into_tensor"]) == \
                sorted(sizes.values())
            assert by_op["all_reduce"] == [1]
    _jreset()
    params, batch = _hlo_fixture()

    def loss_fn(p, b):
        h = jax.nn.relu(b[0] @ p["w1"])
        return jnp.mean((h @ p["w2"] + p["b"] - b[1]) ** 2)
    ad = JAutoDist(strategy_builder=jstrategy.PS())
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, optax.adam(1e-3, eps=1e-6),
        example_batch=(batch[0][:32], batch[1][:32])))
    state = runner.create_state()
    losses = []
    for i in range(3):
        state, metrics = runner.step(state, (batch[0][i * 32:(i + 1) * 32],
                                             batch[1][i * 32:(i + 1) * 32]))
        losses.append(float(metrics["loss"]))
    want = jax.device_get(state.params)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        for k in sizes:
            np.testing.assert_allclose(res["params"][k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_zero1_adam_state_per_rank_is_an_eighth(world):
    """Each rank's Adam moments are its shard of the state: 1/8 of every
    variable (w1 split along dim 1, the dim 8 divides)."""
    ranks = _case(world, "spy")
    want = sorted([((64, 16), (64, 16)), ((16, 8), (16, 8)), ((1,), (1,))])
    for res in ranks:
        assert res["adam"] == want


def test_shard_local_update_refuses_a_non_elementwise_optimizer(world):
    for res in _case(world, "lbfgs_refused"):
        assert res["error"] is not None and "LBFGS" in res["error"] and \
            "gspmd_update=True" in res["error"]


def test_bert_tiny_under_parallax_on_eight_gloo_ranks_matches_jax(world):
    """BASELINE's BERT configuration at the tiny size: the embedding table
    (sparse access) split over the 8 ranks (kind ``fsdp``), every dense
    variable all-reduced; Adam (eps 1e-6), three steps of the fixture's 8
    rows, one per rank, against the JAX Runner at the zoo tolerances."""
    ranks = _case(world, "bert_parallax")
    _jreset()
    jparams, jloss, batch = jbert.tiny_fixture(seed=0)
    ad = JAutoDist(strategy_builder=jstrategy.Parallax())
    runner = ad.create_distributed_session(ad.capture(
        jloss, jparams, optax.adam(1e-3, eps=1e-6), example_batch=batch))
    state = runner.create_state()
    losses = []
    for _ in range(3):
        state, metrics = runner.step(state, batch)
        losses.append(float(metrics["loss"]))
    want = {path_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(
                runner.logical_params(state)))[0]}
    for r, res in enumerate(ranks):
        assert res["kinds"]["embed/embedding"] == ("fsdp", 0)
        assert {k for k, v in res["kinds"].items() if v[0] != "ar"} == \
            {"embed/embedding"}
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        assert sorted(res["params"]) == sorted(want)
        for k in want:
            np.testing.assert_allclose(res["params"][k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {r} {k}")
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("kind,expr", GRAPH_CASES,
                         ids=[k for k, _ in GRAPH_CASES])
def test_graph_paths_of_every_kind_match_eager_steps(world, kind, expr):
    """``make_callable(aot=True)`` and ``run(unroll=2)`` (on the CPU the
    graph's function runs directly, over the same static buffers) give the
    eager steps' losses and params bitwise, for each kind of variable."""
    for res in _case(world, f"graph/{kind}"):
        assert res["kinds"]["w"][0] == kind
        eager_losses, eager_params = res["eager"]
        for path in ("aot", "unroll2"):
            losses, params = res[path]
            want = eager_losses if path == "aot" else eager_losses[2:]
            assert losses == want, path
            for k in ("w", "b"):
                np.testing.assert_array_equal(params[k], eager_params[k])


# -- strategy shipping on 4 ranks --------------------------------------------

_SHIP_RANK = r'''
import datetime, functools, json, os, sys
import torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S

mode, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))


def loss_fn(p, b):
    return sum((v.sum() for v in p.values()), b.sum())


params = {"a": torch.zeros(12, 8), "b": torch.zeros(6, 10),
          "c": torch.zeros(4, 6, 9), "d": torch.zeros(10, 4)}
if mode == "fingerprint":
    os.environ["AUTODIST_STRATEGY_SHIP_TIMEOUT_MS"] = "2000"
    if rank == 1:  # this rank captured another program
        params["d"] = torch.zeros(10, 5)
ad = AutoDist(strategy_builder=S.RandomAxisPartitionAR(seed=None),
              device="cpu")
item = ad.capture(loss_fn, params, functools.partial(torch.optim.SGD, lr=1),
                  example_batch=torch.zeros(4))
try:
    runner = ad.create_distributed_session(item)
    out = {"id": runner.program.strategy.id,
           "parts": [n.partitioner
                     for n in runner.program.strategy.node_config]}
except RuntimeError as e:
    out = {"error": str(e)}
print(json.dumps(out))
'''


@pytest.mark.parametrize("mode", ["unseeded", "fingerprint"])
def test_strategy_shipping_on_four_gloo_ranks(tmp_path, mode):
    """The chief builds an unseeded RandomAxisPartitionAR once and every
    worker runs its strategy: one id and one set of partitions on every
    rank. A rank whose program has another fingerprint waits under another
    key and times out with an error that says so; the others run."""
    outs, err = _run_world(_SHIP_RANK, 4, [mode], str(tmp_path))
    assert outs is not None, err
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    ok = [r for i, r in enumerate(res) if mode == "unseeded" or i != 1]
    assert all("error" not in r for r in ok), ok
    assert len({r["id"] for r in ok}) == 1
    assert all(r["parts"] == ok[0]["parts"] for r in ok)
    if mode == "fingerprint":
        assert "no strategy was shipped" in res[1]["error"]
        assert "2000 ms" in res[1]["error"] and \
            "fingerprint differs" in res[1]["error"]
