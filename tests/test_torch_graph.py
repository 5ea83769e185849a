"""The host-side fast paths through CUDA graphs, against the JAX package.

``Runner.make_callable(batch, aot=True)``, ``Runner.megastep`` and
``Runner.run(unroll=K)`` capture the step as a CUDA graph on the card and
run the same static-buffer code directly on the CPU, which is what these
tests drive (``device="cpu"``). The JAX side runs on its 8-device CPU mesh.

* The MLP of ``tests/test_unroll.py`` (Adam 1e-2), with seeded weights (at
  the zeros that test starts from nothing trains): ``run(unroll=K)`` and
  three ``aot=True`` calls against the JAX package's at rtol 1e-5 / atol
  1e-6 (f32, other summation orders), and bitwise against the port's own
  sequential ``step()`` calls (the same operations on the same values).
* ``shard_block``, the pinned ``fetch``, the optimizer check, the metrics
  a replay would overwrite, the flash kernels' launch counts under a
  capture (``torch.cuda`` faked: there is no card here), and serving
  through the bucket graphs' plain path.
"""
import functools
import json
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import const as jconst
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import AutoDist, const, serve
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import runner as runner_mod
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.utils import cuda_graph
from autodist_tpu_torch.utils.tree import leaves

BATCH = 32
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _reset_singletons():
    autodist_mod._reset_default()
    yield
    autodist_mod._reset_default()


def _jloss(params, batch):  # tests/test_unroll.py:27-30
    x, y = batch
    h = jax.nn.relu(x @ params["w1"])
    return jnp.mean((h @ params["w2"] - y) ** 2)


def _loss(params, batch):
    x, y = batch
    h = torch.relu(x @ params["w1"])
    return torch.mean((h @ params["w2"] - y) ** 2)


def _batches(n, seed=0):  # tests/test_unroll.py:33-36
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, 8).astype(np.float32),
             rng.randn(BATCH, 4).astype(np.float32)) for _ in range(n)]


def _weights(seed=1):
    rng = np.random.RandomState(seed)
    return {"w1": (0.5 * rng.randn(8, 16)).astype(np.float32),
            "w2": (0.5 * rng.randn(16, 4)).astype(np.float32)}


def _jrunner():
    _jreset()
    ad = JAutoDist(strategy_builder=JAllReduce())
    item = ad.capture(_jloss, {k: jnp.asarray(v) for k, v in
                               _weights().items()},
                      optax.adam(1e-2), example_batch=_batches(1)[0])
    return ad.create_distributed_session(item)


def _runner(optimizer=None):
    autodist_mod._reset_default()   # one AutoDist per process
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(_loss, {k: torch.from_numpy(v) for k, v in
                              _weights().items()},
                      optimizer or functools.partial(torch.optim.Adam,
                                                     lr=1e-2),
                      example_batch=_batches(1)[0])
    return ad.create_distributed_session(item)


def _params(state):
    return {k: np.asarray(jax.device_get(v)) if not isinstance(
        v, torch.Tensor) else v.detach().numpy().copy()
        for k, v in state.params.items()}


# -- run(unroll=K) and the megastep -----------------------------------------


@pytest.mark.parametrize("unroll", [2, 4])
def test_run_unroll_matches_jax_and_the_sequential_steps(unroll):
    n = 8
    batches = _batches(n)
    jr = _jrunner()
    js, jm = jr.run(jr.create_state(), iter(batches), n, unroll=unroll)
    want = _params(js)

    seq = _runner()
    s_seq = seq.create_state()
    seq_losses = []
    for b in batches:
        s_seq, m = seq.step(s_seq, b)
        seq_losses.append(float(m["loss"]))

    r = _runner()
    s, m = r.run(r.create_state(), iter(batches), n, unroll=unroll)
    got = _params(s)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        np.testing.assert_array_equal(got[k], _params(s_seq)[k], err_msg=k)
    assert tuple(m["loss"].shape) == (unroll,)
    np.testing.assert_allclose(m["loss"].numpy(),
                               np.asarray(jax.device_get(jm["loss"])),
                               rtol=RTOL, atol=ATOL)
    assert m["loss"].tolist() == seq_losses[-unroll:]
    assert tuple(m["notfinite"].shape) == () and not bool(m["notfinite"])
    assert np.shape(jax.device_get(jm["notfinite"])) == ()
    assert int(s.step) == n


def test_megastep_stacks_metrics_and_aggregates_notfinite():
    r = _runner()
    block = r._next_block(iter(_batches(3)), 3)
    assert [np.shape(l) for l in leaves(block)] == [(3, BATCH, 8),
                                                    (3, BATCH, 4)]
    start = r.create_state()
    state, m = r.megastep(start, block)
    assert tuple(m["loss"].shape) == (3,) and m["notfinite"].dtype == \
        torch.bool and int(state.step) == 3
    assert not bool(m["notfinite"])
    bad = (block[0].copy(), block[1].copy())
    bad[1][1, 0, 0] = np.nan   # step 2 of the block diverges
    state, m = r.megastep(state, bad)
    assert bool(m["notfinite"]) and int(state.step) == 6
    assert np.isfinite(float(m["loss"][0])) and \
        not np.isfinite(float(m["loss"][1]))
    with pytest.raises(RuntimeError, match="stale"):
        r.megastep(start, block)
    fresh, _ = r.megastep(r.create_state(), block)   # a graph of its own
    assert int(fresh.step) == 3


@pytest.mark.parametrize("side", ["port", "jax"])
def test_unroll_requires_a_multiple_of_the_steps(side, monkeypatch):
    r = _runner() if side == "port" else _jrunner()
    with pytest.raises(ValueError, match="num_steps=7 is not a multiple of "
                                         "unroll=2; megasteps dispatch "
                                         "whole K-step blocks"):
        r.run(r.create_state(), iter(_batches(8)), 7, unroll=2)


def test_unroll_knob_matches_jax_and_sets_the_default(monkeypatch):
    assert (const.ENV.AUTODIST_UNROLL.var_name,
            const.ENV.AUTODIST_UNROLL.var_type,
            const.ENV.AUTODIST_UNROLL.default) == (
        jconst.ENV.AUTODIST_UNROLL.var_name,
        jconst.ENV.AUTODIST_UNROLL.var_type,
        jconst.ENV.AUTODIST_UNROLL.default)
    monkeypatch.setenv("AUTODIST_UNROLL", "4")
    r = _runner()
    state, m = r.run(r.create_state(), iter(_batches(8)), 8)
    assert tuple(m["loss"].shape) == (4,) and int(state.step) == 8
    state, m = r.run(state, iter(_batches(2)), 2, unroll=1)
    assert tuple(m["loss"].shape) == () and int(state.step) == 10


# -- make_callable(aot=True) --------------------------------------------------


def test_aot_step_matches_jax_aot_over_three_calls():
    batches = _batches(3)
    jr = _jrunner()
    jfn = jr.make_callable(batches[0], aot=True)
    js = jr.create_state()
    want_losses = []
    for b in batches:
        js, jm = jfn(js, jr.remapper.shard_batch(b))
        want_losses.append(float(jm["loss"]))

    r = _runner()
    fn = r.make_callable(batches[0], aot=True)
    s = r.create_state()
    losses = []
    for b in batches:
        s, m = fn(s, r.remapper.shard_batch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    for k, want in _params(js).items():
        np.testing.assert_allclose(_params(s)[k], want, rtol=RTOL, atol=ATOL)
    assert int(s.step) == 3

    x, y = batches[0]
    with pytest.raises(ValueError, match="specialized on the example"):
        fn(s, (x[:16], y[:16]))
    with pytest.raises(ValueError, match="specialized on the example"):
        fn(s, (x.astype(np.float64), y))
    with pytest.raises(ValueError, match="structure"):
        fn(s, [x, y, y])
    with pytest.raises(RuntimeError, match="captured over"):
        fn(r.create_state(), batches[0])
    s, _ = fn(s, batches[1])   # still bound to its own state
    assert int(s.step) == 4


def _fake_replay(self):
    """A CUDA graph's replay, emulated on the CPU: the first call keeps
    ``fn``'s outputs as the static outputs, every later call overwrites
    them in place and hands the same tensors back."""
    out = self.fn()
    if self.outputs is None:
        self.outputs = out
    else:
        for a, b in zip(leaves(self.outputs), leaves(out)):
            a.copy_(b)
        self.replays += 1
    return self.outputs


@pytest.mark.parametrize("path", ["aot", "megastep"])
def test_metrics_of_a_call_survive_the_next_call(path, monkeypatch):
    monkeypatch.setattr(cuda_graph.Graph, "__call__", _fake_replay)
    r = _runner()
    state = r.create_state()
    batches = _batches(4)
    if path == "aot":
        fn = r.make_callable(batches[0], aot=True)
        calls = [functools.partial(fn, batch=b) for b in batches[:2]]
    else:
        calls = [functools.partial(r.megastep, block=r._next_block(
            iter(batches[i:i + 2]), 2)) for i in (0, 2)]
    state, first = calls[0](state)
    kept = {k: v.clone() for k, v in first.items()}
    state, second = calls[1](state)
    for k in kept:
        assert torch.equal(first[k], kept[k]), k
        assert first[k].data_ptr() != second[k].data_ptr()
    assert not torch.equal(first["loss"], second["loss"])


def test_optimizers_are_made_capturable_or_refused():
    p = torch.zeros(3, requires_grad=True)
    adam = torch.optim.Adam([p], lr=1e-3)
    p.grad = torch.ones(3)
    adam.step()   # an eager step first: state["step"] exists
    runner_mod._make_capturable(adam, torch.device("cuda"))
    assert adam.param_groups[0]["capturable"] is True
    assert adam.state[p]["step"].device == p.device
    cpu_adam = torch.optim.AdamW([p], lr=1e-3)
    runner_mod._make_capturable(cpu_adam, torch.device("cpu"))
    assert cpu_adam.param_groups[0]["capturable"] is False
    runner_mod._make_capturable(torch.optim.SGD([p], lr=0.1),
                                torch.device("cuda"))
    with pytest.raises(ValueError, match="Adagrad cannot be captured"):
        runner_mod._make_capturable(torch.optim.Adagrad([p]),
                                    torch.device("cuda"))
    r = _runner(functools.partial(torch.optim.Adagrad, lr=0.1))
    fn = r.make_callable(_batches(1)[0], aot=True)
    with pytest.raises(ValueError, match="Adagrad cannot be captured"):
        fn(r.create_state(), _batches(1)[0])


@pytest.mark.parametrize("k", [None, 2])
def test_a_graph_step_on_cuda_over_gloo_raises_naming_nccl(k, monkeypatch):
    """A graph step (``make_callable(aot=True)``: k None; ``megastep``: k
    2) on a CUDA device whose process groups are gloo's raises
    ``RuntimeError`` naming gloo and NCCL when it is built, before any
    step runs (a CUDA graph cannot capture gloo's host-staged
    collectives). The runner's one-rank world here is gloo's; its device
    is made to read CUDA. On the CPU the same runner's graph step runs."""
    runner = _runner()
    batch = _batches(1)[0]
    example = batch if k is None else tuple(np.stack([a] * k)
                                            for a in batch)
    assert runner.process_groups()
    monkeypatch.setattr(runner_mod.Remapper, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError, match="needs NCCL") as got:
        runner_mod._GraphStep(runner, example, k)
    assert "gloo group" in str(got.value)
    assert "eager step" in str(got.value)
    monkeypatch.undo()
    step = runner.make_callable(batch, aot=True)
    state, metrics = step(runner.create_state(), batch)
    assert np.isfinite(float(metrics["loss"]))
    runner_mod.require_nccl(runner.process_groups(), "cpu")


# -- remapper: shard_block and fetch ----------------------------------------


def _eight_device_program(tmp_path):
    """A program over a one-process mesh of 8 CPU devices (the JAX test
    mesh's shape), data axis 8."""
    from autodist_tpu_torch.cluster import Cluster
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.resource_spec import ResourceSpec
    spec_file = tmp_path / "spec.yml"
    spec_file.write_text("nodes:\n  - address: localhost\n"
                         "    cpus: [0, 1, 2, 3, 4, 5, 6, 7]\n")
    spec = ResourceSpec(str(spec_file))
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(_loss, {k: torch.from_numpy(v) for k, v in
                              _weights().items()},
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=_batches(1)[0])
    cluster = Cluster(spec)
    cluster.build_mesh()
    return GraphTransformer(AllReduce().build(item, spec), cluster,
                            item).transform()


def test_shard_block_places_blocks_and_checks_dim_one(tmp_path):
    from autodist_tpu_torch.remapper import Remapper
    remapper = _runner().remapper
    block = (np.arange(4 * 16 * 8, dtype=np.float32).reshape(4, 16, 8),
             np.ones((4, 16), np.int32))
    placed = remapper.shard_block(block)
    for got, want in zip(placed, block):
        assert isinstance(got, torch.Tensor) and got.device == \
            remapper.device
        np.testing.assert_array_equal(got.numpy(), want)
    # On a data axis of 8, dim 0 is the step: 3 steps of 8 rows divide,
    # 8 steps of 3 rows do not.
    remapper = Remapper(_eight_device_program(tmp_path))
    with pytest.raises(NotImplementedError, match="one process drives"):
        remapper.shard_block((np.zeros((3, 8, 2), np.float32),))  # placing
    with pytest.raises(ValueError, match="global batch 3 not divisible by "
                                         "data-axis size 8"):
        remapper.shard_block((np.zeros((8, 3, 2), np.float32),))
    jr = _jrunner()   # the JAX package's error, on its own 8-device mesh
    with pytest.raises(ValueError, match="global batch 3 not divisible by "
                                         "data-axis size 8"):
        jr.remapper.shard_block((np.zeros((8, 3, 8), np.float32),
                                 np.zeros((8, 3, 4), np.float32)))


def test_fetch_passes_cpu_leaves_through():
    r = _runner()
    t = torch.arange(4.0)
    out = r.remapper.fetch({"a": t, "b": [3, "x"]})
    assert out["a"] is t and out["b"] == [3, "x"]


# -- flash-attention launches under a capture --------------------------------


def test_flash_launches_count_per_replay_not_at_capture(monkeypatch):
    """The wrappers' counting path with the kernel call faked out: a
    launch during a capture goes to that graph's count, each replay adds
    the count, and outside a capture a launch counts at once."""
    capturing = {"on": True, "stream": 7}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(
                            cuda_stream=capturing["stream"]))
    monkeypatch.setattr(fa, "_kernel_fn", lambda *a: None)
    monkeypatch.setattr(fa, "_call", lambda *a: 0)
    for k in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        monkeypatch.setattr(k, "launches", 0)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, 2, 8, 16, generator=gen) for _ in range(4))
    lse = delta = torch.zeros(1, 2, 8, 1)

    def launch_all():
        fa._launch(q, k, v, False, 0, 0, torch.float32, False)
        fa._launch_bwd(fa.flash_bwd_dq, "autodist_flash_bwd_dq",
                       (torch.empty_like(q),), q, k, v, do, lse, delta,
                       False, 0, 0)
        fa._launch_bwd(fa.flash_bwd_dkv, "autodist_flash_bwd_dkv",
                       (torch.empty_like(k), torch.empty_like(v)), q, k, v,
                       do, lse, delta, False, 0, 0)

    with cuda_graph.recording_launches(7) as counts:
        launch_all()
        launch_all()
        capturing["stream"] = 8   # another stream's capture: no Graph's
        launch_all()
    assert counts == {fa.flash_fwd: 2, fa.flash_bwd_dq: 2,
                      fa.flash_bwd_dkv: 2}
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (0, 0, 0)

    graph = cuda_graph.Graph(lambda: None, "cuda")   # replays faked too
    graph.graph = types.SimpleNamespace(replay=lambda: None)
    graph.launches = counts
    for _ in range(3):
        graph()
    assert graph.replays == 3
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (6, 6, 6)
    capturing["on"] = False   # eager launches count as before
    launch_all()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (7, 7, 7)


# -- serving through the bucket graphs' plain path ---------------------------


def test_serving_answers_come_from_the_bucket_path_and_stay_owned():
    cfg = bert.bert_tiny()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")

    def apply(p, b):
        return T.encode(p, cfg, b[0], segment_ids=b[1])

    rng = np.random.RandomState(3)

    def request(rows):
        return (rng.randint(0, cfg.vocab, (rows, 16)).astype(np.int32),
                rng.randint(0, 2, (rows, 16)).astype(np.int32))

    srv = serve.Server(apply, params, request(8), buckets=(4, 8),
                       max_wait_ms=0, device="cpu")
    try:
        replica = srv.engine.replicas[0]
        assert replica.buckets_compiled == [4, 8]
        answers, kept = [], []
        for rows in (3, 8, 1, 4):
            req = request(rows)
            out = srv.infer(req, timeout=60)
            bucket = 4 if rows <= 4 else 8
            padded = [np.zeros((bucket, 16), np.int32) for _ in range(2)]
            for buf, leaf in zip(padded, req):
                buf[:rows] = leaf
            with torch.inference_mode():
                want = apply(params, [torch.from_numpy(a) for a in padded])
            assert torch.equal(out, want[:rows])   # bitwise, same shapes
            answers.append(out)
            kept.append(out.clone())
        for out, was in zip(answers, kept):   # later dispatches wrote none
            assert torch.equal(out, was)
        assert all(not g.captured and g.replays == 0   # no card: no graph
                   for g in (replica.compile_bucket(b, None)
                             for b in replica.buckets_compiled))
        with pytest.raises(ValueError, match="matches no warmed bucket"):
            replica.run_bucket(tuple(torch.zeros((2, 16), dtype=torch.int32)
                                     for _ in range(2)))
    finally:
        srv.close()


def _graph_owners(kind):
    """(owner, [the graphs it dropped]) after one use: a runner with a
    megastep graph and an ``aot=True`` step, or a serving replica with two
    buckets, closed with its server."""
    if kind == "runner":
        runner = _runner()
        batch = _batches(1)[0]
        state, _ = runner.run(runner.create_state(), iter(lambda: batch,
                                                          None), 4, unroll=2)
        step = runner.make_callable(batch, aot=True)
        step(state, batch)
        steps = list(runner._graphs.values()) + [step]
        return runner, steps + [g for s in steps for g in s.graphs.values()]
    cfg = bert.bert_tiny()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    request = (np.zeros((4, 16), np.int32), np.zeros((4, 16), np.int32))
    with serve.Server(lambda p, b: T.encode(p, cfg, b[0], segment_ids=b[1]),
                      params, request, buckets=(2, 4), max_wait_ms=0,
                      device="cpu") as srv:
        srv.infer(request, timeout=60)
        replica = srv.engine.replicas[0]
        graphs = [replica.compile_bucket(b, None)
                  for b in replica.buckets_compiled]
    assert replica.buckets_compiled == []
    return None, graphs


# A fresh process builds its first runner with the cyclic collector off and
# prints whether every graph owner died with the last reference to it.
_FIRST_RUNNER = r'''
import gc, json, sys, weakref
sys.path.insert(0, sys.argv[1])
import test_torch_graph as t
gc.disable()
owner, graphs = t._graph_owners("runner")
refs = [weakref.ref(o) for o in [owner] + graphs]
del owner, graphs
t.autodist_mod._reset_default()
print(json.dumps([r() is None for r in refs]))
'''


@pytest.mark.parametrize("kind", ["runner", "replica", "first_runner"])
def test_dropped_owners_free_their_graphs_without_the_collector(kind):
    """A graph's function refers to its owner weakly (``cuda_graph.
    weak_call``), and a closed serving replica releases its bucket graphs,
    so a dropped runner's graphs and a closed server's, and on the card
    their memory pools, are freed by reference counting alone: a later
    capture does not run out of memory behind a reference cycle that the
    cyclic collector has not reached yet. ``first_runner``: the first
    runner of a fresh process, whose capture is the first to import
    torch's lazily imported modules (in a subprocess, so that this
    worker's earlier tests cannot have imported them already)."""
    import gc
    import os
    import subprocess
    import sys
    import weakref
    if kind == "first_runner":
        tests = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.path.dirname(tests),
                   OMP_NUM_THREADS="1")
        env = {k: v for k, v in env.items()
               if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_"))}
        done = subprocess.run([sys.executable, "-c", _FIRST_RUNNER, tests],
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert done.returncode == 0, done.stderr[-3000:]
        freed = json.loads(done.stdout.strip().splitlines()[-1])
        assert len(freed) >= 2 and all(freed), freed
        return
    autodist_mod._reset_default()
    gc.collect()
    gc.disable()
    try:
        owner, graphs = _graph_owners(kind)
        refs = [weakref.ref(o) for o in [owner] * (owner is not None) +
                graphs]
        del owner, graphs
        autodist_mod._reset_default()
        assert len(refs) >= 2 and all(r() is None for r in refs)
    finally:
        gc.enable()
