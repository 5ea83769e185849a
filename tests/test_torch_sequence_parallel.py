"""``SequenceParallel`` in the port against the JAX package, on the CPU.

* The builder's proto equals the JAX builder's (``graph_config.mesh_axes``
  with the ``seq`` axis carved out of ``data``, ``seq_attn``, and the base
  builder's node configs), and ``AUTODIST_STRATEGY=sequence_parallel``
  resolves to it in ``AutoDist`` and builds.
* One 4-rank gloo world (one subprocess per rank, ``OMP_NUM_THREADS=1``)
  trains ``lm_tiny`` (the fixture of ``tests/test_strategy_parallel.py``:
  2 layers, 8 x 16 tokens, SGD 0.1, 3 steps) through ``AutoDist`` ->
  ``Runner.step`` under ``SequenceParallel("ring")`` and
  ``SequenceParallel("ulysses")`` on a ``{data: 2, seq: 2}`` mesh (each
  data replica's 4 rows to both of its seq ranks, each rank computing its
  half of the sequence) and under ``AllReduce()`` on ``{data: 4}``. The
  losses match the JAX package's ``SequenceParallel`` run on its 8-device
  ``{data: 4, seq: 2}`` mesh and the port's ``AllReduce`` run at rtol
  1e-5 (f32, other summation orders), and the ranks' params agree
  bitwise. The graph paths (``make_callable(aot=True)``, ``megastep``,
  ``run(unroll=2)``) are bitwise the eager steps and match the JAX
  package's compiled step. A seq group fed two batches raises, at the
  graph paths' first call too, so does a sequence the seq axis does not
  divide (BERT's masked-LM loss under a seq axis trains:
  ``tests/test_torch_composed.py``). ``Mesh.group_over`` builds the
  data x seq group of a mesh with a third axis, and the seq group of a
  ``{pipe, seq}`` mesh.
"""
import fcntl
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import resource_spec as jrs
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.models import lm as jlm
from autodist_tpu_torch import AutoDist, convert, strategy
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.registry import builder_from_name
from test_torch_ps_strategies import (GRAPH_PATHS, held_graph_paths,
                                      jax_graph_paths)

WORLD = 4
STEPS = 3
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _reset_singletons():
    autodist_mod._reset_default()
    _jreset()
    yield
    autodist_mod._reset_default()
    _jreset()


def _lm_fixture():
    """tests/test_strategy_parallel.py's ``_lm_fixture(num_layers=2,
    seq_len=16)``: (cfg, JAX params, JAX loss, tokens (8, 17))."""
    cfg = jlm.lm_tiny(max_len=16)
    cfg.num_layers = 2
    params = jlm.init(jax.random.PRNGKey(0), cfg)
    batch = jlm.synthetic_batch(cfg, batch_size=8, seq_len=16)
    return cfg, params, jlm.make_loss_fn(cfg), batch


def _spec_text(n):  # tests/test_torch_ps_strategies.py's
    return ("nodes:\n  - address: 10.0.0.1\n    gpus: [" +
            ", ".join(str(i) for i in range(n)) + "]\n    chief: true\n")


# -- the builder --------------------------------------------------------------


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sequence_parallel_proto_matches_jax(tmp_path, attn, devices):
    """The whole proto, ids aside (``tests/test_strategy_parallel.py:
    129-135`` and the base builder's node configs)."""
    from autodist_tpu.graph_item import GraphItem as JGraphItem
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.models import lm
    cfg, params, loss_fn, batch = _lm_fixture()
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    params = jax.device_get(params)
    jitem = JGraphItem.capture(loss_fn, params, optax.sgd(0.1),
                               example_batch=batch)
    item = GraphItem.capture(lm.make_loss_fn(lm.lm_tiny(max_len=16)),
                             convert.params_from_jax(params, "cpu"), None,
                             example_batch=batch)
    want = jstrategy.SequenceParallel(attn=attn, seq_axis=2).build(
        jitem, jrs.ResourceSpec(str(path)))
    got = strategy.SequenceParallel(attn=attn, seq_axis=2).build(
        item, ResourceSpec(str(path)))
    assert dict(got.graph_config.mesh_axes) == {"data": devices // 2,
                                                "seq": 2}
    assert got.graph_config.seq_attn == attn
    assert len(got.node_config) == len(want.node_config) > 0
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()
    with pytest.raises(ValueError, match="does not divide"):
        strategy.SequenceParallel(seq_axis=3).build(item,
                                                    ResourceSpec(str(path)))


def test_sequence_parallel_name_resolves_and_builds(monkeypatch, tmp_path):
    from autodist_tpu.tuner.auto import builder_from_name as jfrom_name
    monkeypatch.setenv("AUTODIST_STRATEGY", "sequence_parallel")
    ad = AutoDist(device="cpu")
    assert isinstance(ad._strategy_builder, strategy.SequenceParallel)
    assert type(jfrom_name("sequence_parallel")).__name__ == \
        "SequenceParallel"
    assert isinstance(builder_from_name("SequenceParallel"),
                      strategy.SequenceParallel)
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(4))
    from autodist_tpu_torch.graph_item import GraphItem
    item = GraphItem.capture(lambda p, b: (p["w"] * b).sum(),
                             {"w": torch.zeros(3)}, None,
                             example_batch=np.zeros((2, 3), np.float32))
    built = ad._strategy_builder.build(item, ResourceSpec(str(path)))
    assert dict(built.graph_config.mesh_axes) == {"data": 2, "seq": 2}
    assert built.graph_config.seq_attn == "ring"


def test_parallel_context_refuses_what_is_not_ported():
    from autodist_tpu_torch.parallel.context import ParallelContext
    # The pipeline is ported: its count and schedule are kept.
    ctx = ParallelContext(None, pipeline_microbatches=2,
                          pipeline_schedule="1f1b")
    assert (ctx.pipeline_microbatches, ctx.pipeline_schedule) == (2, "1f1b")
    with pytest.raises(NotImplementedError, match="item 12"):
        ParallelContext(None, op_shardings={"a": "data"})
    assert ParallelContext(None, seq_attn="ring").attn_fn(True) is None


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    params, tokens, steps = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
cfg = lm.lm_tiny(max_len=16)
res = {}


def named(tree):
    return {path_to_name(p): t.detach().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}
#GRAPH_PATHS


def session(builder, loss_fn, params, example):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=example)
    return ad.create_distributed_session(item)


def rows(runner, batch):
    mesh = runner.program.mesh
    n = mesh.shape["data"]
    per = batch.shape[0] // n
    d = mesh.axis_index("data")
    return batch[d * per:(d + 1) * per]


def train(builder):
    runner = session(builder, lm.make_loss_fn(cfg), params, (tokens[:2],))
    mine = rows(runner, tokens)
    state = runner.create_state()
    losses = []
    for _ in range(steps):
        state, m = runner.step(state, (mine,))
        losses.append(float(m["loss"]))
    named = {path_to_name(p): t.detach().numpy().copy()
             for p, t in flatten_with_path(state.params)[0]}
    return {"losses": losses, "params": named,
            "mesh": dict(runner.program.mesh.shape)}


def raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None


for attn in ("ring", "ulysses"):
    res[attn] = train(S.SequenceParallel(attn=attn, seq_axis=2))
res["allreduce"] = train(S.AllReduce())

runner = session(S.SequenceParallel(attn="ring", seq_axis=2),
                 lm.make_loss_fn(cfg), params, (tokens[:2],))
state = runner.create_state()
mine = rows(runner, tokens)
other = (mine + 1 + runner.program.mesh.axis_index("seq")) % cfg.vocab
res["mismatch"] = raises(lambda: runner.step(state, (other,)))
res["indivisible"] = raises(lambda: runner.step(state, (mine[:, :16],)))
res["graph_mismatch"] = first_call_raises(runner, (other,))
res["graph_ring"] = graph_paths(runner, [(mine,)] * 4)
runner = session(S.SequenceParallel(attn="ulysses", seq_axis=2),
                 lm.make_loss_fn(cfg), params, (tokens[:2],))
res["graph_ulysses"] = graph_paths(runner, [(rows(runner, tokens),)] * 4)
autodist_mod._reset_default()

# The data x seq group of a mesh with a third axis: the ranks that share
# this rank's place on it.
from torch.distributed.device_mesh import init_device_mesh
from autodist_tpu_torch.cluster import Mesh
names = ("data", "seq", "model")
mesh = Mesh(np.arange(world).reshape(1, 2, 2), names,
            device_mesh=init_device_mesh("cpu", (1, 2, 2),
                                         mesh_dim_names=names),
            local_device=torch.device("cpu"))
res["group_over"] = [
    sorted(dist.get_process_group_ranks(mesh.group_over(axes)))
    for axes in (("data", "seq"), ("seq", "model"), ("seq",))]
names = ("data", "pipe", "seq")
mesh = Mesh(np.arange(world).reshape(1, 2, 2), names,
            device_mesh=init_device_mesh("cpu", (1, 2, 2),
                                         mesh_dim_names=names),
            local_device=torch.device("cpu"))
res["group_over_pipe"] = [
    sorted(dist.get_process_group_ranks(mesh.group_over(axes)))
    for axes in (("data", "seq"), ("data", "pipe"), ("pipe", "seq"),
                 ("seq",), ("pipe",))]
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''.replace("#GRAPH_PATHS", GRAPH_PATHS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's cases, run once per test session (the first xdist
    worker to need them runs them under a file lock): {case: [rank 0's
    result, ...]}."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "sp_world"
    with open(shared / "sp_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            _, params, _, batch = _lm_fixture()
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump((convert.params_from_jax(
                    jax.device_get(params), "cpu"), batch[0], STEPS), f)
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


def _jax_losses(builder):
    """tests/test_strategy_parallel.py's ``_losses`` over STEPS steps on
    the JAX package's 8-device mesh."""
    _, params, loss_fn, batch = _lm_fixture()
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    item = ad.capture(loss_fn, params, optax.sgd(0.1), example_batch=batch)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    out = []
    for _ in range(STEPS):
        state, metrics = runner.step(state, batch)
        out.append(float(jax.device_get(metrics["loss"])))
    return out


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_lm_tiny_trains_under_sequence_parallel_like_jax(world, attn):
    ranks = world[attn]
    want = _jax_losses(jstrategy.SequenceParallel(attn=attn, seq_axis=2))
    ar = world["allreduce"][0]
    assert ar["mesh"] == {"data": 4}
    for r, res in enumerate(ranks):
        assert res["mesh"] == {"data": 2, "seq": 2}
        np.testing.assert_allclose(res["losses"], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["losses"], ar["losses"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        for name, t in res["params"].items():
            np.testing.assert_array_equal(t, ranks[0]["params"][name])
            np.testing.assert_allclose(t, ar["params"][name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    assert want[-1] < want[0]


def test_allreduce_on_four_gloo_ranks_matches_jax(world):
    want = _jax_losses(jstrategy.AllReduce())
    for res in world["allreduce"]:
        np.testing.assert_allclose(res["losses"], want, rtol=RTOL, atol=ATOL)


def test_a_seq_group_fed_two_batches_raises(world):
    for r, got in enumerate(world["mismatch"]):
        assert got is not None and got[0] == "ValueError", (r, got)
        assert "different batches" in got[1]


def test_a_sequence_the_seq_axis_does_not_divide_raises(world):
    for got in world["indivisible"]:
        assert got is not None and got[0] == "ValueError", got
        assert "not divisible by the seq axis" in got[1]


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_graph_paths_under_a_seq_axis_match_step_and_jax(world, attn):
    """``make_callable(aot=True)``, ``megastep`` and ``run(unroll=2)``
    under ``SequenceParallel(attn)`` on ``{data: 2, seq: 2}`` (on the CPU
    the graph's function runs directly, over its static buffers): bitwise
    the eager steps, and held to the JAX package's compiled step (its jit
    step: under a seq axis its AOT executable and megastep fail on this
    jaxlib) over the same 4 steps at the eager parity's tolerance."""
    _, params, loss_fn, batch = _lm_fixture()
    _jreset()
    ad = JAutoDist(strategy_builder=jstrategy.SequenceParallel(
        attn=attn, seq_axis=2))
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, optax.sgd(0.1), example_batch=batch))
    want = jax_graph_paths(runner, [batch] * 4, aot=False, megastep=False)
    held_graph_paths(world["graph_" + attn], want, RTOL, ATOL)


def test_a_seq_group_fed_two_batches_raises_at_the_graph_first_call(world):
    """The graph paths check the batch once, at their first call (the
    check's all-gathers and host read cannot sit in a graph)."""
    for r, got in enumerate(world["graph_mismatch"]):
        assert got is not None and got[0] == "ValueError", (r, got)
        assert "seq group were fed different batches" in got[1]


def test_group_over_gives_the_ranks_that_share_the_other_axes(world):
    """``Mesh.group_over`` on {data: 1, seq: 2, model: 2} (rank = 2 x seq
    + model): data x seq is a new group per model coordinate, seq x model
    the world, seq alone the mesh's seq group. On {data: 1, pipe: 2, seq:
    2} (rank = 2 x pipe + seq): data x seq and seq are the ranks of this
    rank's stage, data x pipe and pipe those of its chunk (the JAX mesh's
    layout: ``seq`` inner), pipe x seq the world."""
    for rank, got in enumerate(world["group_over"]):
        model = rank % 2
        assert got == [[model, 2 + model], [0, 1, 2, 3],
                       [model, 2 + model]], (rank, got)
    for rank, got in enumerate(world["group_over_pipe"]):
        pipe, seq = divmod(rank, 2)
        stage, chunk = [2 * pipe, 2 * pipe + 1], [seq, 2 + seq]
        assert got == [stage, chunk, [0, 1, 2, 3], stage, chunk], (rank,
                                                                   got)
