"""``ModelParallel`` (tensor parallelism) in the port against the JAX package.

* The builder's proto equals the JAX builder's (``graph_config.mesh_axes``
  with the ``model`` axis carved out of ``data``, and every node's
  partitioner) for AllReduce, PS and Parallax bases on ``lm_tiny`` and
  ``bert_tiny``, for custom rules, at model axes of 2 and 4 and where the
  axis divides no dim. ``model_parallel`` resolves in ``AutoDist`` and in
  serving; a serving engine of two replicas refuses the builder
  ("data-only"). (``mesh_axis="expert"``: ``tests/test_torch_moe.py``.)
* One 4-rank gloo world (subprocesses, ``OMP_NUM_THREADS=1``) on a
  ``{data: 2, model: 2}`` mesh, each data replica's rows to both ranks of
  its model group:

  - ``lm_tiny`` under ``ModelParallel(AllReduce())`` (SGD 0.1, 3 steps),
    ``bert_tiny`` MLM under ``ModelParallel(PS())`` (Adam 1e-3, eps 1e-6,
    3 steps) and the user MLP of ``tests/test_composition.py`` under
    ``ModelParallel(rules=(("w1", 1), ("w2", 0)), base=PS())`` (SGD 0.05)
    are held to the JAX package's ``ModelParallel`` runs on its 8-device
    mesh at rtol 1e-4, atol 1e-5 (the JAX test's own tolerance against
    one device);
  - three planted faults, monkeypatched into the ranks' modules, each read
    above that tolerance: the gathered gradient left undivided by the
    model size, the copy-to-model backward all-reduce dropped, and the
    row-parallel bias added before the reduce;
  - replicated parameters are bitwise equal across the model group, the
    pieces differ, also when each model rank's gradient of a whole
    parameter is shifted by its own amount (as the card's scatter-add
    atomics shift it): the whole parameters' gradients average over data
    x model, and averaged over data alone (a fourth planted fault) the
    copies part;
  - the graph paths (``make_callable(aot=True)``, ``megastep``,
    ``run(unroll=2)``) of the lm and bert runs are bitwise their eager
    steps and match the JAX package's ``aot=True`` step and megastep;
  - a model group fed two batches raises (at the graph paths' first call
    too), so does a non-elementwise optimizer on a piece (``{seq, model}``
    trains: ``tests/test_torch_composed.py``); the model axis not dividing
    the heads gathers the attention weights and trains as AllReduce does;
  - the TP world's checkpoint restores bitwise on one rank and its
    manifest's params entries are the JAX manifest's; a one-rank
    checkpoint restores into the TP world bitwise;
  - ``Mesh.group("model")`` gives the JAX mesh layout's ranks.
"""
import fcntl
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import resource_spec as jrs
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.checkpoint import manifest as jmanifest
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.graph_item import path_to_name as jpath_to_name
from autodist_tpu_torch import AutoDist, convert, strategy
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.checkpoint import manifest as manifest_mod
from autodist_tpu_torch.checkpoint.saver import read_tree
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.models import bert, lm
from autodist_tpu_torch.parallel.sharding_rules import (MEGATRON_RULES,
                                                        megatron_pieces)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve import engine
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
from test_torch_ps_strategies import (GRAPH_PATHS, held_graph_paths,
                                      jax_graph_paths)

WORLD = 4
STEPS = 3
RTOL, ATOL = 1e-4, 1e-5
MLP_RULES = (("w1", 1), ("w2", 0))


@pytest.fixture(autouse=True)
def _reset_singletons():
    autodist_mod._reset_default()
    _jreset()
    yield
    autodist_mod._reset_default()
    _jreset()


def _spec_text(n):  # tests/test_torch_ps_strategies.py's
    return ("nodes:\n  - address: 10.0.0.1\n    gpus: [" +
            ", ".join(str(i) for i in range(n)) + "]\n    chief: true\n")


def _lm_fixture():
    """``tests/test_parallel.py``'s TP fixture: (cfg, JAX params, JAX loss,
    tokens (8, 17))."""
    cfg = jlm.lm_tiny(max_len=16)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    return cfg, params, jlm.make_loss_fn(cfg), \
        jlm.synthetic_batch(cfg, batch_size=8, seq_len=16)


def _mlp_fixture():
    """``tests/test_composition.py::test_zero1_composes_with_tensor_
    parallel``'s MLP: numpy params and three (x (16, 16), y (16, 4))
    batches."""
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(16, 32).astype(np.float32) * 0.1,
              "w2": rng.randn(32, 4).astype(np.float32) * 0.1}
    batches = [(rng.randn(16, 16).astype(np.float32),
                rng.randn(16, 4).astype(np.float32)) for _ in range(3)]
    return params, batches


def _jmlp_loss(p, batch):
    x, y = batch
    return jnp.mean((jax.nn.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)


def _mlp_loss(p, batch):
    x, y = batch
    return torch.mean((torch.relu(x @ p["w1"]) @ p["w2"] - y) ** 2)


# -- the builder --------------------------------------------------------------


def _items(model):
    """(JAX GraphItem, port GraphItem) of one model, captured alike."""
    from autodist_tpu.graph_item import GraphItem as JGraphItem
    if model == "lm_tiny":
        cfg, params, loss_fn, batch = _lm_fixture()
        port_loss = lm.make_loss_fn(lm.lm_tiny(max_len=16))
    elif model == "bert_tiny":
        params, loss_fn, batch = jbert.tiny_fixture(seed=0)
        params = jax.device_get(params)
        port_loss = bert.make_loss_fn(bert.bert_tiny())
    else:
        params, batches = _mlp_fixture()
        loss_fn, port_loss, batch = _jmlp_loss, _mlp_loss, batches[0]
    jitem = JGraphItem.capture(loss_fn, params, optax.sgd(0.1),
                               example_batch=batch)
    item = GraphItem.capture(port_loss, convert.params_from_jax(params,
                                                                "cpu"),
                             None, example_batch=batch)
    return jitem, item


@pytest.mark.parametrize("devices,axis", [(8, 2), (8, 4), (6, 3)])
@pytest.mark.parametrize("base", ["AllReduce", "PS", "Parallax"])
@pytest.mark.parametrize("model", ["lm_tiny", "bert_tiny"])
def test_model_parallel_proto_matches_jax(tmp_path, model, base, devices,
                                          axis):
    """The whole proto, ids aside: the carved mesh and every node's
    partitioner (``"<dim>:<axis>:model"`` where the axis divides the dim;
    at 3 none does, and every variable stays whole)."""
    jitem, item = _items(model)
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    want = jstrategy.ModelParallel(getattr(jstrategy, base)(),
                                   model_axis=axis).build(
        jitem, jrs.ResourceSpec(str(path)))
    got = strategy.ModelParallel(getattr(strategy, base)(),
                                 model_axis=axis).build(
        item, ResourceSpec(str(path)))
    assert dict(got.graph_config.mesh_axes) == {"data": devices // axis,
                                                "model": axis}
    split = {n.var_name: n.partitioner for n in got.node_config
             if n.partitioner.endswith(":model")}
    if axis == 3:
        assert not split
    else:
        assert split["embed/embedding"] == f"1:{axis}:model"
        assert split["layer0/attn/out/kernel"] == f"0:{axis}:model"
        assert "layer0/attn/out/bias" not in split
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()


def test_model_parallel_custom_rules_proto_matches_jax(tmp_path):
    jitem, item = _items("mlp")
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(8))
    want = jstrategy.ModelParallel(rules=MLP_RULES, base=jstrategy.PS()).build(
        jitem, jrs.ResourceSpec(str(path)))
    got = strategy.ModelParallel(rules=MLP_RULES, base=strategy.PS()).build(
        item, ResourceSpec(str(path)))
    assert {n.var_name: n.partitioner for n in got.node_config} == \
        {"w1": "1:2:model", "w2": "0:2:model"}
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()


def test_model_parallel_name_resolves_and_builds(monkeypatch, tmp_path):
    from autodist_tpu.tuner.auto import builder_from_name as jfrom_name
    monkeypatch.setenv("AUTODIST_STRATEGY", "model_parallel")
    ad = AutoDist(device="cpu")
    assert isinstance(ad._strategy_builder, strategy.ModelParallel)
    assert isinstance(engine._resolve_serve_builder(None),
                      strategy.ModelParallel)
    assert type(jfrom_name("model_parallel")).__name__ == "ModelParallel"
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(4))
    _, item = _items("lm_tiny")
    built = ad._strategy_builder.build(item, ResourceSpec(str(path)))
    assert dict(built.graph_config.mesh_axes) == {"data": 2, "model": 2}


def test_serving_two_replicas_refuses_model_parallel(tmp_path):
    """``tests/test_serve.py::test_multi_replica_rejects_model_parallel_
    strategy``: a replica must hold whole params."""
    path = tmp_path / "spec.yml"
    path.write_text("nodes:\n  - address: localhost\n    cpus: [0, 1]\n")
    params = {"w": torch.ones(8, 4)}
    with pytest.raises(ValueError, match="data-only"):
        engine.ServeEngine(lambda p, b: b @ p["w"], params,
                           np.zeros((8, 8), np.float32), (8,),
                           resource_spec=str(path),
                           strategy_builder=strategy.ModelParallel(
                               strategy.AllReduce(), model_axis=2),
                           replicas=2, device="cpu")


@pytest.mark.parametrize("split,want", [
    ({}, set()),
    ({"l/attn/query/kernel": 1, "l/attn/key/kernel": 1,
      "l/attn/value/kernel": 1, "l/attn/out/kernel": 0},
     {"l/attn/query/kernel", "l/attn/key/kernel", "l/attn/value/kernel",
      "l/attn/out/kernel"}),
    ({"l/attn/query/kernel": 1, "l/attn/key/kernel": 1,
      "l/attn/value/kernel": 1}, set()),
    ({"l/attn/query/kernel": 1, "l/attn/key/kernel": 1,
      "l/attn/value/kernel": 1, "l/attn/out/kernel": 1}, set()),
    ({"l/mlp/up/kernel": 1, "l/mlp/down/kernel": 0, "embed/embedding": 1},
     {"l/mlp/up/kernel", "l/mlp/down/kernel"})])
def test_megatron_pieces_take_a_whole_scope_on_its_rule_dims(split, want):
    """A scope's weights reach the Megatron layer as pieces only when every
    weight a layer rule names in it is split on that rule's dim; anything
    else (the embedding table, a half-split scope) is gathered."""
    names = ["l/attn/query/kernel", "l/attn/key/kernel",
             "l/attn/value/kernel", "l/attn/out/kernel", "l/attn/out/bias",
             "l/mlp/up/kernel", "l/mlp/down/kernel", "embed/embedding"]
    assert megatron_pieces(names, split) == want
    assert MEGATRON_RULES[-1] == (r"embed/embedding$", 1)


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.models import bert, layers, lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.parallel import collectives
from autodist_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                           path_to_name)

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
res = {}
SGD = lambda lr: functools.partial(torch.optim.SGD, lr=lr)


def named(tree):
    return {path_to_name(p): t.detach().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}
#GRAPH_PATHS


def session(builder, loss_fn, params, opt, example):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(loss_fn, params, opt, example_batch=example)
    return ad.create_distributed_session(item)


def rows(runner, batch):
    mesh = runner.program.mesh
    per = len(batch[0]) // mesh.shape["data"]
    d = mesh.axis_index("data")
    return tuple(a[d * per:(d + 1) * per] for a in batch)


def train(builder, loss_fn, params, opt, batches, prepare=None):
    runner = session(builder, loss_fn, params, opt,
                     tuple(a[:2] for a in batches[0]))
    if prepare is not None:
        prepare(runner)
    state = runner.create_state()
    losses = []
    for b in batches:
        state, m = runner.step(state, rows(runner, b))
        losses.append(float(m["loss"]))
    return runner, state, {
        "losses": losses, "params": named(runner.logical_params(state)),
        "stored": named(state.params), "kinds": runner.var_kinds,
        "mesh": dict(runner.program.mesh.shape)}


def raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None


lcfg = lm.lm_tiny(max_len=16)
lm_batches = [(inp["tokens"],)] * 3
bcfg = bert.bert_tiny()
bert_batches = [tuple(inp["bert_batch"])] * 3
ADAM = functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6)


def lm_run():
    return train(S.ModelParallel(S.AllReduce(), model_axis=2),
                 lm.make_loss_fn(lcfg), inp["lm"], SGD(0.1), lm_batches)


runner, state, res["lm"] = lm_run()
res["lm"]["batch_specs"] = [tuple(s) for s in leaves(
    runner.program.batch_specs(lm_batches[0]))]
mine = rows(runner, lm_batches[0])
res["lm"]["shard_batch_whole"] = bool(torch.equal(
    runner.remapper.shard_batch(mine)[0], torch.as_tensor(mine[0])))
res["lm"]["model_group"] = sorted(dist.get_process_group_ranks(
    runner.program.mesh.group("model")))
other = (mine[0] + 1 + runner.program.mesh.axis_index("model")) % lcfg.vocab
res["mismatch"] = raises(lambda: runner.step(state, (other,)))
res["graph_mismatch"] = first_call_raises(runner, (other,))
res["graph_lm"] = graph_paths(runner, [mine] * 4)

# The planted faults.
real_backward = collectives.GatherShards.backward
real_copy = layers._CopyToModel.backward
real_dense = layers.dense


def undivided(ctx, grad):
    return (collectives.reduce_scatter(grad, ctx.dim, ctx.group), None, None,
            None)


def bias_first(p, x, dtype=None, row_group=None):
    k = p["kernel"]
    if dtype is not None:
        x, k = x.to(dtype), k.to(dtype)
    y = x @ k
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    if row_group is not None:
        y = layers._ReduceFromModel.apply(y, row_group)
    return y


for key, target, attr, fault in (
        ("undivided", collectives.GatherShards, "backward",
         staticmethod(undivided)),
        ("no_allreduce", layers._CopyToModel, "backward",
         staticmethod(lambda ctx, grad: (grad, None))),
        ("bias_first", layers, "dense", bias_first)):
    real = target.__dict__[attr]
    setattr(target, attr, fault)
    try:
        res["fault_" + key] = lm_run()[2]
    finally:
        setattr(target, attr, real)

def noisy(runner, data_only=False):
    """Model rank m's gradient of the whole ln_f/scale shifted by m x 1e-3
    (as the card's scatter-add atomics shift a whole parameter's gradient
    in its last bits); with ``data_only`` the whole parameters' gradients
    average over the data group alone."""
    real = runner._sync_gradients
    shift = 1e-3 * runner.program.mesh.axis_index("model")

    def sync(grads):
        grads["ln_f/scale"] += shift
        real(grads)
    runner._sync_gradients = sync
    if data_only:
        runner._grad_group = runner.program.mesh.group("data")


for key, data_only in (("noisy", False), ("noisy_data_only", True)):
    res[key] = train(S.ModelParallel(S.AllReduce(), model_axis=2),
                     lm.make_loss_fn(lcfg), inp["lm"], SGD(0.1), lm_batches,
                     prepare=lambda r: noisy(r, data_only))[2]

runner, state, res["bert"] = train(S.ModelParallel(S.PS(), model_axis=2),
                                   bert.make_loss_fn(bcfg), inp["bert"],
                                   ADAM, bert_batches)
mgr = CheckpointManager(runner, os.path.join(out, "tp_ckpt"))
mgr.save(STEPS, state, force=True)
mgr.wait_until_finished()
logical = runner.to_logical(state)
res["bert"]["opt_state"] = named(logical.opt_state)
res["graph_bert"] = graph_paths(runner, [rows(runner, bert_batches[0])] * 4)

# A one-rank AllReduce checkpoint restored into the TP world.
mgr = CheckpointManager(runner, inp["one_rank_ckpt"])
restored = runner.to_logical(mgr.restore_or_init())
res["restored"] = {"params": named(restored.params),
                   "opt_state": named(restored.opt_state),
                   "step": int(restored.step)}

params, batches = inp["mlp"]
mlp_loss = lambda p, b: torch.mean(
    (torch.relu(b[0] @ p["w1"]) @ p["w2"] - b[1]) ** 2)
res["mlp"] = train(S.ModelParallel(rules=(("w1", 1), ("w2", 0)),
                                   base=S.PS()), mlp_loss, params, SGD(0.05),
                   batches)[2]
res["lbfgs"] = raises(lambda: session(
    S.ModelParallel(rules=(("w1", 1), ("w2", 0))), mlp_loss, params,
    functools.partial(torch.optim.LBFGS, lr=0.1),
    tuple(a[:2] for a in batches[0])).create_state())

# The model axis (4) does not divide the 6 heads: attention gathered.
hcfg = T.TransformerConfig(vocab=64, dim=48, num_heads=6, num_layers=1,
                           max_len=16, causal=True, dtype=torch.float32)
hparams = lm.init(hcfg, torch.Generator().manual_seed(0), device="cpu")
hbatches = [(inp["tokens"] % 64,)] * 2
res["heads"] = train(S.ModelParallel(S.AllReduce(), model_axis=4),
                     lm.make_loss_fn(hcfg), hparams, SGD(0.1), hbatches)[2]
res["heads_ar"] = train(S.AllReduce(), lm.make_loss_fn(hcfg), hparams,
                        SGD(0.1), hbatches)[2]

autodist_mod._reset_default()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''.replace("STEPS", str(STEPS)).replace("#GRAPH_PATHS", GRAPH_PATHS)


def _one_rank_checkpoint(directory, params, batch):
    """A one-rank ``AllReduce()`` bert_tiny checkpoint of 2 Adam steps (the
    world restores it into its TP runner)."""
    autodist_mod._reset_default()
    try:
        ad = AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
        runner = ad.create_distributed_session(ad.capture(
            bert.make_loss_fn(bert.bert_tiny()), params,
            functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6),
            example_batch=batch))
        state = runner.create_state()
        for _ in range(2):
            state, _ = runner.step(state, batch)
        mgr = CheckpointManager(runner, directory)
        mgr.save(2, state, force=True)
        mgr.close()
    finally:
        autodist_mod._reset_default()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's cases, run once per test session (the first xdist
    worker to need them runs them under a file lock): {case: [rank 0's
    result, ...]}, and the world's directory."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "tp_world"
    with open(shared / "tp_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            _, lparams, _, tokens = _lm_fixture()
            bparams, _, bbatch = jbert.tiny_fixture(seed=0)
            bparams = convert.params_from_jax(jax.device_get(bparams), "cpu")
            mparams, mbatches = _mlp_fixture()
            _one_rank_checkpoint(out / "one_rank_ckpt", bparams, bbatch)
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({
                    "lm": convert.params_from_jax(lparams, "cpu"),
                    "tokens": torch.as_tensor(tokens[0]),
                    "bert": bparams, "bert_batch": [torch.as_tensor(a) for a
                                                    in bbatch],
                    "mlp": ({k: torch.as_tensor(v) for k, v in
                             mparams.items()},
                            [tuple(torch.as_tensor(a) for a in b)
                             for b in mbatches]),
                    "one_rank_ckpt": str(out / "one_rank_ckpt")}, f)
            outs, err = _run_world(_RANK, WORLD, [str(out)], str(out))
            (out / "error").write_text(err if outs is None else "")
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    per_rank = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    cases = {name: [res[name] for res in per_rank] for name in per_rank[0]}
    cases["dir"] = out
    return cases


def _jax_run(builder, loss_fn, params, opt, batches):
    """The JAX package's run on its 8-device mesh: (losses, logical params
    by name)."""
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, opt, example_batch=batches[0]))
    state = runner.create_state()
    losses = []
    for b in batches:
        state, metrics = runner.step(state, b)
        losses.append(float(jax.device_get(metrics["loss"])))
    want = {jpath_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(
                runner.logical_params(state)))[0]}
    return losses, want


@functools.lru_cache(maxsize=None)
def _jax_lm():
    _, params, loss_fn, batch = _lm_fixture()
    return _jax_run(jstrategy.ModelParallel(jstrategy.AllReduce(),
                                            model_axis=2),
                    loss_fn, params, optax.sgd(0.1), [batch] * STEPS)


def _excess(res, want):
    """How far a rank's run lies from the JAX run, in units of the
    tolerance: max over the losses and every param of |a - b| / (ATOL +
    RTOL |b|). At most 1 passes ``assert_allclose``."""
    def worst(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / (ATOL + RTOL * np.abs(b))))
    losses, params = want
    return max([worst(res["losses"], losses)] +
               [worst(res["params"][k], params[k]) for k in params])


def _held_to_jax(ranks, want):
    losses, params = want
    for r, res in enumerate(ranks):
        assert res["mesh"] == {"data": 2, "model": 2}
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        assert sorted(res["params"]) == sorted(params)
        for k in params:
            np.testing.assert_allclose(res["params"][k], params[k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
    assert losses[-1] < losses[0]


def test_lm_tiny_trains_under_model_parallel_like_jax(world):
    """``tests/test_parallel.py::test_model_parallel_transformer_numeric_
    parity``'s run (lm_tiny, SGD 0.1, 3 steps) under
    ``ModelParallel(AllReduce(), model_axis=2)``: every Megatron weight a
    ``tp`` piece, the embedding table gathered at use."""
    _held_to_jax(world["lm"], _jax_lm())
    kinds = world["lm"][0]["kinds"]
    assert kinds["embed/embedding"] == ("tp", 1)
    assert kinds["layer0/attn/query/kernel"] == ("tp", 1)
    assert kinds["layer0/mlp/down/kernel"] == ("tp", 0)
    assert kinds["layer0/attn/out/bias"] == ("ar", None)
    assert world["lm"][0]["stored"]["layer0/attn/query/kernel"].shape == \
        (64, 32)
    assert world["lm"][0]["stored"]["embed/embedding"].shape == (256, 32)


def test_bert_tiny_mlm_trains_under_model_parallel_ps_like_jax(world):
    """bert_tiny MLM under ``ModelParallel(PS())`` with Adam (eps 1e-6):
    the split weights keep their state as their pieces (``tp``), the
    others ZeRO-1 over the data axis."""
    params, loss_fn, batch = jbert.tiny_fixture(seed=0)
    want = _jax_run(jstrategy.ModelParallel(jstrategy.PS(), model_axis=2),
                    loss_fn, params, optax.adam(1e-3, eps=1e-6),
                    [batch] * STEPS)
    _held_to_jax(world["bert"], want)
    kinds = {k for k, _ in world["bert"][0]["kinds"].values()}
    assert kinds == {"tp", "zero1"}


def test_user_mlp_gathered_under_custom_rules_like_jax(world):
    """``tests/test_composition.py``'s MLP under ``ModelParallel(rules=
    (("w1", 1), ("w2", 0)), base=PS())``: neither weight is a Megatron
    layer's, so both are gathered at use over the model group."""
    params, batches = _mlp_fixture()
    want = _jax_run(jstrategy.ModelParallel(rules=MLP_RULES,
                                            base=jstrategy.PS()),
                    _jmlp_loss, params, optax.sgd(0.05), batches)
    _held_to_jax(world["mlp"], want)
    assert world["mlp"][0]["kinds"] == {"w1": ("tp", 1), "w2": ("tp", 0)}


@pytest.mark.parametrize("fault", ["undivided", "no_allreduce",
                                   "bias_first"])
def test_each_planted_fault_reads_above_the_tolerance(world, fault):
    """The gathered gradient left P times too large, the copy-to-model
    backward all-reduce dropped, and the row-parallel bias added on every
    rank before the reduce each take the run off the JAX package's by
    more than the tolerance the clean run meets."""
    want = _jax_lm()
    assert max(_excess(r, want) for r in world["lm"]) <= 1
    assert max(_excess(r, want) for r in world["fault_" + fault]) > 1


def _replicated_and_pieces(ranks):
    kinds = ranks[0]["kinds"]
    whole = [k for k, (kind, _) in kinds.items() if kind != "tp"]
    pieces = [k for k, (kind, _) in kinds.items() if kind == "tp"]
    return whole, pieces


@pytest.mark.parametrize("case", ["lm", "noisy"])
def test_replicated_params_stay_bitwise_equal_and_pieces_differ(world,
                                                                case):
    """Across each model group ({0, 1} and {2, 3}) and the world, every
    replicated parameter is bitwise equal; the pieces differ between the
    two ranks of a model group. ``noisy``: each model rank's gradient of
    ``ln_f/scale`` shifted by its own amount, as the card's scatter-add
    atomics shift a whole parameter's gradient in its last bits: the mean
    over data x model keeps the copies equal."""
    ranks = world[case]
    whole, pieces = _replicated_and_pieces(ranks)
    assert whole and pieces
    for r in range(1, WORLD):
        for k in whole:
            np.testing.assert_array_equal(ranks[r]["stored"][k],
                                          ranks[0]["stored"][k])
    for a, b in ((0, 1), (2, 3)):
        for k in pieces:
            assert not np.array_equal(ranks[a]["stored"][k],
                                      ranks[b]["stored"][k]), k
    for a in range(WORLD):
        assert world["lm"][a]["model_group"] == [a - a % 2, a - a % 2 + 1]


def test_whole_params_drift_apart_when_averaged_over_data_alone(world):
    """The planted fault: the noisy run with the whole parameters'
    gradients averaged over the data group only. The model ranks' copies
    of ``ln_f/scale`` part."""
    ranks = world["noisy_data_only"]
    for a, b in ((0, 1), (2, 3)):
        assert not np.array_equal(ranks[a]["stored"]["ln_f/scale"],
                                  ranks[b]["stored"]["ln_f/scale"])


def test_model_group_fed_two_batches_raises(world):
    for r, got in enumerate(world["mismatch"]):
        assert got is not None and got[0] == "ValueError", (r, got)
        assert "model group were fed different batches" in got[1]


def test_batch_splits_over_data_only(world):
    """Every batch leaf's dim 0 on the data axis, none on the model axis,
    and ``shard_batch`` hands a rank's rows to its device whole."""
    for res in world["lm"]:
        assert res["batch_specs"] == [("data", None)]
        assert res["shard_batch_whole"]


def _jax_graph(builder, loss_fn, params, opt, batch):
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, opt, example_batch=batch))
    return jax_graph_paths(runner, [batch] * 4)


@pytest.mark.parametrize("case", ["lm", "bert"])
def test_graph_paths_under_a_model_axis_match_step_and_jax(world, case):
    """``make_callable(aot=True)``, ``megastep`` and ``run(unroll=2)`` on
    ``{data: 2, model: 2}`` (on the CPU the graph's function runs
    directly, over its static buffers), 4 steps of one batch: bitwise the
    eager steps, and held to the JAX package's ``make_callable(aot=True)``
    and ``megastep`` at the eager parity's tolerance. ``lm``: lm_tiny
    under ``ModelParallel(AllReduce())``, SGD 0.1; ``bert``: bert_tiny MLM
    under ``ModelParallel(PS())``, Adam (eps 1e-6)."""
    if case == "lm":
        _, params, loss_fn, batch = _lm_fixture()
        want = _jax_graph(jstrategy.ModelParallel(jstrategy.AllReduce(),
                                                  model_axis=2),
                          loss_fn, params, optax.sgd(0.1), batch)
    else:
        params, loss_fn, batch = jbert.tiny_fixture(seed=0)
        want = _jax_graph(jstrategy.ModelParallel(jstrategy.PS(),
                                                  model_axis=2),
                          loss_fn, params, optax.adam(1e-3, eps=1e-6), batch)
    held_graph_paths(world["graph_" + case], want, RTOL, ATOL)


def test_model_group_fed_two_batches_raises_at_the_graph_first_call(world):
    for r, got in enumerate(world["graph_mismatch"]):
        assert got is not None and got[0] == "ValueError", (r, got)
        assert "model group were fed different batches" in got[1]


def test_non_elementwise_optimizer_on_a_piece_raises(world):
    for got in world["lbfgs"]:
        assert got is not None and got[0] == "ValueError", got
        assert "LBFGS" in got[1]


def test_heads_the_model_axis_does_not_divide_gather_the_attention(world):
    """6 heads on a model axis of 4 ({data: 1, model: 4}): the attention
    weights arrive as pieces and are gathered at use, the MLP stays
    Megatron; the run matches AllReduce on {data: 4} at 1e-5."""
    for res, ar in zip(world["heads"], world["heads_ar"]):
        assert res["mesh"] == {"data": 1, "model": 4}
        assert res["kinds"]["layer0/attn/query/kernel"] == ("tp", 1)
        np.testing.assert_allclose(res["losses"], ar["losses"], rtol=1e-5,
                                   atol=1e-6)
        for k, v in ar["params"].items():
            np.testing.assert_allclose(res["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_mesh_model_group_is_the_jax_layout(world):
    """The port's {data: 2, model: 2} rank mesh puts ranks 2d and 2d + 1
    in one model group: the JAX mesh's rows (``data`` outer, ``model``
    inner) over the first four devices."""
    _jreset()
    ad = JAutoDist(strategy_builder=jstrategy.AllReduce())
    jmesh = ad.cluster.build_mesh({"data": 4, "model": 2})
    rows = [sorted(d.id for d in row) for row in jmesh.devices]
    for r, res in enumerate(world["lm"]):
        assert res["model_group"] in rows[:2], (r, res["model_group"])
        assert r in res["model_group"]


def _port_runner(params):
    ad = AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    _, _, batch = jbert.tiny_fixture(seed=0)
    return ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(bert.bert_tiny()), params,
        functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6),
        example_batch=batch))


def test_tp_checkpoint_restores_bitwise_on_one_rank(world):
    """The TP world's CheckpointManager step restores into a one-rank
    ``AllReduce()`` Runner: params and Adam state bitwise the TP world's
    logical form; its manifest's params entries are the JAX manifest's."""
    jparams, _, _ = jbert.tiny_fixture(seed=0)
    jparams = jax.device_get(jparams)
    runner = _port_runner(convert.params_from_jax(jparams, "cpu"))
    mgr = CheckpointManager(runner, world["dir"] / "tp_ckpt")
    state = runner.to_logical(mgr.restore_or_init())
    tp = world["bert"][0]
    assert int(state.step) == STEPS
    got = {path_to_name(p): t.numpy() for p, t in
           flatten_with_path(state.params)[0]}
    assert sorted(got) == sorted(tp["params"])
    for k, v in tp["params"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    opt = {path_to_name(p): t.numpy() for p, t in
           flatten_with_path(state.opt_state)[0]}
    for k, v in tp["opt_state"].items():
        np.testing.assert_array_equal(opt[k], v, err_msg=k)
    man = manifest_mod.read_manifest(world["dir"] / "tp_ckpt" /
                                     manifest_mod.manifest_name(STEPS))
    assert man["world"]["mesh"] == {"data": 2, "model": 2}
    assert {k: v for k, v in man["leaves"].items()
            if k.startswith("params/")} == \
        jmanifest.leaf_entries({"params": jparams})


def test_one_rank_checkpoint_restores_into_the_tp_world(world):
    raw = read_tree(str(world["dir"] / "one_rank_ckpt" / "2"))
    for res in world["restored"]:
        assert res["step"] == 2
        want = {path_to_name(p): t.numpy() for p, t in
                flatten_with_path(raw["params"])[0]}
        for k, v in want.items():
            np.testing.assert_array_equal(res["params"][k], v, err_msg=k)
        want = {path_to_name(p): t.numpy() for p, t in
                flatten_with_path(raw["opt_state"])[0]}
        assert sorted(res["opt_state"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(res["opt_state"][k], v, err_msg=k)
