"""One variable split over two mesh axes, in the port against the JAX
package: the MoE layer with Megatron-split experts on ``{expert, model}``
and the stacked LM pipelined with Megatron-split stages on ``{pipe,
model}``.

Neither package's builders compose these (the JAX ``apply_sharding_rules``
replaces a node's partitioner outright), so both run them from a fixed
builder, :class:`TwoAxis`: a base builder's strategy with a second axis
carved out and a second entry in automap's form appended to the matched
partitioners (``"0:2:pipe,2:2:model"``, the first axis's entry first).

* Composed partitioner strings parse and print byte for byte as the JAX
  ``PartitionerConfig``'s; each composition's param specs equal the JAX
  program's, and its ``var_kinds`` and ``Placement`` split each leaf over
  the axes its specs name.
* One 4-rank gloo world (subprocesses, ``OMP_NUM_THREADS=1``), against the
  JAX Runner on its 8-device CPU mesh (Pallas in interpret mode), 3 SGD
  0.1 steps, rtol 1e-4 / atol 1e-5 on the losses and every logical param:

  - ``tests/test_automap_multiaxis.py``'s stacked LM (4 layers, dim 64, 4
    heads) under ``Pipeline(2, 4)`` with every stacked Megatron weight
    split over ``model`` on its rule's dim + 1 and the embedding over
    ``model`` (``{data: 1, pipe: 2, model: 2}``; JAX ``{data: 2, pipe: 2,
    model: 2}``) under ``shift`` and ``1f1b`` (bitwise ``shift``);
  - its MoE fixture (8 experts, d 32, hidden 512) with ``up`` split
    ``"0:2:expert,2:2:model"`` and ``down`` ``"0:2:expert,1:2:model"``
    (``{data: 1, expert: 2, model: 2}``);
  - the nested builders the JAX package composes on the same meshes,
    whose pieces lie on one axis each: ``Pipeline(base=ModelParallel())``
    on the LM and ``ModelParallel(ModelParallel(), mesh_axis="expert")``
    on the MoE fixture;
  - planted faults read at least 10x the tolerance: the copy-to-model
    backward without its all-reduce and the whole gradients averaged over
    pipe instead of summed (LM), the MoE's partial output summed over the
    expert group alone;
  - the graph paths (``make_callable(aot=True)``, ``megastep``,
    ``run(unroll=2)``) bitwise the eager steps and held to the JAX
    package's compiled steps;
  - a checkpoint of the LM goes 4 -> 1 -> 4 bitwise;
  - what still raises: an MoE layer under seq (10(i)-seq, at the mesh and
    in the layer) and pipe with expert (10(j)-expert).
"""
import fcntl
import functools
import pickle
import threading

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
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import path_to_name as jpath_to_name
from autodist_tpu.kernel import partitioner as jpartitioner
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import transformer as jT
from autodist_tpu.parallel import moe as jmoe
from autodist_tpu.serve.engine import build_replica_programs as jbuild
from autodist_tpu.strategy import base as jbase
from autodist_tpu_torch import AutoDist, convert, strategy
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.checkpoint.saver import read_tree
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel import partitioner
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.parallel import moe
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve.engine import build_replica_programs
from autodist_tpu_torch.strategy import base
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
from test_torch_ps_strategies import (GRAPH_PATHS, held_graph_paths,
                                      jax_graph_paths)

WORLD = 4
STEPS = 3
LR = 0.1
MICRO = 4
RTOL, ATOL = 1e-4, 1e-5
SCHEDULES = ("shift", "1f1b")

#: The fixed builder, in both packages and the rank script.
TWO_AXIS = r'''
import re as _re


class TwoAxis:
    """A fixed strategy builder: ``base``'s strategy with the mesh axis
    ``axis`` of ``size`` carved out of ``data`` (``carve``: the package's
    ``carve_mesh_axis``), and each variable that a rule of ``rules``
    ((regex, dim), the first match deciding) names also split over it on
    that dim: its partitioner gains the entry "dim:size:axis" after its
    own, automap's composed form."""

    def __init__(self, base, axis, size, rules, carve):
        self.base, self.axis, self.size = base, axis, size
        self.rules, self.carve = rules, carve

    def build(self, item, spec):
        s = self.base.build(item, spec)
        self.carve(s, spec, self.axis, self.size)
        for node in s.node_config:
            for pat, dim in self.rules:
                if _re.search(pat, node.var_name):
                    entry = f"{dim}:{self.size}:{self.axis}"
                    node.partitioner = (f"{node.partitioner},{entry}"
                                        if node.partitioner else entry)
                    break
        return s
'''
exec(TWO_AXIS)

#: Every stacked Megatron weight over ``model`` on its rule's dim + 1 (dim
#: 0 holds the layers), and the embedding on its hidden dim.
STACKED_RULES = (
    (r"attn/(query|key|value)/kernel$", 2), (r"attn/(query|key|value)/bias$",
                                             1),
    (r"attn/out/kernel$", 1), (r"mlp/up/kernel$", 2), (r"mlp/up/bias$", 1),
    (r"mlp/down/kernel$", 1), (r"embed/embedding$", 1))
#: Each expert's FFN over ``model``: up's hidden columns, down's rows.
MOE_RULES = ((r"moe/up/kernel$", 2), (r"moe/down/kernel$", 1))

#: The builders by case, given a package's strategy module, its
#: carve_mesh_axis and its moe module.
BUILDERS = {
    "pp_tp": lambda S, carve, M: TwoAxis(
        S.Pipeline(num_stages=2, num_microbatches=MICRO), "model", 2,
        STACKED_RULES, carve),
    "ep_tp": lambda S, carve, M: TwoAxis(
        S.ModelParallel(S.AllReduce(), model_axis=2, rules=M.EXPERT_RULES,
                        mesh_axis="expert"), "model", 2, MOE_RULES, carve),
    "pp_mp": lambda S, carve, M: S.Pipeline(
        num_stages=2, num_microbatches=MICRO,
        base=S.ModelParallel(S.AllReduce(), model_axis=2)),
    "ep_mp": lambda S, carve, M: S.ModelParallel(
        S.ModelParallel(S.AllReduce(), model_axis=2), model_axis=2,
        rules=M.EXPERT_RULES, mesh_axis="expert"),
}


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


def _lm_config(pkg, dtype):
    """``tests/test_automap_multiaxis.py::_stacked_item``'s LM."""
    return pkg.TransformerConfig(vocab=256, dim=64, num_heads=4, num_layers=4,
                                 max_len=16, causal=True, scan_layers=True,
                                 dtype=dtype)


def _lm_fixture():
    """(JAX cfg, JAX params, JAX loss, tokens (16, 17))."""
    cfg = _lm_config(jT, jnp.float32)
    params = jax.device_get(jT.init(jax.random.PRNGKey(0), cfg))
    return cfg, params, jlm.make_loss_fn(cfg), \
        jlm.synthetic_batch(cfg, batch_size=16, seq_len=16)


MOE_WIDTHS = dict(num_experts=8, top_k=2, d_model=32, d_hidden=512)


def _jmoe_loss(cfg):
    def loss_fn(p, b):
        x, labels = b
        h, aux = jmoe.apply(p["moe"], cfg, x)
        lg = h @ p["head"]["kernel"]
        ce = -jnp.mean(jax.nn.log_softmax(lg)[
            jnp.arange(labels.shape[0]), labels])
        return ce + 0.01 * aux
    return loss_fn


def moe_loss(cfg):
    """The port's ``_jmoe_loss``."""
    def loss_fn(p, b):
        x, labels = b
        h, aux = moe.apply(p["moe"], cfg, x)
        lg = h @ p["head"]["kernel"]
        ce = -torch.log_softmax(lg, -1)[torch.arange(labels.shape[0]),
                                        labels.long()].mean()
        return ce + 0.01 * aux
    return loss_fn


def _moe_fixture():
    """``tests/test_automap_multiaxis.py::_moe_item``'s model: (JAX cfg,
    JAX params, batch (16 x 32 f32, 16 labels))."""
    cfg = jmoe.MoEConfig(**MOE_WIDTHS)
    key = jax.random.PRNGKey(0)
    params = jax.device_get({"moe": jmoe.init(key, cfg),
                             "head": {"kernel": jax.random.normal(
                                 key, (32, 4)) * 0.1}})
    rng = np.random.RandomState(0)
    batch = (rng.randn(16, 32).astype(np.float32),
             rng.randint(0, 4, (16,)).astype(np.int32))
    return cfg, params, batch


# -- the partitioner strings and the program ----------------------------------

@pytest.mark.parametrize("text", [
    "0:2:expert,2:2:model", "0:2:expert,1:2:model", "0:2:pipe,2:2:model",
    "0:2:pipe,1:2:model", "0:4:pipe,1:2:model", "1:2:expert", "0:2:pipe",
    "1:8", "0:2:expert,2:4", "2:4:model,0:2:pipe", ""])
def test_composed_partitioner_strings_round_trip_like_jax(text):
    got = partitioner.PartitionerConfig.from_string(text)
    want = jpartitioner.PartitionerConfig.from_string(text)
    assert got.to_string() == want.to_string()
    if text:
        assert got.to_string() == text
    assert got.entries == want.entries
    assert got.active == want.active
    for rank in (1, 2, 3):
        assert got.partition_list(rank) == want.partition_list(rank)
    assert repr(got) == repr(want)


def _programs(tmp_path, case, devices):
    """(JAX program, port program) of ``case``'s builder on a local mesh of
    ``devices`` devices."""
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    jspec, spec = jrs.ResourceSpec(str(path)), ResourceSpec(str(path))
    if case.startswith("pp"):
        jcfg, jparams, jloss, batch = _lm_fixture()
        port_loss = lm.make_loss_fn(_lm_config(T, torch.float32))
    else:
        jcfg, jparams, batch = _moe_fixture()
        jloss = _jmoe_loss(jcfg)
        port_loss = moe_loss(moe.MoEConfig(**MOE_WIDTHS))
    jitem = JGraphItem.capture(jloss, jparams, optax.sgd(LR),
                               example_batch=batch)
    item = GraphItem.capture(port_loss, convert.params_from_jax(jparams,
                                                                "cpu"),
                             None, example_batch=batch)
    js = BUILDERS[case](jstrategy, jbase.carve_mesh_axis, jmoe).build(
        jitem, jspec)
    s = BUILDERS[case](strategy, base.carve_mesh_axis, moe).build(item, spec)
    return next(jbuild(jitem, js, jspec, 1)), \
        next(build_replica_programs(item, s, spec, 1))


#: Each composed case's leaves split over two axes, with their pairs.
TWO_AXIS_LEAVES = {
    "pp_tp": {"blocks/attn/query/kernel": (("pipe", 0), ("model", 2)),
              "blocks/attn/query/bias": (("pipe", 0), ("model", 1)),
              "blocks/attn/out/kernel": (("pipe", 0), ("model", 1)),
              "blocks/mlp/up/kernel": (("pipe", 0), ("model", 2)),
              "blocks/mlp/down/kernel": (("pipe", 0), ("model", 1))},
    "ep_tp": {"moe/up/kernel": (("expert", 0), ("model", 2)),
              "moe/down/kernel": (("expert", 0), ("model", 1))}}
#: ... and some split over one of them, with its (axis, dim).
ONE_AXIS_LEAVES = {
    "pp_tp": {"blocks/attn/out/bias": ("pipe", 0),
              "blocks/ln1/scale": ("pipe", 0),
              "embed/embedding": ("model", 1)},
    "ep_tp": {"moe/gate/kernel": ("expert", 1)}}


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("case", ["pp_tp", "ep_tp", "pp_mp", "ep_mp"])
def test_two_axis_programs_place_like_jax(tmp_path, case, devices):
    """The partitioners and the param specs are the JAX program's; a leaf
    split over two axes is a ``tp`` variable with both (axis, dim) pairs,
    and its ``Placement`` cuts it over both axes' sizes."""
    jprog, prog = _programs(tmp_path, case, devices)
    jnodes = {n.var_name: n.partitioner
              for n in jprog.strategy.node_config}
    assert {n.var_name: n.partitioner for n in prog.strategy.node_config} \
        == jnodes
    axes = dict(prog.mesh.shape)
    assert dict(axes, data=0) == dict(jprog.mesh.shape, data=0)
    assert axes["data"] == devices // 4
    jspecs = {jpath_to_name(p): tuple(v) for p, v in
              jax.tree_util.tree_flatten_with_path(
                  jprog.param_specs(), is_leaf=lambda x: isinstance(
                      x, jax.sharding.PartitionSpec))[0]}
    specs = {path_to_name(p): tuple(v) for p, v in
             flatten_with_path(prog.param_specs())[0]}
    assert specs == jspecs
    kinds = prog.var_kinds()
    placements = {path_to_name(p): pl for p, pl in
                  flatten_with_path(prog.param_placements())[0]}
    two = TWO_AXIS_LEAVES.get(case, {})
    one = ONE_AXIS_LEAVES.get(case, {})
    for name, pairs in two.items():
        assert jnodes[name] == ",".join(f"{d}:2:{a}" for a, d in pairs)
        assert kinds[name] == ("tp", pairs)
        assert prog.piece_dims()[name] == pairs
        assert placements[name].pieces == tuple((d, None, 2)
                                                for _, d in pairs)
        assert placements[name].dim is None
    for name, (axis, dim) in one.items():
        assert kinds[name] == ("tp", dim)
        assert prog.piece_dims()[name] == ((axis, dim),)
        assert placements[name].pieces == ((dim, None, 2),)
    if case in ("pp_mp", "ep_mp"):  # the nested builders: one axis a leaf
        assert all(len(p) == 1 for p in prog.piece_dims().values())
    whole = [n for n, (k, _) in kinds.items() if k != "tp"]
    assert whole and all(placements[n].pieces == () for n in whole)
    assert set(prog.piece_axes) == {a for a in axes if a != "data"}


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, hashlib, importlib, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.models import layers, lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.parallel import context, moe
from autodist_tpu_torch.strategy.base import carve_mesh_axis
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
#TWO_AXIS

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
res = {}
SGD = functools.partial(torch.optim.SGD, lr=LR)
STACKED_RULES, MOE_RULES = inp["rules"]
lcfg = T.TransformerConfig(vocab=256, dim=64, num_heads=4, num_layers=4,
                           max_len=16, causal=True, scan_layers=True,
                           dtype=torch.float32)
mcfg = moe.MoEConfig(**inp["moe_widths"])
MODELS = {"pp": (lm.make_loss_fn(lcfg), inp["lm"], (inp["tokens"],)),
          "ep": (moe_loss(mcfg), inp["moe"], tuple(inp["moe_batch"]))}
BUILDERS = {
    "pp_tp": lambda: TwoAxis(
        S.Pipeline(num_stages=2, num_microbatches=MICRO), "model", 2,
        STACKED_RULES, carve_mesh_axis),
    "ep_tp": lambda: TwoAxis(
        S.ModelParallel(S.AllReduce(), model_axis=2, rules=moe.EXPERT_RULES,
                        mesh_axis="expert"), "model", 2, MOE_RULES,
        carve_mesh_axis),
    "pp_mp": lambda: S.Pipeline(
        num_stages=2, num_microbatches=MICRO,
        base=S.ModelParallel(S.AllReduce(), model_axis=2)),
    "ep_mp": lambda: S.ModelParallel(
        S.ModelParallel(S.AllReduce(), model_axis=2), model_axis=2,
        rules=moe.EXPERT_RULES, mesh_axis="expert")}


def named(tree):
    return {path_to_name(p): t.detach().float().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}


#GRAPH_PATHS


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None


def session(builder, model):
    loss_fn, params, batch = MODELS[model]
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(loss_fn, params, SGD, example_batch=batch)
    return ad.create_distributed_session(item)


def train(case, sched="shift", prepare=None):
    os.environ["AUTODIST_PIPELINE_SCHEDULE"] = sched
    try:
        runner = session(BUILDERS[case](), case[:2])
        if prepare is not None:
            prepare(runner)
        state = runner.create_state()
        batch = MODELS[case[:2]][2]
        losses = []
        for _ in range(STEPS):
            state, m = runner.step(state, batch)
            losses.append(float(m["loss"]))
        ctx = runner.program.parallel_context()
    finally:
        del os.environ["AUTODIST_PIPELINE_SCHEDULE"]
    kinds = runner.var_kinds
    stored = {path_to_name(p): t for p, t in
              flatten_with_path(state.params)[0]}
    mesh = runner.program.mesh
    return runner, state, {
        "losses": losses, "params": named(runner.logical_params(state)),
        "mesh": dict(mesh.shape),
        "place": {a: mesh.axis_index(a) for a in mesh.axis_names},
        "schedule": ctx.pipeline_schedule,
        "kinds": dict(kinds),
        "pieces": {a: sorted(v) for a, v in ctx.pieces.items()},
        "shapes": {n: tuple(t.shape) for n, t in stored.items()},
        "placements": {n: tuple(pl.pieces)
                       for n, pl in runner._placements.items()},
        "whole": digest(t for n, t in sorted(stored.items())
                        if kinds[n][0] != "tp"),
        "split": digest(t for n, t in sorted(stored.items())
                        if kinds[n][0] == "tp")}


def train_on(case, batch):
    runner = session(BUILDERS[case](), case[:2])
    runner.step(runner.create_state(), batch)


def train_seq():
    runner = session(S.SequenceParallel(seq_axis=2), "ep")
    runner.step(runner.create_state(), MODELS["ep"][2])


for sched in SCHEDULES:
    runner, state, res[f"pp_tp_{sched}"] = train("pp_tp", sched)
    if sched == "shift":
        mgr = CheckpointManager(runner, os.path.join(out, "pp_tp_ckpt"))
        mgr.save(STEPS, state, force=True)
        mgr.wait_until_finished()
        mgr.close()
        # A one-rank AllReduce checkpoint restored into the world.
        mgr = CheckpointManager(runner, inp["one_rank_ckpt"])
        restored = runner.to_logical(mgr.restore_or_init())
        res["restored"] = {"params": named(restored.params),
                           "step": int(restored.step)}
        mgr.close()
for case in ("ep_tp", "pp_mp", "ep_mp"):
    runner, state, res[case] = train(case)

# A model group fed two batches (each model rank its own labels).
wrong = MODELS["ep"][2][:1] + (
    (MODELS["ep"][2][1] + runner.program.mesh.axis_index("model")) % 4,)
res["ep_tp_mismatch"] = raises(lambda: train_on("ep_tp", wrong))

# The planted faults.
real_copy = layers._CopyToModel.__dict__["backward"]
layers._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
try:
    res["fault_no_copy"] = train("pp_tp")[2]
finally:
    layers._CopyToModel.backward = real_copy
res["fault_pipe_mean"] = train(
    "pp_tp", prepare=lambda r: setattr(r, "_pipe_sum", lambda name: 1))[2]
real_over = context.ParallelContext.group_over
context.ParallelContext.group_over = lambda self, axes: self.expert_group
try:
    res["fault_expert_only"] = train("ep_tp")[2]
finally:
    context.ParallelContext.group_over = real_over

# The graph paths.
for case in ("pp_tp", "ep_tp"):
    runner = session(BUILDERS[case](), case[:2])
    res["graph_" + case] = graph_paths(runner, [MODELS[case[:2]][2]] * 4)

# What still raises.
res["expert_seq"] = raises(lambda: session(
    S.ModelParallel(S.SequenceParallel(seq_axis=2), model_axis=2,
                    rules=moe.EXPERT_RULES, mesh_axis="expert"), "ep"))


res["moe_seq"] = raises(train_seq)
res["pipe_expert"] = raises(lambda: session(
    S.Pipeline(num_stages=2, num_microbatches=MICRO, base=S.ModelParallel(
        S.AllReduce(), model_axis=2, rules=moe.EXPERT_RULES,
        mesh_axis="expert")), "pp"))
autodist_mod._reset_default()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''.replace("STEPS", str(STEPS)).replace("SCHEDULES", repr(SCHEDULES)) \
   .replace("MICRO", str(MICRO)).replace("LR", repr(LR)) \
   .replace("#TWO_AXIS", TWO_AXIS + "\n" + r'''

def moe_loss(cfg):
    def loss_fn(p, b):
        x, labels = b
        h, aux = moe.apply(p["moe"], cfg, x)
        lg = h @ p["head"]["kernel"]
        ce = -torch.log_softmax(lg, -1)[torch.arange(labels.shape[0]),
                                        labels.long()].mean()
        return ce + 0.01 * aux
    return loss_fn
''').replace("#GRAPH_PATHS", GRAPH_PATHS)


def _port_session(builder, loss_fn, params, batch):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    return ad.create_distributed_session(ad.capture(
        loss_fn, params, functools.partial(torch.optim.SGD, lr=LR),
        example_batch=batch))


def _one_rank_checkpoint(directory, params, tokens):
    """A one-rank ``AllReduce()`` checkpoint of the stacked LM after 2 SGD
    steps (the world restores it into its ``{pipe, model}`` runner)."""
    try:
        runner = _port_session(strategy.AllReduce(), lm.make_loss_fn(
            _lm_config(T, torch.float32)), params, (tokens,))
        state = runner.create_state()
        for _ in range(2):
            state, _ = runner.step(state, (tokens,))
        mgr = CheckpointManager(runner, directory)
        mgr.save(2, state, force=True)
        mgr.close()
    finally:
        autodist_mod._reset_default()


def _jax_run(builder, loss_fn, params, batch):
    """The JAX package's run on its 8-device mesh, SGD 0.1, STEPS steps:
    (losses, logical params by name, mesh)."""
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, optax.sgd(LR), example_batch=batch))
    state = runner.create_state()
    losses = []
    for _ in range(STEPS):
        state, metrics = runner.step(state, batch)
        losses.append(float(jax.device_get(metrics["loss"])))
    want = {jpath_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(
                runner.logical_params(state)))[0]}
    mesh = dict(runner.program.mesh.shape)
    _jreset()
    return losses, want, mesh


def _jax_references():
    """Every JAX run the tests hold the world to: each case's eager steps,
    and the two compositions' compiled steps."""
    _, lparams, lloss, tokens = _lm_fixture()
    mcfg, mparams, mbatch = _moe_fixture()
    models = {"pp": (lloss, lparams, tokens),
              "ep": (_jmoe_loss(mcfg), mparams, mbatch)}
    refs = {}
    for case, make in BUILDERS.items():
        loss_fn, params, batch = models[case[:2]]
        refs[case] = _jax_run(make(jstrategy, jbase.carve_mesh_axis, jmoe),
                              loss_fn, params, batch)
    for case in ("pp_tp", "ep_tp"):
        loss_fn, params, batch = models[case[:2]]
        _jreset()
        ad = JAutoDist(strategy_builder=BUILDERS[case](
            jstrategy, jbase.carve_mesh_axis, jmoe))
        runner = ad.create_distributed_session(ad.capture(
            loss_fn, params, optax.sgd(LR), example_batch=batch))
        refs["graph_" + case] = jax_graph_paths(runner, [batch] * 4)
        _jreset()
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's cases and the JAX runs, made once per test session (the
    first xdist worker to need them makes them under a file lock; the JAX
    runs while the ranks do): ({case: [rank 0's result, ...]}, {run: JAX
    result}, the world's directory)."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "two_axis_world"
    with open(shared / "two_axis_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            _, lparams, _, tokens = _lm_fixture()
            _, mparams, mbatch = _moe_fixture()
            lparams = convert.params_from_jax(lparams, "cpu")
            tokens = torch.as_tensor(tokens[0])
            _one_rank_checkpoint(out / "one_rank_ckpt", lparams, tokens)
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({
                    "lm": lparams, "tokens": tokens,
                    "moe": convert.params_from_jax(mparams, "cpu"),
                    "moe_batch": [torch.as_tensor(a) for a in mbatch],
                    "moe_widths": MOE_WIDTHS,
                    "rules": (STACKED_RULES, MOE_RULES),
                    "one_rank_ckpt": str(out / "one_rank_ckpt")}, f)
            ran = {}
            ranks = threading.Thread(target=lambda: ran.update(
                zip(("outs", "err"), _run_world(_RANK, WORLD, [str(out)],
                                                str(out)))))
            ranks.start()
            try:
                refs = _jax_references()
            finally:
                ranks.join()
            with open(out / "jax.pkl", "wb") as f:
                pickle.dump(refs, f)
            (out / "error").write_text(ran["err"] if ran["outs"] is None
                                       else "")
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    per_rank = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    with open(out / "jax.pkl", "rb") as f:
        refs = pickle.load(f)
    return {name: [res[name] for res in per_rank] for name in per_rank[0]}, \
        refs, out


def _excess(res, want):
    """How far a rank's run lies from the JAX run, in units of the
    tolerance: max over the losses and every param of |a - b| / (ATOL +
    RTOL |b|). At most 1 passes ``assert_allclose``."""
    def worst(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / (ATOL + RTOL * np.abs(b))))
    losses, params = want[:2]
    return max([worst(res["losses"], losses)] +
               [worst(res["params"][k], params[k]) for k in params])


def _held_to_jax(ranks, want, mesh):
    losses, params, jmesh = want
    assert jmesh == dict(mesh, data=2)
    for r, res in enumerate(ranks):
        assert res["mesh"] == mesh
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        assert sorted(res["params"]) == sorted(params)
        for k in params:
            np.testing.assert_allclose(res["params"][k], params[k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
        assert _excess(res, want) <= 1.0
    assert losses[-1] < losses[0]
    # Whole parameters bitwise equal on every rank.
    assert len({res["whole"] for res in ranks}) == 1


MESHES = {"pp_tp": {"data": 1, "pipe": 2, "model": 2},
          "ep_tp": {"data": 1, "expert": 2, "model": 2},
          "pp_mp": {"data": 1, "model": 2, "pipe": 2},
          "ep_mp": {"data": 1, "model": 2, "expert": 2}}


@pytest.mark.parametrize("case", ["pp_tp_shift", "pp_tp_1f1b", "ep_tp"])
def test_two_axis_compositions_train_like_jax(world, case):
    """The stacked LM on {pipe: 2, model: 2} under each schedule and the
    MoE fixture on {expert: 2, model: 2}, each leaf of the Megatron split
    stored as this rank's piece over both axes, against the JAX Runner on
    its 8-device mesh; the pieces differ across the world."""
    cases, refs, _ = world
    key = case[:5]
    ranks = cases[case]
    _held_to_jax(ranks, refs[key], MESHES[key])
    for res in ranks:
        for name, pairs in TWO_AXIS_LEAVES[key].items():
            assert res["kinds"][name] == ("tp", pairs)
            full = refs[key][1][name].shape
            want = list(full)
            for _, dim in pairs:
                want[dim] //= 2
            assert res["shapes"][name] == tuple(want)
            assert name in res["pieces"]["model"]
        if key == "pp_tp":
            assert res["schedule"] == case.split("_")[-1]
            assert all(n.startswith("blocks/") for n in
                       res["pieces"]["pipe"])
            assert "embed/embedding" not in res["pieces"]["model"]
        else:
            assert sorted(res["pieces"]["expert"]) == ["moe/down/kernel",
                                                       "moe/up/kernel"]
            assert "moe/gate/kernel" not in res["pieces"]["expert"]
    assert len({res["split"] for res in ranks}) == WORLD


@pytest.mark.parametrize("case,was", [
    ("pp_mp", "test_torch_pipeline.py compose_model"),
    ("ep_mp", "test_torch_moe.py expert_model")])
def test_nested_builders_on_two_axis_meshes_train_like_jax(world, case, was):
    """The nested builders of both packages on the same meshes (each split
    leaf on one axis: the stacked layers over pipe and the embedding over
    model; the experts over expert, nothing over model), which the port
    refused before (``was``), against the JAX runs."""
    cases, refs, _ = world
    _held_to_jax(cases[case], refs[case], MESHES[case])
    for res in cases[case]:
        assert all(not isinstance(d, tuple) for k, d in
                   res["kinds"].values())


def test_one_f_one_b_is_bitwise_shift(world):
    cases, _, _ = world
    for got, want in zip(cases["pp_tp_1f1b"], cases["pp_tp_shift"]):
        assert got["losses"] == want["losses"]
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


@pytest.mark.parametrize("fault,ref", [
    ("fault_no_copy", "pp_tp"), ("fault_pipe_mean", "pp_tp"),
    ("fault_expert_only", "ep_tp")])
def test_planted_faults_read_ten_times_the_tolerance(world, fault, ref):
    """The copy-to-model backward without its all-reduce; the gradients
    that pipe does not split averaged over the pipe group instead of
    summed; the MoE's partial output summed over the expert group alone.
    Each lies at least 10 times the tolerance from the JAX run on every
    rank."""
    cases, refs, _ = world
    readings = [_excess(res, refs[ref]) for res in cases[fault]]
    print(f"{fault}: {readings} x the tolerance")
    assert min(readings) >= 10


@pytest.mark.parametrize("case", ["pp_tp", "ep_tp"])
def test_graph_paths_on_two_axis_meshes_match_step_and_jax(world, case):
    """``make_callable(aot=True)``, ``megastep`` and ``run(unroll=2)``
    (on the CPU the graph's function runs directly, over its static
    buffers), 4 steps of one batch: bitwise the eager steps, and held to
    the JAX package's ``make_callable(aot=True)`` and ``megastep``."""
    cases, refs, _ = world
    held_graph_paths(cases["graph_" + case], refs["graph_" + case], RTOL,
                     ATOL)


def test_checkpoint_goes_four_ranks_to_one_and_back_bitwise(world):
    """The {pipe: 2, model: 2} world's checkpoint restores into a one-rank
    ``AllReduce()`` Runner bitwise (each leaf gathered over both axes),
    whose next step is the JAX run's; a one-rank checkpoint restores into
    the world bitwise (each rank cut to its piece over both axes)."""
    cases, refs, out = world
    _, jparams, _, tokens = _lm_fixture()
    runner = _port_session(strategy.AllReduce(), lm.make_loss_fn(
        _lm_config(T, torch.float32)), convert.params_from_jax(jparams,
                                                               "cpu"),
        (torch.as_tensor(tokens[0]),))
    mgr = CheckpointManager(runner, out / "pp_tp_ckpt")
    state = mgr.restore_or_init()
    assert int(state.step) == STEPS
    got = {path_to_name(p): t.numpy() for p, t in
           flatten_with_path(runner.logical_params(state))[0]}
    want = cases["pp_tp_shift"][0]["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mgr.close()
    raw = read_tree(str(out / "one_rank_ckpt" / "2"))
    want = {path_to_name(p): t.numpy() for p, t in
            flatten_with_path(raw["params"])[0]}
    for res in cases["restored"]:
        assert res["step"] == 2
        assert sorted(res["params"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(res["params"][k], v, err_msg=k)


@pytest.mark.parametrize("case,kind,match", [
    ("expert_seq", "NotImplementedError", "item 10\\(i\\)-seq"),
    ("moe_seq", "NotImplementedError", "item 10\\(i\\)-seq"),
    ("pipe_expert", "NotImplementedError", "item 10\\(j\\)-expert"),
    ("ep_tp_mismatch", "ValueError",
     "expert x model group were fed different batches")])
def test_what_two_axes_still_refuse(world, case, kind, match):
    """An expert axis with a seq axis (at the mesh), an MoE layer under a
    seq axis (in the layer, at the first step) and a pipe axis with an
    expert axis raise ``NotImplementedError`` naming their items; the
    ranks of an expert x model group fed two batches raise."""
    import re
    cases, _, _ = world
    for res in cases[case]:
        assert res is not None and res[0] == kind, res
        assert re.search(match, res[1]), res[1]
