"""Sequence parallelism composed, in the port against the JAX package.

* BERT's masked-LM loss under a seq axis: ``bert_tiny`` (the JAX package's
  ``bert.tiny_fixture``: 8 x 16 tokens, 4 masked positions a row) under
  ``SequenceParallel("ring")`` on ``{data: 2, seq: 2}``, against the JAX
  package's run on its ``{data: 4, seq: 2}`` mesh. The masked positions
  fall unevenly over the two chunks (asserted); a rank's loss weighs its
  chunk's positions against the whole row count (``bert.chunk_mlm_loss``),
  and a per-chunk mean (a planted fault) reads far off.
* Tensor x sequence parallelism: ``lm_tiny`` and ``bert_tiny`` under
  ``ModelParallel(SequenceParallel(ring | ulysses, 2), 2)`` on ``{seq: 2,
  model: 2}``, against the JAX runs on ``{data: 2, seq: 2, model: 2}``;
  each model rank's gradient of a whole parameter shifted by its own
  amount still trains as JAX does (the mean over data x seq x model), and
  two planted faults read far off: the whole gradients averaged without
  the seq axis, and (with those shifts) without the model axis.
* Pipeline x sequence parallelism: ``lm_tiny(scan_layers=True)`` under
  ``SequenceParallel("ring", 2, base=Pipeline(2, 2))`` on ``{pipe: 2,
  seq: 2}`` under ``shift``, ``sequential`` and ``1f1b``, against the JAX
  run of ``tests/test_strategy_parallel.py::test_sequence_parallel_
  composes_with_pipeline``'s setup; ``sequential`` and ``1f1b`` bitwise
  ``shift``; the pipe hop sent to the other seq index (a planted fault)
  reads far off. ``pipeline_apply(seq_axis="seq", seq_dim=1)`` directly,
  with ring attention inside the stages, against the JAX function.
* The graph paths (``make_callable(aot=True)``, ``megastep``,
  ``run(unroll=2)``) under TP x SP (ring, Ulysses) and PP x SP (``shift``,
  ``1f1b``): bitwise the eager steps and held to the JAX package's
  compiled step.
* The composed builders' protos against the JAX builders', and what still
  raises: expert with seq (10(i)-seq), a composed group fed two batches (at
  the graph paths' first call too), Ulysses on local heads the seq axis
  does not divide.

Every run shares one 4-rank gloo world (subprocesses, ``OMP_NUM_THREADS=
1``); the JAX runs (8 CPU devices) are made once beside it. Tolerance:
rtol 1e-4, atol 1e-5 on losses and params (the JAX package's own against
one device), ``pipeline_apply`` at its 1e-5.
"""
import fcntl
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JMesh

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import resource_spec as jrs
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import path_to_name as jpath_to_name
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.parallel.ring_attention import ring_attention as jring
from autodist_tpu.pipeline import schedule as jschedule
from autodist_tpu_torch import convert, strategy
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.models import bert, lm
from autodist_tpu_torch.pipeline import schedule
from autodist_tpu_torch.resource_spec import ResourceSpec
from test_torch_ps_strategies import (GRAPH_PATHS, held_graph_paths,
                                      jax_graph_paths)

WORLD = 4
STEPS = 3
RTOL, ATOL = 1e-4, 1e-5
PA_TOL = 1e-5
SCHEDULES = ("shift", "sequential", "1f1b")
PA_MICRO, PA_DIM, PA_SEQ = 4, 16, 16
# Each model rank's gradient of ln_f/scale shifted by -NOISE or +NOISE.
NOISE = 1e-2


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


def _lm_fixture(scan_layers=False):
    """``tests/test_strategy_parallel.py``'s ``_lm_fixture(num_layers=2,
    seq_len=16)``: (JAX cfg, params, loss, tokens (8, 17))."""
    cfg = jlm.lm_tiny(max_len=16)
    cfg.num_layers = 2
    cfg.scan_layers = scan_layers
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    return cfg, params, jlm.make_loss_fn(cfg), \
        jlm.synthetic_batch(cfg, batch_size=8, seq_len=16)


def _bert_fixture():
    """``bert.tiny_fixture(seed=0)``: (params, loss, batch)."""
    params, loss_fn, batch = jbert.tiny_fixture(seed=0)
    return jax.device_get(params), loss_fn, batch


def _port_lm_cfg(scan_layers=False):
    cfg = lm.lm_tiny(max_len=16)
    cfg.scan_layers = scan_layers
    return cfg


def _pa_inputs():
    """Two tanh stages (dim 16) and x (4 M, 16, 16) for ``pipeline_apply``
    under a seq axis."""
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    stages = {"w": np.stack([np.asarray(
                  jax.random.normal(k, (PA_DIM, PA_DIM)) /
                  np.sqrt(PA_DIM), np.float32) for k in keys]),
              "b": np.zeros((2, PA_DIM), np.float32)}
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (4 * PA_MICRO, PA_SEQ, PA_DIM)))
    return stages, x


# -- the builders -------------------------------------------------------------

COMPOSED = {
    "mp(sp ring)": lambda S: S.ModelParallel(S.SequenceParallel("ring", 2),
                                             model_axis=2),
    "mp(sp ulysses)": lambda S: S.ModelParallel(
        S.SequenceParallel("ulysses", 2), model_axis=2),
    "sp(mp ps)": lambda S: S.SequenceParallel(
        "ring", 2, base=S.ModelParallel(S.PS(), model_axis=2)),
    "sp(pipeline)": lambda S: S.SequenceParallel(
        "ring", 2, base=S.Pipeline(2, 2)),
    "pipeline(sp)": lambda S: S.Pipeline(
        2, 2, base=S.SequenceParallel("ulysses", 2)),
}


@pytest.mark.parametrize("devices", [4, 8])
@pytest.mark.parametrize("name,model", [
    (name, model) for name in sorted(COMPOSED)
    for model in (("lm",) if "pipeline" in name else ("lm", "bert"))])
def test_composed_protos_match_jax(tmp_path, name, model, devices):
    """The whole proto, ids aside: the mesh axes and their order,
    ``seq_attn``, every node's partitioner and synchronizer, and
    ``pipeline_microbatches``."""
    pipe = "pipeline" in name
    if model == "lm":
        jcfg, params, loss_fn, batch = _lm_fixture(scan_layers=pipe)
        port_loss = lm.make_loss_fn(_port_lm_cfg(scan_layers=pipe))
    else:
        params, loss_fn, batch = _bert_fixture()
        port_loss = bert.make_loss_fn(bert.bert_tiny())
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    jitem = JGraphItem.capture(loss_fn, params, optax.sgd(0.1),
                               example_batch=batch)
    item = GraphItem.capture(port_loss, convert.params_from_jax(params,
                                                                "cpu"),
                             None, example_batch=batch)
    want = COMPOSED[name](jstrategy).build(jitem, jrs.ResourceSpec(str(path)))
    got = COMPOSED[name](strategy).build(item, ResourceSpec(str(path)))
    axes = dict(got.graph_config.mesh_axes)
    assert list(axes) == list(want.graph_config.mesh_axes)
    assert axes["seq"] == 2 and axes["data"] == devices // 4
    assert got.graph_config.seq_attn == want.graph_config.seq_attn != ""
    assert got.graph_config.pipeline_microbatches == (2 if pipe else 0)
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, hashlib, importlib, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.cluster import Cluster
from autodist_tpu_torch.models import bert, lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.parallel import moe
from autodist_tpu_torch.pipeline import schedule
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
ra = importlib.import_module("autodist_tpu_torch.parallel.ring_attention")

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
# The planted fault's pipe groups on {pipe: 2, seq: 2} (rank = 2 pipe +
# seq): stage 0 of seq index s paired with stage 1 of seq index 1 - s.
crossed = [dist.new_group([0, 3]), dist.new_group([1, 2])][rank in (1, 2)]
res = {}
SGD = functools.partial(torch.optim.SGD, lr=0.1)


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


def session(builder, loss_fn, params, example):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(loss_fn, params, SGD, example_batch=example)
    return ad.create_distributed_session(item)


def rows(runner, batch):
    mesh = runner.program.mesh
    per = len(batch[0]) // mesh.shape["data"]
    d = mesh.axis_index("data")
    return tuple(a[d * per:(d + 1) * per] for a in batch)


def train(builder, loss_fn, params, batch, prepare=None, env=None):
    os.environ.update(env or {})
    try:
        runner = session(builder, loss_fn, params, tuple(a[:2] for a in
                                                         batch))
        if prepare is not None:
            prepare(runner)
        state = runner.create_state()
        losses = []
        mine = rows(runner, batch)
        for _ in range(STEPS):
            state, m = runner.step(state, mine)
            losses.append(float(m["loss"]))
        ctx = runner.program.parallel_context()
    finally:
        for k in env or {}:
            del os.environ[k]
    kinds = runner.var_kinds
    stored = {path_to_name(p): t for p, t in
              flatten_with_path(state.params)[0]}
    mesh = runner.program.mesh
    return runner, state, {
        "losses": losses, "params": named(runner.logical_params(state)),
        "mesh": dict(mesh.shape),
        "place": {a: mesh.axis_index(a) for a in mesh.axis_names},
        "schedule": ctx.pipeline_schedule,
        "kinds": {n: k for n, (k, _) in kinds.items()},
        "whole": digest(t for n, t in sorted(stored.items())
                        if kinds[n][0] != "tp"),
        "pieces": digest(t for n, t in sorted(stored.items())
                         if kinds[n][0] == "tp")}


# BERT's MLM loss under a seq axis, and its planted fault.
bcfg = bert.bert_tiny()
bbatch = tuple(inp["bert_batch"])
ring = S.SequenceParallel("ring", 2)
runner, state, res["bert_sp"] = train(ring, bert.make_loss_fn(bcfg),
                                      inp["bert"], bbatch)
off = runner.program.mesh.axis_index("seq") * 8
positions = rows(runner, bbatch)[2]
res["bert_sp"]["chunk_counts"] = (
    (positions >= off) & (positions < off + 8)).sum(1).tolist()
del runner, state
real_mean = bert.chunk_mean
bert.chunk_mean = lambda xent, weight, p: (xent * weight).sum() / weight.sum()
try:
    res["fault_mlm_unweighted"] = train(ring, bert.make_loss_fn(bcfg),
                                        inp["bert"], bbatch)[2]
finally:
    bert.chunk_mean = real_mean

# Tensor x sequence parallelism.
lcfg = lm.lm_tiny(max_len=16)
lbatch = (inp["tokens"],)
for attn in ("ring", "ulysses"):
    builder = S.ModelParallel(S.SequenceParallel(attn, 2), model_axis=2)
    runner, state, res[f"lm_tp_sp_{attn}"] = train(
        builder, lm.make_loss_fn(lcfg), inp["lm"], lbatch)
    res[f"bert_tp_sp_{attn}"] = train(builder, bert.make_loss_fn(bcfg),
                                      inp["bert"], bbatch)[2]
mine = rows(runner, lbatch)
other = ((mine[0] + 1 + runner.program.mesh.axis_index("model")) %
         lcfg.vocab,)
res["tp_sp_mismatch"] = raises(lambda: runner.step(state, other))
res["tp_sp_graph_mismatch"] = first_call_raises(runner, other)
res["graph_lm_tp_sp_ulysses"] = graph_paths(runner, [mine] * 4)
runner = session(S.ModelParallel(S.SequenceParallel("ring", 2), model_axis=2),
                 lm.make_loss_fn(lcfg), inp["lm"],
                 tuple(a[:2] for a in lbatch))
res["graph_lm_tp_sp_ring"] = graph_paths(runner, [rows(runner, lbatch)] * 4)
del runner, state


def noisy(runner, over=None):
    """Model rank m's gradient of ln_f/scale shifted by (2 m - 1) NOISE
    before the reduction; ``over``: the axes the whole gradients average
    over instead of data x seq x model."""
    real = runner._sync_gradients
    shift = NOISE * (2 * runner.program.mesh.axis_index("model") - 1)

    def sync(grads):
        grads["ln_f/scale"] += shift
        real(grads)
    runner._sync_gradients = sync
    if over is not None:
        runner._grad_group = runner.program.mesh.group_over(over)


tp_sp = S.ModelParallel(S.SequenceParallel("ring", 2), model_axis=2)
for key, prepare in (
        ("lm_tp_sp_noisy", noisy),
        ("fault_no_model", lambda r: noisy(r, ("data", "seq"))),
        ("fault_no_seq", lambda r: setattr(
            r, "_grad_group", r.program.mesh.group_over(("data", "model"))))):
    res[key] = train(tp_sp, lm.make_loss_fn(lcfg), inp["lm"], lbatch,
                     prepare)[2]

# Six heads, three a model rank: Ulysses cannot split them over seq 2.
hcfg = T.TransformerConfig(vocab=64, dim=48, num_heads=6, num_layers=1,
                           max_len=16, causal=True, dtype=torch.float32)
res["ulysses_heads"] = raises(lambda: train(
    S.ModelParallel(S.SequenceParallel("ulysses", 2), model_axis=2),
    lm.make_loss_fn(hcfg), lm.init(hcfg, device="cpu"),
    (inp["tokens"] % 64,)))

# Pipeline x sequence parallelism.
scfg = lm.lm_tiny(max_len=16)
scfg.scan_layers = True
pp_sp = S.SequenceParallel("ring", 2, base=S.Pipeline(2, 2))
for sched in SCHEDULES:
    runner, state, res[f"lm_pp_sp_{sched}"] = train(
        pp_sp, lm.make_loss_fn(scfg), inp["lm_scan"], lbatch,
        env={"AUTODIST_PIPELINE_SCHEDULE": sched})
mine = rows(runner, lbatch)
other = ((mine[0] + 1 + runner.program.mesh.axis_index("pipe")) %
         lcfg.vocab,)
res["pp_sp_mismatch"] = raises(lambda: runner.step(state, other))
res["pp_sp_graph_mismatch"] = first_call_raises(runner, other)
for sched in ("shift", "1f1b"):
    # The schedule is read when the program's context is first built: at
    # the first (eager) step of graph_paths.
    os.environ["AUTODIST_PIPELINE_SCHEDULE"] = sched
    try:
        runner = session(pp_sp, lm.make_loss_fn(scfg), inp["lm_scan"],
                         tuple(a[:2] for a in lbatch))
        res[f"graph_lm_pp_sp_{sched}"] = graph_paths(
            runner, [rows(runner, lbatch)] * 4)
        res[f"graph_lm_pp_sp_{sched}"]["schedule"] = \
            runner.program.parallel_context().pipeline_schedule
    finally:
        del os.environ["AUTODIST_PIPELINE_SCHEDULE"]
del runner, state
real_init = schedule._Run.__init__


def crossed_init(self, stage_fn, treedef, num_micro, group, *rest):
    real_init(self, stage_fn, treedef, num_micro, crossed, *rest)


schedule._Run.__init__ = crossed_init
try:
    res["fault_pipe_crossed"] = train(pp_sp, lm.make_loss_fn(scfg),
                                      inp["lm_scan"], lbatch)[2]
finally:
    schedule._Run.__init__ = real_init

# Expert parallelism composes with no seq axis (10(i)-seq).
res["expert_seq"] = raises(lambda: session(
    S.ModelParallel(S.SequenceParallel("ring", 2), model_axis=2,
                    rules=moe.EXPERT_RULES, mesh_axis="expert"),
    lm.make_loss_fn(lcfg), inp["lm"], (inp["tokens"][:2],)))
autodist_mod._reset_default()

# pipeline_apply(seq_axis="seq", seq_dim=1) on {data: 1, pipe: 2, seq: 2},
# ring attention over the seq group inside each stage.
cluster = Cluster(ResourceSpec.local("cpu"))
cluster.start("cpu")
mesh = cluster.build_mesh({"data": 1, "pipe": 2, "seq": 2})
group = mesh.group("seq")
chunk = PA_SEQ // 2
me = mesh.axis_index("seq")


def stage(p, x):
    h = torch.tanh(x @ p["w"] + p["b"])
    return h + ra.ring_attention(h[:, None], h[:, None], h[:, None], group,
                                 causal=True)[:, 0]


for sched in SCHEDULES:
    stacked = {k: v.clone().requires_grad_()
               for k, v in inp["pa_stages"].items()}
    x = inp["pa_x"][:, me * chunk:(me + 1) * chunk].clone().requires_grad_()
    schedule.counts.update(forward_ticks=0, backward_ticks=0, hops=0)
    y = schedule.pipeline_apply(stacked, stage, x, PA_MICRO, mesh,
                                seq_axis="seq", seq_dim=1, schedule=sched)
    # mean(y^2) over the whole sequence is the mean of the two chunks';
    # every pipe rank computes it whole: the seed 1 / (S P).
    (y ** 2).mean().backward(torch.tensor(0.25))
    res[f"pa_{sched}"] = {
        "out": y.detach().numpy().copy(),
        "w": stacked["w"].grad.numpy().copy(),
        "b": stacked["b"].grad.numpy().copy(),
        "x": None if x.grad is None else x.grad.numpy().copy(),
        "place": (mesh.axis_index("pipe"), me),
        "counts": dict(schedule.counts)}
res["pa_no_seq_dim"] = raises(lambda: schedule.pipeline_apply(
    inp["pa_stages"], stage, inp["pa_x"][:, :chunk], PA_MICRO, mesh,
    seq_axis="seq"))
cluster.terminate()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''.replace("STEPS", str(STEPS)).replace("SCHEDULES", repr(SCHEDULES)) \
   .replace("PA_MICRO", str(PA_MICRO)).replace("PA_SEQ", str(PA_SEQ)) \
   .replace("NOISE", repr(NOISE)).replace("#GRAPH_PATHS", GRAPH_PATHS)


def _jax_run(builder, loss_fn, params, batch):
    """The JAX package's run on its 8-device mesh, SGD 0.1, STEPS steps:
    (losses, logical params by name, mesh)."""
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, optax.sgd(0.1), example_batch=batch))
    state = runner.create_state()
    losses = []
    for _ in range(STEPS):
        state, metrics = runner.step(state, batch)
        losses.append(float(jax.device_get(metrics["loss"])))
    want = {jpath_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(
                runner.logical_params(state)))[0]}
    mesh = dict(runner.program.mesh.shape) if hasattr(
        runner, "program") else None
    _jreset()
    return losses, want, mesh


def _jax_pipeline_apply():
    """The JAX ``pipeline_apply(seq_axis="seq", seq_dim=1)`` on a ``{data:
    1, pipe: 2, seq: 2}`` mesh of four CPU devices, the stages running
    the JAX ring attention over the manual seq axis: (output, d / d
    stacked w, b, d / d x) of mean(out^2)."""
    stages, x = _pa_inputs()
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 2, 2),
                 ("data", "pipe", "seq"))

    def stage(p, a):
        h = jnp.tanh(a @ p["w"] + p["b"])
        return h + jring(h[:, None], h[:, None], h[:, None],
                         axis_name="seq", causal=True)[:, 0]

    def apply(s, a):
        return jschedule.pipeline_apply(s, stage, a, PA_MICRO, mesh,
                                        seq_axis="seq", seq_dim=1)
    out = jax.jit(apply)(stages, x)
    gs, gx = jax.jit(jax.grad(lambda s, a: (apply(s, a) ** 2).mean(),
                              argnums=(0, 1)))(stages, x)
    return jax.device_get((out, gs["w"], gs["b"], gx))


def _jax_references():
    """Every JAX run the tests hold the world to."""
    _, lparams, lloss, tokens = _lm_fixture()
    _, sparams, sloss, _ = _lm_fixture(scan_layers=True)
    bparams, bloss, bbatch = _bert_fixture()
    js = jstrategy
    refs = {
        "bert_sp": _jax_run(js.SequenceParallel("ring", 2), bloss, bparams,
                            bbatch),
        "lm_pp_sp": _jax_run(js.SequenceParallel(
            "ring", 2, base=js.Pipeline(num_stages=2, num_microbatches=2)),
            sloss, sparams, tokens),
        "pa": _jax_pipeline_apply()}
    for attn in ("ring", "ulysses"):
        builder = js.ModelParallel(js.SequenceParallel(attn, 2),
                                   model_axis=2)
        refs[f"lm_tp_sp_{attn}"] = _jax_run(builder, lloss, lparams, tokens)
        refs[f"bert_tp_sp_{attn}"] = _jax_run(builder, bloss, bparams,
                                              bbatch)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's cases and the JAX runs, made once per test session (the
    first xdist worker to need them makes them under a file lock; the JAX
    runs while the ranks do): ({case: [rank 0's result, ...]}, {run: JAX
    result})."""
    import torch
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "composed_world"
    with open(shared / "composed_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            _, lparams, _, tokens = _lm_fixture()
            _, sparams, _, _ = _lm_fixture(scan_layers=True)
            bparams, _, bbatch = _bert_fixture()
            stages, x = _pa_inputs()
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({
                    "lm": convert.params_from_jax(lparams, "cpu"),
                    "lm_scan": convert.params_from_jax(sparams, "cpu"),
                    "tokens": torch.as_tensor(tokens[0]),
                    "bert": convert.params_from_jax(bparams, "cpu"),
                    "bert_batch": [torch.as_tensor(a) for a in bbatch],
                    "pa_stages": {k: torch.as_tensor(v)
                                  for k, v in stages.items()},
                    "pa_x": torch.as_tensor(x)}, f)
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
        refs


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


def test_bert_mlm_under_a_seq_axis_trains_like_jax(world):
    """bert_tiny MLM under SequenceParallel("ring") on {data: 2, seq: 2}
    against the JAX run on {data: 4, seq: 2}; each row's masked positions
    fall unevenly over the two chunks of 8."""
    cases, refs = world
    ranks = cases["bert_sp"]
    counts = {(r["place"]["data"], r["place"]["seq"]): r["chunk_counts"]
              for r in ranks}
    print(f"masked positions a row in each chunk, by (data, seq): {counts}")
    for d in (0, 1):
        assert [a + b for a, b in zip(counts[d, 0], counts[d, 1])] == \
            [4] * 4
        assert counts[d, 0] != counts[d, 1]
    assert any(len(set(c)) > 1 for c in counts.values())
    _held_to_jax(ranks, refs["bert_sp"], {"data": 2, "seq": 2})
    assert refs["bert_sp"][2] == {"data": 4, "seq": 2}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("model", ["lm", "bert"])
def test_tensor_and_sequence_parallel_train_like_jax(world, model, attn):
    """``ModelParallel(SequenceParallel(attn, 2), 2)`` on {seq: 2, model:
    2} (each rank its chunk and its heads) against the JAX run on {data:
    2, seq: 2, model: 2}; the pieces differ across a model group and agree
    across a seq group."""
    cases, refs = world
    key = f"{model}_tp_sp_{attn}"
    ranks = cases[key]
    _held_to_jax(ranks, refs[key], {"data": 1, "seq": 2, "model": 2})
    assert refs[key][2] == {"data": 2, "seq": 2, "model": 2}
    by_model = {}
    for res in ranks:
        assert "tp" in res["kinds"].values()
        by_model.setdefault(res["place"]["model"], set()).add(res["pieces"])
    assert all(len(v) == 1 for v in by_model.values())
    assert len(set().union(*by_model.values())) == 2


def test_whole_gradients_average_over_data_seq_and_model(world):
    """Each model rank's gradient of ln_f/scale shifted by -1e-2 or +1e-2:
    the mean over data x seq x model cancels the shifts, and the run holds
    to JAX."""
    cases, refs = world
    _held_to_jax(cases["lm_tp_sp_noisy"], refs["lm_tp_sp_ring"],
                 {"data": 1, "seq": 2, "model": 2})


@pytest.mark.parametrize("sched", SCHEDULES)
def test_pipeline_and_sequence_parallel_train_like_jax(world, sched):
    """``SequenceParallel("ring", 2, base=Pipeline(2, 2))`` on {pipe: 2,
    seq: 2} under each schedule against the JAX run on {data: 2, pipe: 2,
    seq: 2} (``test_sequence_parallel_composes_with_pipeline``'s); a rank
    stores its stage, the stages differ across a pipe group and agree
    across a seq group."""
    cases, refs = world
    ranks = cases[f"lm_pp_sp_{sched}"]
    _held_to_jax(ranks, refs["lm_pp_sp"], {"data": 1, "pipe": 2, "seq": 2})
    assert refs["lm_pp_sp"][2] == {"data": 2, "pipe": 2, "seq": 2}
    for res in ranks:
        assert res["schedule"] == sched
        assert {k for n, k in res["kinds"].items()
                if n.startswith("blocks/")} == {"tp"}
    by_pipe = {}
    for res in ranks:
        by_pipe.setdefault(res["place"]["pipe"], set()).add(res["pieces"])
    assert all(len(v) == 1 for v in by_pipe.values())
    assert len(set().union(*by_pipe.values())) == 2


@pytest.mark.parametrize("sched", ["sequential", "1f1b"])
def test_pipeline_and_sequence_parallel_schedules_bitwise_shift(world,
                                                                sched):
    cases, _ = world
    for got, want in zip(cases[f"lm_pp_sp_{sched}"],
                         cases["lm_pp_sp_shift"]):
        assert got["losses"] == want["losses"]
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_pipeline_apply_under_a_seq_axis_matches_jax(world, sched):
    """Each rank's output chunk, the stage gradients summed over its seq
    group, and stage 0's input gradient chunk against the JAX
    ``pipeline_apply(seq_axis="seq", seq_dim=1)`` at 1e-5; the executor's
    ticks and hops are the pipe axis's alone."""
    cases, refs = world
    out, gw, gb, gx = refs["pa"]
    runs = cases[f"pa_{sched}"]
    chunk = PA_SEQ // 2
    sums = {}
    for run in runs:
        pipe, seq = run["place"]
        cut = slice(seq * chunk, (seq + 1) * chunk)
        np.testing.assert_allclose(run["out"], out[:, cut], rtol=PA_TOL,
                                   atol=PA_TOL)
        assert not run["w"][1 - pipe].any()  # a rank holds its stage only
        if pipe == 0:
            np.testing.assert_allclose(run["x"], gx[:, cut], rtol=PA_TOL,
                                       atol=PA_TOL)
        else:
            assert run["x"] is None or not run["x"].any()
        w, b = sums.get(pipe, (0.0, 0.0))
        sums[pipe] = (w + run["w"][pipe], b + run["b"][pipe])
        ticks = schedule.executor_ticks(2, PA_MICRO, sched)
        hops = PA_MICRO * (2 - 1) if sched == "sequential" else \
            PA_MICRO + 2 - 2  # one at each tick at which a stage sends
        assert run["counts"] == {"forward_ticks": ticks,
                                 "backward_ticks": ticks, "hops": 2 * hops}
    for pipe, (w, b) in sums.items():
        np.testing.assert_allclose(w, gw[pipe], rtol=PA_TOL, atol=PA_TOL)
        np.testing.assert_allclose(b, gb[pipe], rtol=PA_TOL, atol=PA_TOL)


@pytest.mark.parametrize("sched", ["sequential", "1f1b"])
def test_pipeline_apply_under_a_seq_axis_schedules_bitwise_shift(world,
                                                                 sched):
    cases, _ = world
    for got, want in zip(cases[f"pa_{sched}"], cases["pa_shift"]):
        for key in ("out", "w", "b", "x"):
            if want[key] is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("fault,ref", [
    ("fault_mlm_unweighted", "bert_sp"),
    ("fault_no_seq", "lm_tp_sp_ring"),
    ("fault_no_model", "lm_tp_sp_ring"),
    ("fault_pipe_crossed", "lm_pp_sp")])
def test_planted_faults_read_ten_times_the_tolerance(world, fault, ref):
    """An unweighted per-chunk MLM mean; the whole gradients averaged over
    data x model without seq, or (each model rank's gradient shifted) over
    data x seq without model; the pipe hop sent to the other seq index.
    Each lies at least 10 times the tolerance from the JAX run on every
    rank."""
    cases, refs = world
    readings = [_excess(res, refs[ref]) for res in cases[fault]]
    print(f"{fault}: {readings} x the tolerance")
    assert min(readings) >= 10


@pytest.mark.parametrize("case,kind,match", [
    ("tp_sp_mismatch", "ValueError",
     "seq x model group were fed different batches"),
    ("pp_sp_mismatch", "ValueError",
     "seq x pipe group were fed different batches"),
    ("tp_sp_graph_mismatch", "ValueError",
     "seq x model group were fed different batches"),
    ("pp_sp_graph_mismatch", "ValueError",
     "seq x pipe group were fed different batches"),
    ("expert_seq", "NotImplementedError", "item 10\\(i\\)"),
    ("ulysses_heads", "ValueError",
     "ulysses needs heads \\(3\\) divisible by seq-axis size \\(2\\)"),
    ("pa_no_seq_dim", "ValueError", "needs seq_dim")])
def test_what_a_composed_mesh_refuses(world, case, kind, match):
    import re
    cases, _ = world
    for res in cases[case]:
        assert res is not None and res[0] == kind, res
        assert re.search(match, res[1]), res[1]


@pytest.mark.parametrize("case", ["lm_tp_sp_ring", "lm_tp_sp_ulysses",
                                  "lm_pp_sp_shift", "lm_pp_sp_1f1b"])
def test_graph_paths_under_composed_axes_match_step_and_jax(world, case):
    """``make_callable(aot=True)``, ``megastep`` and ``run(unroll=2)``
    under ``ModelParallel(SequenceParallel(ring | ulysses, 2), 2)`` on
    ``{data: 1, seq: 2, model: 2}`` and ``SequenceParallel("ring", 2,
    base=Pipeline(2, 2))`` on ``{data: 1, pipe: 2, seq: 2}`` (on the CPU
    the graph's function runs directly, over its static buffers), 4 steps
    of one batch: bitwise the eager steps, and held to the JAX package's
    compiled step (its jit step: under a seq axis its AOT executable and
    megastep fail on this jaxlib) at the eager parity's tolerance."""
    cases, _ = world
    js = jstrategy
    if case.startswith("lm_tp_sp"):
        _, params, loss_fn, tokens = _lm_fixture()
        builder = js.ModelParallel(js.SequenceParallel(case.split("_")[-1],
                                                       2), model_axis=2)
    else:
        _, params, loss_fn, tokens = _lm_fixture(scan_layers=True)
        builder = js.SequenceParallel("ring", 2, base=js.Pipeline(
            num_stages=2, num_microbatches=2))
        assert all(r["schedule"] == case.split("_")[-1]
                   for r in cases["graph_" + case])
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, optax.sgd(0.1), example_batch=tokens))
    want = jax_graph_paths(runner, [tokens] * 4, aot=False, megastep=False)
    held_graph_paths(cases["graph_" + case], want, RTOL, ATOL)
