"""``parallel/moe.py`` and ``ModelParallel(mesh_axis="expert")`` in the
port against the JAX package.

* The numerics of ``apply``, ``dense_apply`` and ``reference_apply`` (the
  counterparts of ``tests/test_moe.py``'s): outputs and aux loss against
  the JAX functions on the same params (``convert.params_from_jax``) and
  inputs, with and without dropped tokens, top_k 1 and 2, f32 and bf16
  compute, and the gradients of each (params and x) against ``jax.grad``;
  ties routed to the lower expert as ``lax.top_k`` routes them; the
  dispatch's ``flops_estimate`` under half the dense path's.
* The ``ModelParallel(..., rules=moe.EXPERT_RULES, mesh_axis="expert")``
  proto equals the JAX builder's at expert axes of 2 and 4 over
  AllReduce, PS and Parallax bases.
* One 4-rank gloo world (subprocesses, ``OMP_NUM_THREADS=1``) on
  ``{data: 2, expert: 2}``, each data replica's rows to both ranks of its
  expert group, trains ``tests/test_moe.py::test_moe_trains_expert_
  parallel``'s model (8 experts, top-2, d 16, h 32, cf 1.25: tokens are
  dropped) with SGD 0.1 for 3 steps:

  - under ``AllReduce()`` (the JAX Runner's GSPMD path: the routing sees
    the global batch) held to the JAX package's run on its 8-device mesh
    at rtol 1e-4, atol 1e-5, and so is ``AllReduce()`` on ``{data: 4}``
    with no expert axis (``dense_apply``'s aux loss too);
  - under ``PS()`` (its explicit path: each data shard a batch of its
    own) held to the mean of the JAX ``loss_fn`` and its gradients over
    the port's two data shards;
  - the planted faults each read above that tolerance: the copy-to-expert
    backward dropped, the aux loss's gradient summed over the expert
    group, the gathered gate gradient left undivided, and the per-shard
    capacity under AllReduce;
  - each rank's expert products take E/ep experts, and the expert and
    data groups' collectives run; replicated parameters are bitwise equal
    across the world and the pieces differ;
  - the graph paths (``make_callable(aot=True)``, ``megastep``,
    ``run(unroll=2)``) under AllReduce and PS are bitwise their eager
    steps and held to the same JAX references;
  - an expert group fed two batches raises (at the graph paths' first
    call too), so does an ``{expert, seq}`` mesh (item 10(i)-seq;
    ``{expert, model}`` trains: ``tests/test_torch_two_axis.py``);
  - the EP world's checkpoint restores bitwise on one rank.
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
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import path_to_name as jpath_to_name
from autodist_tpu.parallel import moe as jmoe
from autodist_tpu_torch import AutoDist, convert, strategy
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.parallel import moe
from autodist_tpu_torch.parallel.sharding_rules import expert_pieces
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
from test_torch_ps_strategies import (GRAPH_PATHS, held_graph_paths,
                                      jax_graph_paths)

WORLD = 4
STEPS = 3
LR = 0.1
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _reset_singletons():
    autodist_mod._reset_default()
    _jreset()
    yield
    autodist_mod._reset_default()
    _jreset()


def _configs(**kw):
    kw = dict(dict(num_experts=8, top_k=2, d_model=16, d_hidden=32), **kw)
    dtype = kw.pop("dtype", "float32")
    return (jmoe.MoEConfig(dtype=getattr(jnp, dtype), **kw),
            moe.MoEConfig(dtype=getattr(torch, dtype), **kw))


def _params(jcfg, seed=0):
    """(JAX params on the host, the port's copy)."""
    jp = jax.device_get(jmoe.init(jax.random.PRNGKey(seed), jcfg))
    return jp, convert.params_from_jax(jp, "cpu")


def _drops(jp, jcfg, x):
    """How many of the JAX dispatch's assignments its capacity drops."""
    flat = np.asarray(x, np.float32).reshape(-1, jcfg.d_model)
    gates = jax.nn.softmax(flat @ jp["gate"]["kernel"], axis=-1)
    _, idx = jax.lax.top_k(gates, jcfg.top_k)
    t = flat.shape[0]
    cap = min(t, max(1, int(np.ceil(t * jcfg.top_k / jcfg.num_experts *
                                    jcfg.capacity_factor))))
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=jcfg.num_experts)
    return int(np.maximum(counts - cap, 0).sum())


# -- the functions ------------------------------------------------------------

_FNS = {"apply": (jmoe.apply, moe.apply),
        "dense_apply": (jmoe.dense_apply, moe.dense_apply),
        "reference_apply": (lambda p, c, x: (jmoe.reference_apply(p, c, x),
                                             None),
                            lambda p, c, x: (moe.reference_apply(p, c, x),
                                             None))}


def _tols(dtype):
    """(rtol, atol). f32: the JAX test's own 1e-5 (both sum f32 products in
    another order). bf16 (x, and the expert products for apply /
    dense_apply): the bf16 output may round the other way, one ulp (2^-8
    relative; 2e-3 at the outputs' |y| < 0.5), after products that XLA's
    and PyTorch's CPU kernels round at other places."""
    return (1e-5, 1e-5) if dtype == "float32" else (1e-2, 2e-3)


# apply at a capacity that drops tokens and at one that cannot; the other
# two never drop (at cf 1.25 the routing they share would).
_CASES = pytest.mark.parametrize("fn,cf", [
    ("apply", 1.25), ("apply", 8.0), ("dense_apply", 1.25),
    ("reference_apply", 1.25)], ids=["apply-dropping", "apply-dropfree",
                                     "dense_apply", "reference_apply"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
@_CASES
def test_function_matches_jax(fn, cf, top_k, dtype):
    """Output (x (2, 12, 16) in the compute dtype) and aux loss; at cf 1.25
    the JAX
    dispatch drops tokens (asserted), which ``apply`` drops alike; the
    other two never drop."""
    jcfg, cfg = _configs(top_k=top_k, capacity_factor=cf, dtype=dtype)
    jp, p = _params(jcfg)
    x = np.random.RandomState(1).randn(2, 12, 16).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    assert (_drops(jp, jcfg, x) > 0) == (cf < 2)
    jfn, fn_ = _FNS[fn]
    want, waux = jfn(jp, jcfg, x)
    xt = convert.params_from_jax({"x": x}, "cpu")["x"]
    got, aux = fn_(p, cfg, xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == x.shape
    rtol, atol = _tols(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)
    if waux is not None:
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
@_CASES
def test_gradients_match_jax(fn, cf, top_k):
    """d(sum(out * c) + aux) / d(params, x) against ``jax.grad`` (f32):
    rtol 1e-4, atol 1e-6 (the backward sums more products, in another
    order)."""
    jcfg, cfg = _configs(top_k=top_k, capacity_factor=cf)
    jp, p = _params(jcfg)
    rng = np.random.RandomState(2)
    x = rng.randn(24, 16).astype(np.float32)
    c = rng.randn(24, 16).astype(np.float32)
    jfn, fn_ = _FNS[fn]

    def jloss(params, xx):
        out, aux = jfn(params, jcfg, xx)
        return jnp.sum(out * c) + (0.0 if aux is None else aux)
    wp, wx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    leaves = {path_to_name(k): t.requires_grad_() for k, t in
              flatten_with_path(p)[0]}
    xt = torch.tensor(x, requires_grad=True)
    out, aux = fn_(p, cfg, xt)
    loss = torch.sum(out * torch.as_tensor(c)) + (0.0 if aux is None
                                                  else aux)
    got = torch.autograd.grad(loss, list(leaves.values()) + [xt])
    want = {jpath_to_name(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(wp)[0]}
    for name, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(wx), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_products_as_named_einsums_are_bitwise_the_bmms(dtype,
                                                               monkeypatch):
    """``apply``'s two expert products run through ``utils/scope.einsum``
    with the JAX package's specs (``"ecd,edh->ech"``, ``"ech,ehd->ecd"``),
    so the step text and the per-scope costs name them as the JAX op
    metadata does. Output, aux and every gradient are bitwise those of the
    bare ``torch.bmm`` calls the einsums replaced (tolerance 0)."""
    jcfg, cfg = _configs(dtype=dtype)
    _, p = _params(jcfg)
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(24, 16).astype(np.float32))
    c = torch.tensor(rng.randn(24, 16).astype(np.float32))

    def run():
        params = {path_to_name(k): t.detach().clone().requires_grad_()
                  for k, t in flatten_with_path(p)[0]}
        tree = {"gate": {"kernel": params["gate/kernel"]},
                "up": {"kernel": params["up/kernel"]},
                "down": {"kernel": params["down/kernel"]}}
        xt = x.clone().requires_grad_()
        out, aux = moe.apply(tree, cfg, xt)
        loss = torch.sum(out.float() * c) + aux
        return [out, aux] + list(torch.autograd.grad(
            loss, list(params.values()) + [xt]))
    got = run()
    monkeypatch.setattr(moe, "einsum", lambda spec, a, b: torch.bmm(a, b))
    want = run()
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ties_route_to_the_lower_expert_as_lax_top_k():
    """A zero gate kernel gives every expert the same probability: both
    packages route each token to experts 0..k-1 in that order, so the
    outputs agree (drops included: every token claims expert 0 first)."""
    jcfg, cfg = _configs(top_k=2)
    jp, p = _params(jcfg)
    jp["gate"]["kernel"] = np.zeros_like(jp["gate"]["kernel"])
    p["gate"]["kernel"].zero_()
    g = torch.tensor([[0.25, 0.5, 0.25, 0.5], [0.1, 0.1, 0.1, 0.1]])
    vals, idx = moe._top_k(g, 3)
    wvals, widx = jax.lax.top_k(np.asarray(g), 3)
    assert idx.tolist() == np.asarray(widx).tolist() == [[1, 3, 0],
                                                         [0, 1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wvals))
    x = np.random.RandomState(3).randn(10, 16).astype(np.float32)
    want, _ = jmoe.apply(jp, jcfg, x)
    got, _ = moe.apply(p, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_capacity_dispatch_flops_reduction():
    """``tests/test_moe.py``'s counterpart: at E 8, k 2, cf 1 the
    dispatch's ``flops_estimate`` (its products counted on ``meta``
    tensors) is under half the dense path's."""
    cfg = moe.MoEConfig(num_experts=8, top_k=2, d_model=64, d_hidden=256,
                        capacity_factor=1.0)
    params = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = np.random.RandomState(1).randn(256, 64).astype(np.float32)

    def flops_of(fn):
        item = GraphItem.capture(lambda p, b: fn(p, cfg, b)[0].sum(),
                                 params, None, example_batch=x)
        return item.flops_estimate()
    dispatch, dense = flops_of(moe.apply), flops_of(moe.dense_apply)
    # The expert products: 2 x (E C) x d x h each, C = 64.
    assert dispatch >= 2 * 2 * 8 * 64 * 64 * 256
    assert dispatch < 0.5 * dense, (dispatch, dense)


def test_init_tree_and_conversion_match_jax():
    """The port's init has the JAX tree (shapes, f32) and the glorot scale
    of ``in_axis=-2, out_axis=-1``; a JAX tree crosses bitwise, 3-D expert
    kernels as they are."""
    jcfg, cfg = _configs(d_model=64, d_hidden=256)
    jp, p = _params(jcfg)
    mine = moe.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (path, t), (_, w) in zip(flatten_with_path(mine)[0],
                                 flatten_with_path(p)[0]):
        assert t.shape == w.shape and t.dtype == w.dtype == torch.float32
        # Same distribution: the std within 10% of the JAX init's.
        assert abs(float(t.std()) / float(w.std()) - 1) < 0.1, path
    for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = dict((path_to_name(q), t) for q, t in
                   flatten_with_path(p)[0])[jpath_to_name(k)]
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    assert tuple(p["up"]["kernel"].shape) == (8, 64, 256)


def test_init_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init(torch.Generator().manual_seed(0), moe.MoEConfig())


def test_dense_and_reference_refuse_expert_pieces():
    _, cfg = _configs()
    p = moe.init(None, cfg, device="cpu")
    p["up"]["kernel"] = p["up"]["kernel"][:4]
    for fn in (moe.dense_apply, moe.reference_apply):
        with pytest.raises(ValueError, match="whole up/kernel"):
            fn(p, cfg, torch.zeros(3, 16))


@pytest.mark.parametrize("split,want", [
    ({}, set()),
    ({"moe/up/kernel": 0, "moe/down/kernel": 0, "moe/gate/kernel": 1},
     {"moe/up/kernel", "moe/down/kernel"}),
    ({"moe/up/kernel": 0}, set()),
    ({"moe/up/kernel": 0, "moe/down/kernel": 1}, set()),
    ({"l/moe/up/kernel": 0, "l/moe/down/kernel": 0, "moe/up/kernel": 0},
     {"l/moe/up/kernel", "l/moe/down/kernel"})])
def test_expert_pieces_take_both_expert_kernels_split_on_dim_0(split, want):
    """A ``moe`` scope's up and down kernels reach the layer as pieces only
    when both are split on the experts (dim 0); the gate is gathered."""
    names = ["moe/gate/kernel", "moe/up/kernel", "moe/down/kernel",
             "l/moe/up/kernel", "l/moe/down/kernel", "head/kernel"]
    assert expert_pieces(names, split) == want


# -- the builder --------------------------------------------------------------


def _model(seed=0):
    """``tests/test_moe.py::test_moe_trains_expert_parallel``'s model: (JAX
    config, JAX params on the host)."""
    jcfg, _ = _configs()
    k = jax.random.PRNGKey(seed)
    return jcfg, jax.device_get(
        {"moe": jmoe.init(k, jcfg),
         "head": {"kernel": jax.random.normal(k, (16, 4)) * 0.1}})


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(16, 16).astype(np.float32),
             rng.randint(0, 4, (16,)).astype(np.int32))
            for _ in range(STEPS)]


def _jloss(jcfg, fn=jmoe.apply):
    def loss_fn(p, batch):
        x, labels = batch
        h, aux = fn(p["moe"], jcfg, x)
        logits = h @ p["head"]["kernel"]
        ce = -jnp.mean(jax.nn.log_softmax(logits)[
            jnp.arange(labels.shape[0]), labels])
        return ce + 0.01 * aux
    return loss_fn


def _loss(cfg):
    def loss_fn(p, batch):
        x, labels = batch
        h, aux = moe.apply(p["moe"], cfg, x)
        logits = h @ p["head"]["kernel"]
        ce = -torch.log_softmax(logits, -1)[
            torch.arange(labels.shape[0], device=labels.device),
            labels.long()].mean()
        return ce + 0.01 * aux
    return loss_fn


def _spec_text(n):  # tests/test_torch_ps_strategies.py's
    return ("nodes:\n  - address: 10.0.0.1\n    gpus: [" +
            ", ".join(str(i) for i in range(n)) + "]\n    chief: true\n")


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("base", ["AllReduce", "PS", "Parallax"])
def test_expert_parallel_proto_matches_jax(tmp_path, base, ep):
    """The whole proto, ids aside: ``expert`` carved out of ``data`` and
    the ``"0:<ep>:expert"`` / ``"1:<ep>:expert"`` partitioners."""
    jcfg, jp = _model()
    _, cfg = _configs()
    batch = _batches()[0]
    jitem = JGraphItem.capture(_jloss(jcfg), jp, optax.sgd(LR),
                               example_batch=batch)
    item = GraphItem.capture(_loss(cfg), convert.params_from_jax(jp, "cpu"),
                             None, example_batch=batch)
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(8))
    want = jstrategy.ModelParallel(
        getattr(jstrategy, base)(), model_axis=ep, rules=jmoe.EXPERT_RULES,
        mesh_axis="expert").build(jitem, jrs.ResourceSpec(str(path)))
    got = strategy.ModelParallel(
        getattr(strategy, base)(), model_axis=ep, rules=moe.EXPERT_RULES,
        mesh_axis="expert").build(item, ResourceSpec(str(path)))
    assert dict(got.graph_config.mesh_axes) == {"data": 8 // ep,
                                                "expert": ep}
    assert {n.var_name: n.partitioner for n in got.node_config
            if n.partitioner} == {"moe/up/kernel": f"0:{ep}:expert",
                                  "moe/down/kernel": f"0:{ep}:expert",
                                  "moe/gate/kernel": f"1:{ep}:expert"}
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.models import layers
from autodist_tpu_torch.parallel import collectives, context, moe
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
res = {}
cfg = moe.MoEConfig(num_experts=8, top_k=2, d_model=16, d_hidden=32)
SGD = functools.partial(torch.optim.SGD, lr=LR)
EP = lambda base: S.ModelParallel(base, model_axis=2, rules=moe.EXPERT_RULES,
                                  mesh_axis="expert")


def loss_fn(p, batch, fn=moe.apply):
    x, labels = batch
    h, aux = fn(p["moe"], cfg, x)
    logits = h @ p["head"]["kernel"]
    ce = -torch.log_softmax(logits, -1)[
        torch.arange(labels.shape[0], device=labels.device),
        labels.long()].mean()
    return ce + 0.01 * aux


def named(tree):
    return {path_to_name(p): t.detach().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}
#GRAPH_PATHS


def session(builder, example, loss=loss_fn):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(loss, inp["params"], SGD, example_batch=example)
    return ad.create_distributed_session(item)


def rows(runner, batch):
    mesh = runner.program.mesh
    per = len(batch[0]) // mesh.shape["data"]
    d = mesh.axis_index("data")
    return tuple(a[d * per:(d + 1) * per] for a in batch)


class Record(TorchDispatchMode):
    """Every bmm's leading (expert) dim."""
    def __init__(self):
        super().__init__()
        self.bmm = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.bmm.append(int(args[0].shape[0]))
        return func(*args, **(kwargs or {}))


def spy():
    """Wrap the collectives: [(name, group ranks, numel)] of every call."""
    calls = []
    real = {n: getattr(dist, n) for n in ("all_reduce",
                                          "all_gather_into_tensor",
                                          "reduce_scatter_tensor")}

    def wrap(n):
        def call(*a, group=None, **kw):
            ranks = sorted(dist.get_process_group_ranks(group)) \
                if group is not None else list(range(world))
            calls.append((n, ranks, int(a[-1].numel())))
            return real[n](*a, group=group, **kw)
        return call
    for n in real:
        setattr(dist, n, wrap(n))
    return calls, lambda: [setattr(dist, n, f) for n, f in real.items()]


def train(builder, record=False, loss=loss_fn):
    runner = session(builder, tuple(a[:2] for a in inp["batches"][0]), loss)
    state = runner.create_state()
    losses, extra = [], {}
    for i, b in enumerate(inp["batches"]):
        if record and i == 0:
            rec = Record()
            calls, restore = spy()
            try:
                with rec:
                    state, m = runner.step(state, rows(runner, b))
            finally:
                restore()
            extra = {"bmm": rec.bmm, "calls": calls}
        else:
            state, m = runner.step(state, rows(runner, b))
        losses.append(float(m["loss"]))
    return runner, state, dict(extra, **{
        "losses": losses, "params": named(runner.logical_params(state)),
        "stored": named(state.params), "kinds": runner.var_kinds,
        "mesh": dict(runner.program.mesh.shape),
        "global_batch": runner.program.parallel_context().global_batch})


def raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None


runner, state, res["ar"] = train(EP(S.AllReduce()), record=True)
mesh = runner.program.mesh
res["ar"]["expert_group"] = sorted(dist.get_process_group_ranks(
    mesh.group("expert")))
res["ar"]["data_group"] = sorted(dist.get_process_group_ranks(
    mesh.group("data")))
mgr = CheckpointManager(runner, os.path.join(out, "ep_ckpt"))
mgr.save(STEPS, state, force=True)
mgr.wait_until_finished()
mgr.close()
mine = rows(runner, inp["batches"][0])
other = (mine[0] + 1 + mesh.axis_index("expert"), mine[1])
res["mismatch"] = raises(lambda: runner.step(state, other))
res["graph_mismatch"] = first_call_raises(runner, other)
GRAPH_BATCHES = [rows(runner, b) for b in inp["batches"][:2]] * 2
res["graph_ar"] = graph_paths(runner, GRAPH_BATCHES)

# The mean over the data group and its backward, alone: rank r's loss is
# sum(c_r * mean_r'(x_r')); its gradient at x_r is the data mean of the
# c's.
group = mesh.group("data")
x = torch.full((3,), float(rank), requires_grad=True)
y = moe._MeanOverGroup.apply(x, group)
c = torch.arange(3.0) * (1 + mesh.axis_index("data"))
(gx,) = torch.autograd.grad((c * y).sum(), [x])
res["mean"] = {"y": y.detach().numpy(), "gx": gx.numpy()}

runner, state, res["ps"] = train(EP(S.PS()), record=True)
res["graph_ps"] = graph_paths(runner, GRAPH_BATCHES)
del runner, state
res["ar_data4"] = train(S.AllReduce())[2]
res["dense_data4"] = train(S.AllReduce(), loss=functools.partial(
    loss_fn, fn=moe.dense_apply))[2]

# The planted faults.
real_route = moe._route


def aux_summed(gates, cfg, group=None):
    top_vals, top_idx, _ = real_route(gates, cfg, group)
    ctx = context.current()
    _, _, aux = real_route(layers.copy_to_model(gates, ctx.expert_group),
                           cfg, group)
    return top_vals, top_idx, aux


def undivided(ctx, grad):
    return (collectives.reduce_scatter(grad, ctx.dim, ctx.group), None, None,
            None)


for key, target, attr, fault in (
        ("no_copy", layers._CopyToModel, "backward",
         staticmethod(lambda ctx, grad: (grad, None))),
        ("aux_summed", moe, "_route", aux_summed),
        ("undivided", collectives.GatherShards, "backward",
         staticmethod(undivided)),
        ("per_shard", context.ParallelContext, "global_batch",
         property(lambda self: False))):
    real = target.__dict__[attr]
    setattr(target, attr, fault)
    try:
        res["fault_" + key] = train(EP(S.AllReduce()))[2]
    finally:
        setattr(target, attr, real)

res["expert_seq"] = raises(lambda: session(
    EP(S.SequenceParallel(seq_axis=2)),
    tuple(a[:2] for a in inp["batches"][0])))
autodist_mod._reset_default()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''.replace("STEPS", str(STEPS)).replace("LR", str(LR)).replace(
    "#GRAPH_PATHS", GRAPH_PATHS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's cases, run once per test session (the first xdist
    worker to need them runs them under a file lock): {case: [rank 0's
    result, ...]}, and the world's directory."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "ep_world"
    with open(shared / "ep_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            _, jp = _model()
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({
                    "params": convert.params_from_jax(jp, "cpu"),
                    "batches": [tuple(torch.as_tensor(a) for a in b)
                                for b in _batches()]}, f)
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


def _named(tree):
    return {jpath_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@functools.lru_cache(maxsize=None)
def _jax_global():
    """The JAX package's ``ModelParallel(AllReduce(), model_axis=2, rules=
    EXPERT_RULES, mesh_axis="expert")`` run on its 8-device mesh ({data:
    4, expert: 2}: its GSPMD path), SGD 0.1: (losses, logical params)."""
    jcfg, jp = _model()
    _jreset()
    ad = JAutoDist(strategy_builder=jstrategy.ModelParallel(
        jstrategy.AllReduce(), model_axis=2, rules=jmoe.EXPERT_RULES,
        mesh_axis="expert"))
    batches = _batches()
    runner = ad.create_distributed_session(ad.capture(
        _jloss(jcfg), jp, optax.sgd(LR), example_batch=batches[0]))
    state = runner.create_state()
    losses = []
    for b in batches:
        state, metrics = runner.step(state, b)
        losses.append(float(jax.device_get(metrics["loss"])))
    return losses, _named(runner.logical_params(state))


def _jax_sgd(loss_of, batches=None):
    """SGD 0.1 over ``batches`` (``_batches()``) from the model's init,
    each step's loss and gradient ``loss_of(params, batch)`` in JAX:
    (losses, params)."""
    _, params = _model()
    losses = []
    for b in batches or _batches():
        loss, grad = jax.value_and_grad(loss_of)(params, b)
        params = jax.tree_util.tree_map(lambda p, g: p - LR * g, params,
                                        grad)
        losses.append(float(loss))
    return losses, _named(params)


@functools.lru_cache(maxsize=None)
def _jax_whole_batch():
    """The JAX ``loss_fn`` on each whole batch (the global semantics)."""
    return _jax_sgd(_jloss(_model()[0]))


@functools.lru_cache(maxsize=None)
def _jax_per_shard(graph=False):
    """The mean of the JAX ``loss_fn`` (and so of its gradients) over the
    port's two data shards of each batch (of ``_graph_batches()`` with
    ``graph``): the explicit path's per-shard semantics."""
    loss_fn = _jloss(_model()[0])
    return _jax_sgd(lambda p, b: (
        loss_fn(p, (b[0][:8], b[1][:8])) + loss_fn(p, (b[0][8:], b[1][8:])))
        / 2, _graph_batches() if graph else None)


def _excess(res, want):
    """How far a rank's run lies from ``want``, in units of the tolerance:
    max over the losses and every param of |a - b| / (ATOL + RTOL |b|). At
    most 1 passes ``assert_allclose``."""
    def worst(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / (ATOL + RTOL * np.abs(b))))
    losses, params = want
    return max([worst(res["losses"], losses)] +
               [worst(res["params"][k], params[k]) for k in params])


def _held(ranks, want, mesh):
    losses, params = want
    for r, res in enumerate(ranks):
        assert res["mesh"] == mesh
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        assert sorted(res["params"]) == sorted(params)
        for k in params:
            np.testing.assert_allclose(res["params"][k], params[k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")


def test_the_batch_drops_tokens_and_the_two_semantics_differ():
    """The trap: with the batch's global capacity (5 for 16 tokens) tokens
    are dropped, and the per-shard semantics (capacity 3 for 8) reads
    above the tolerance from the global one; the JAX GSPMD run is the
    global semantics."""
    jcfg, jp = _model()
    x = _batches()[0][0]
    assert _drops(jp["moe"], jcfg, x) > 0
    assert _drops(jp["moe"], jcfg, x[:8]) + _drops(jp["moe"], jcfg, x[8:]) \
        > 0
    glob, shard = _jax_whole_batch(), _jax_per_shard()
    assert _excess({"losses": shard[0], "params": shard[1]}, glob) > 1
    jrun = _jax_global()
    assert _excess({"losses": jrun[0], "params": jrun[1]}, glob) <= 1


@pytest.mark.parametrize("case,mesh", [
    ("ar", {"data": 2, "expert": 2}), ("ar_data4", {"data": 4})])
def test_allreduce_trains_like_the_jax_gspmd_run(world, case, mesh):
    """Under ``AllReduce()`` (with and without an expert axis) the routing
    sees the global batch: held to the JAX package's run on its 8-device
    mesh."""
    _held(world[case], _jax_global(), mesh)
    assert all(r["global_batch"] for r in world[case])


def test_dense_apply_takes_the_global_aux_under_allreduce(world):
    """``dense_apply`` drops nothing, but its aux loss follows the same
    rule: on ``{data: 4}`` under ``AllReduce()`` it is the global batch's,
    as the JAX ``loss_fn`` over ``dense_apply`` on each whole batch."""
    _held(world["dense_data4"], _jax_sgd(_jloss(_model()[0],
                                                jmoe.dense_apply)),
          {"data": 4})


def test_ps_trains_per_shard_like_the_jax_explicit_path(world):
    """Under ``PS()`` each data shard is a batch of its own: held to the
    mean of the JAX ``loss_fn`` over the port's two data shards."""
    _held(world["ps"], _jax_per_shard(), {"data": 2, "expert": 2})
    assert not any(r["global_batch"] for r in world["ps"])
    assert {k for k, _ in world["ps"][0]["kinds"].values()} == \
        {"tp", "zero1"}


def test_kinds_and_stored_pieces(world):
    kinds = world["ar"][0]["kinds"]
    assert kinds == {"moe/gate/kernel": ("tp", 1), "moe/up/kernel": ("tp", 0),
                     "moe/down/kernel": ("tp", 0), "head/kernel": ("ar", None)}
    stored = world["ar"][0]["stored"]
    assert stored["moe/up/kernel"].shape == (4, 16, 32)
    assert stored["moe/down/kernel"].shape == (4, 32, 16)
    assert stored["moe/gate/kernel"].shape == (16, 4)


@pytest.mark.parametrize("fault", ["no_copy", "aux_summed", "undivided",
                                   "per_shard"])
def test_each_planted_fault_reads_above_the_tolerance(world, fault):
    """The copy-to-expert backward dropped, the aux loss's gradient summed
    over the expert group, the gathered gate gradient left ep times too
    large, and the per-shard capacity under AllReduce each take the run
    off the JAX package's by more than the tolerance the clean run
    meets."""
    want = _jax_global()
    assert max(_excess(r, want) for r in world["ar"]) <= 1
    assert max(_excess(r, want) for r in world["fault_" + fault]) > 1


@pytest.mark.parametrize("case", ["ar", "ps"])
def test_each_rank_computes_its_experts_only(world, case):
    """``tests/test_moe_hlo.py``'s first test: every expert product a rank
    runs (forward and backward) takes E/ep = 4 experts, none all 8."""
    for res in world[case]:
        assert res["bmm"] and set(res["bmm"]) == {4}, res["bmm"]


@pytest.mark.parametrize("case", ["ar", "ps"])
def test_tokens_cross_the_expert_axis_through_collectives(world, case):
    """``tests/test_moe_hlo.py``'s second test: a step all-reduces the
    (T, d) output and the copy-to-expert gradients over the expert group,
    and under AllReduce gathers the (k, E) routing counts and averages the
    aux loss's 2E means over the data group; under PS neither."""
    for r, res in enumerate(world[case]):
        expert = world["ar"][r]["expert_group"]
        data = world["ar"][r]["data_group"]
        calls = res["calls"]
        assert ("all_reduce", expert, 8 * 16) in calls
        assert ("all_gather_into_tensor", expert, 16 * 4) in calls  # gate
        routing = [("all_gather_into_tensor", data, 2 * 8),
                   ("all_reduce", data, 2 * 8)]
        for call in routing:
            assert (call in calls) == (case == "ar"), (call, calls)


@pytest.mark.parametrize("case", ["ar", "ps"])
def test_replicated_params_stay_bitwise_equal_and_pieces_differ(world,
                                                                case):
    ranks = world[case]
    kinds = ranks[0]["kinds"]
    whole = [k for k, (kind, _) in kinds.items() if kind != "tp"]
    pieces = [k for k, (kind, _) in kinds.items() if kind == "tp"]
    assert whole and pieces
    for r in range(1, WORLD):
        for k in whole:
            np.testing.assert_array_equal(ranks[r]["stored"][k],
                                          ranks[0]["stored"][k])
        for k in kinds:
            np.testing.assert_array_equal(ranks[r]["params"][k],
                                          ranks[0]["params"][k])
    for a, b in ((0, 1), (2, 3)):
        for k in pieces:
            assert not np.array_equal(ranks[a]["stored"][k],
                                      ranks[b]["stored"][k]), k


def test_mesh_expert_group_is_the_jax_layout(world):
    """``{data: 2, expert: 2}`` puts ranks 2d and 2d + 1 in one expert
    group: the JAX mesh's rows (``data`` outer, ``expert`` inner)."""
    _jreset()
    jmesh = JAutoDist(strategy_builder=jstrategy.AllReduce()).cluster \
        .build_mesh({"data": 4, "expert": 2})
    rows = [sorted(d.id for d in row) for row in jmesh.devices]
    for r, res in enumerate(world["ar"]):
        assert res["expert_group"] in rows[:2] and r in res["expert_group"]
        assert res["data_group"] == [r % 2, r % 2 + 2]


def test_the_data_mean_backward_is_the_mean_of_the_gradients(world):
    """``_MeanOverGroup`` over the data group {r, r + 2}: the forward the
    mean of the ranks' x, the backward the mean of the incoming
    gradients (rank r's c = (d + 1) [0, 1, 2])."""
    for r, res in enumerate(world["mean"]):
        mates = (r % 2, r % 2 + 2)
        np.testing.assert_allclose(res["y"], np.full(3, np.mean(mates)))
        np.testing.assert_allclose(res["gx"], np.arange(3.0) * 1.5)


def test_expert_group_fed_two_batches_raises(world):
    for r, got in enumerate(world["mismatch"]):
        assert got is not None and got[0] == "ValueError", (r, got)
        assert "expert group were fed different batches" in got[1]


def _graph_batches():
    """The graph paths' 4 steps: the first two batches, twice."""
    return _batches()[:2] * 2


@pytest.mark.parametrize("case", ["ar", "ps"])
def test_graph_paths_under_an_expert_axis_match_step_and_jax(world, case):
    """``make_callable(aot=True)``, ``megastep`` and ``run(unroll=2)`` on
    ``{data: 2, expert: 2}`` (on the CPU the graph's function runs
    directly, over its static buffers), over the first two batches twice:
    bitwise the eager steps, and at the eager parity's tolerance the JAX
    package's ``make_callable(aot=True)`` and ``megastep`` (AllReduce: the
    global routing of its GSPMD run) or, under PS, the same JAX
    per-shard reference the eager steps are held to."""
    if case == "ar":
        jcfg, jp = _model()
        _jreset()
        ad = JAutoDist(strategy_builder=jstrategy.ModelParallel(
            jstrategy.AllReduce(), model_axis=2, rules=jmoe.EXPERT_RULES,
            mesh_axis="expert"))
        runner = ad.create_distributed_session(ad.capture(
            _jloss(jcfg), jp, optax.sgd(LR), example_batch=_batches()[0]))
        want = jax_graph_paths(runner, _graph_batches())
    else:
        losses, params = _jax_per_shard(graph=True)
        want = {"aot": (losses, params), "megastep": (losses, params)}
    held_graph_paths(world["graph_" + case], want, RTOL, ATOL)


def test_expert_group_fed_two_batches_raises_at_the_graph_first_call(world):
    for r, got in enumerate(world["graph_mismatch"]):
        assert got is not None and got[0] == "ValueError", (r, got)
        assert "expert group were fed different batches" in got[1]


@pytest.mark.parametrize("case", ["expert_seq"])
def test_expert_composed_with_model_or_seq_raises_naming_item_10i(world,
                                                                  case):
    """``{expert, seq}`` raises naming 10(i)-seq. ``{expert, model}``
    trains since the port composes the two axes: its nested builder's
    case (``expert_model`` here before) is
    ``tests/test_torch_two_axis.py::test_nested_builders_on_two_axis_
    meshes_train_like_jax[ep_mp-...]``."""
    for got in world[case]:
        assert got is not None and got[0] == "NotImplementedError", got
        assert "10(i)-seq" in got[1]


def test_ep_checkpoint_restores_bitwise_on_one_rank(world):
    """The EP world's ``CheckpointManager`` step restores into a one-rank
    ``AllReduce()`` Runner: every leaf bitwise the EP world's logical
    params (the expert pieces gathered on dim 0, the gate on dim 1)."""
    jcfg, jp = _model()
    _, cfg = _configs()
    ad = AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        _loss(cfg), convert.params_from_jax(jp, "cpu"),
        functools.partial(torch.optim.SGD, lr=LR),
        example_batch=_batches()[0]))
    state = CheckpointManager(runner, world["dir"] / "ep_ckpt") \
        .restore_or_init()
    assert int(state.step) == STEPS
    got = {path_to_name(p): t.detach().numpy() for p, t in
           flatten_with_path(runner.logical_params(state))[0]}
    want = world["ar"][0]["params"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
