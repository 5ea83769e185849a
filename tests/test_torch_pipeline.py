"""Pipeline parallelism in the port against the JAX package.

* The pure functions (``num_schedule_steps``, ``bubble_fraction``,
  ``resolve_skip_idle``, ``resolve_microbatches``, ``stack_stage_params``,
  the cutter's ``_balanced_partition`` / ``_stacked_layer_count``) equal
  the JAX ones over a grid; the executor's ticks (``executor_ticks``)
  differ from the JAX count only where the JAX executor runs its sharded
  conveyor (M % S == 0, S > 2).
* ``Pipeline``'s proto equals the JAX builder's byte for byte on
  ``lm_tiny(scan_layers=True)`` under an explicit, an env, a hint and the
  cutter's own (``auto``) stage count, ``Pipeline()`` with no arguments on
  specs of 2, 4 and 8 devices too; its ``ValueError``s are the JAX ones.
* The cutter against the JAX one: ``top_level_costs``, ``cut_stages``
  (S = 1-4, the stacked and the indexed layout, with and without a
  duck-typed calibration; ``to_json()`` with scopes and boundaries exact,
  FLOPs at rtol 1e-12) and ``resolve_stages``; and
  ``tests/test_pipeline_subsystem.py``'s cutter tests as parity cases
  (scope-less ops rolled into the nearest stage, determinism, the stacked
  layout, the precedence of the stage-count sources).
* ``TransformerConfig(scan_layers=True)``: the port's ``encode`` equals the
  JAX one through ``convert`` (the stacked tree carried across and back),
  and the unstacked model bitwise; ``decode_step`` raises; ``scan_blocks``
  refuses L % S != 0 with the JAX message.
* One 4-rank gloo world (subprocesses, ``OMP_NUM_THREADS=1``):

  - ``pipeline_apply`` over ``tests/test_pipeline.py``'s tanh stages (dim
    16) on ``{data: 1, pipe: 4}`` at M in {4, 6, 8} under every schedule:
    outputs and gradients against the JAX ``pipeline_apply`` on its
    ``{data: 2, pipe: 4}`` mesh at the JAX test's 1e-5; ``shift`` bitwise
    ``sequential`` and ``shift-noskip``, ``1f1b``'s outputs (the loss)
    bitwise ``shift``'s;
  - ``_zoo_lm`` (``tests/test_pipeline_subsystem.py:32``) under
    ``Pipeline(num_stages=2, num_microbatches=4)`` on ``{data: 2, pipe:
    2}``, 4 SGD steps, against the JAX run on its 8-device mesh; every
    schedule bitwise ``shift``; the whole parameters bitwise equal across
    each pipe group, a rank storing half the blocks;
  - the user model of ``tests/test_pipeline.py:127`` (``pipeline_apply``
    in the loss, ``apply_sharding_rules(..., mesh_axis="pipe")``) against
    the JAX run;
  - two planted faults (whole gradients averaged over the data group
    alone; the head counted on every pipe rank) read well beyond the
    tolerance;
  - the 2-stage checkpoint restores bitwise on one process and its next
    step is the world's;
  - the graph paths (``make_callable(aot=True)``, ``megastep``,
    ``run(unroll=2)``) are bitwise the eager steps and match the JAX
    package's ``aot=True`` step and megastep; the schedule's ticks and
    hops count per call of the graph step, and per replay under a
    (faked) capture;
  - a pipe group fed two batches raises (at the graph paths' first call
    too), so does pipe with expert (item 10(j)-expert); pipe with seq
    trains (``tests/test_torch_composed.py``), and so does pipe with model
    (``tests/test_torch_two_axis.py``).
"""
import fcntl
import functools
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import resource_spec as jrs
from autodist_tpu import strategy as jstrategy
from autodist_tpu.autodist import _reset_default as _jreset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import path_to_name as jpath_to_name
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import transformer as jT
from autodist_tpu.parallel import sharding_rules as jsharding
from autodist_tpu.pipeline import cutter as jcutter
from autodist_tpu.pipeline import schedule as jschedule
from autodist_tpu_torch import AutoDist, convert, strategy
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.pipeline import cutter, schedule
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils import cuda_graph
from autodist_tpu_torch.utils.scope import named_scope
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
from test_torch_ps_strategies import (GRAPH_PATHS, held_graph_paths,
                                      jax_graph_paths)

WORLD = 4
DIM = 16
MICRO = (4, 6, 8)
SCHEDULES = ("shift", "sequential", "shift-noskip", "1f1b")
ZOO_STEPS = 4
USER_STEPS = 3
# The end-to-end runs against the JAX package: the JAX pipeline tests' own
# tolerance against one device (tests/test_pipeline.py).
RTOL, ATOL = 1e-4, 1e-5
# pipeline_apply against the JAX function (tests/test_pipeline.py:47).
PA_TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_singletons():
    autodist_mod._reset_default()
    _jreset()
    yield
    autodist_mod._reset_default()
    _jreset()


def _spec_text(n, hint=None):
    text = ("nodes:\n  - address: 10.0.0.1\n    gpus: [" +
            ", ".join(str(i) for i in range(n)) + "]\n    chief: true\n")
    if hint:
        text += f"mesh:\n  pipe: {hint}\n"
    return text


# -- fixtures -----------------------------------------------------------------


def _stages(n_stages=4, dim=DIM, seed=0):
    """``tests/test_pipeline.py``'s tanh stages (numpy)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_stages)
    return [{"w": np.asarray(jax.random.normal(k, (dim, dim)) *
                             (1.0 / np.sqrt(dim))),
             "b": np.zeros((dim,), np.float32)} for k in keys]


def _jstage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _x(num_micro):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (4 * num_micro, DIM), jnp.float32))


def _jmesh(axes):
    devs = np.array(jax.devices()).reshape(*axes.values())
    return JMesh(devs, axis_names=tuple(axes))


def _zoo_cfg(scan=True):
    cfg = jlm.lm_tiny(max_len=16)
    cfg.num_layers = 4
    cfg.scan_layers = scan
    return cfg


def _port_cfg(scan=True):
    cfg = lm.lm_tiny(max_len=16)
    cfg.num_layers = 4
    cfg.scan_layers = scan
    return cfg


def _zoo_lm():
    """``tests/test_pipeline_subsystem.py::_zoo_lm``: (JAX params, JAX
    loss, 6 batches of (16, 17) tokens)."""
    cfg = _zoo_cfg()
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    batches = [jlm.synthetic_batch(cfg, batch_size=16, seq_len=16, seed=s)
               for s in range(6)]
    return params, jlm.make_loss_fn(cfg), batches


def _user_model(n_stages=2):
    """``tests/test_pipeline.py::test_pipelined_model_trains_e2e``'s model
    at ``n_stages``: (numpy params, batch)."""
    stages = _stages(n_stages, DIM)
    k = jax.random.PRNGKey(2)
    params = {"inproj": {"kernel": np.asarray(
                  jax.random.normal(k, (8, DIM)) * 0.3)},
              "stages": {"w": np.stack([s["w"] for s in stages]),
                         "b": np.stack([s["b"] for s in stages])},
              "head": {"kernel": np.asarray(
                  jax.random.normal(k, (DIM, 4)) * 0.3)}}
    rng = np.random.RandomState(0)
    batch = (rng.randn(16, 8).astype(np.float32),
             rng.randint(0, 4, (16,)).astype(np.int32))
    return params, batch


# -- pure functions -----------------------------------------------------------


def _capture_pair(layers):
    """(JAX GraphItem, port GraphItem) of lm_tiny with ``layers`` stacked
    layers (0: the unstacked layout) and batch 12."""
    cfg = _zoo_cfg(scan=layers > 0)
    cfg.num_layers = max(layers, 2)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    batch = jlm.synthetic_batch(cfg, batch_size=12, seq_len=16)
    pcfg = _port_cfg(scan=layers > 0)
    pcfg.num_layers = cfg.num_layers
    return (JGraphItem.capture(jlm.make_loss_fn(cfg), params, optax.sgd(0.1),
                               example_batch=batch),
            GraphItem.capture(lm.make_loss_fn(pcfg),
                              convert.params_from_jax(params, "cpu"), None,
                              example_batch=batch))


PURE = (
    [("num_schedule_steps", (p, m, sc, sch)) for p in (1, 2, 3, 4, 8)
     for m in (1, 4, 6, 8) for sc in (False, True)
     for sch in ("shift", "sequential")] +
    [("bubble_fraction", (p, m, sc)) for p in (2, 3, 4, 8) for m in (4, 6, 8)
     for sc in (None, False, True)] +
    [("resolve_skip_idle", (b, s)) for b in ("cpu", "CPU", "tpu", "gpu",
                                             "cuda", None)
     for s in (False, True)] +
    [("resolve_microbatches", (layers, s, e, env))
     for layers in (2, 4) for s in (2, 4, 5) for e in (None, 3, 8)
     for env in ("", "5")] +
    [("stack_stage_params", (n,)) for n in (1, 2, 4)] +
    [("_balanced_partition", (c, k)) for c in ((1.0,) * 8,
                                               (3.0, 1.0, 1.0, 1.0, 2.0),
                                               (1.0, 2.0, 3.0),
                                               (0.5, 0.5))
     for k in (1, 2, 3, 4)] +
    [("_stacked_layer_count", (layers,)) for layers in (0, 2, 4)])


@pytest.mark.parametrize("fn,args", PURE, ids=[
    f"{f}-{'-'.join(str(a) for a in args)}" for f, args in PURE])
def test_pure_functions_equal_jax(monkeypatch, fn, args):
    if fn in ("num_schedule_steps", "bubble_fraction", "resolve_skip_idle"):
        assert getattr(schedule, fn)(*args) == getattr(jschedule, fn)(*args)
    elif fn == "resolve_microbatches":
        layers, stages, explicit, env = args
        if env:
            monkeypatch.setenv("AUTODIST_MICROBATCHES", env)
        else:
            monkeypatch.delenv("AUTODIST_MICROBATCHES", raising=False)
        jitem, item = _capture_pair(layers)
        assert cutter.resolve_microbatches(item, stages, explicit) == \
            jcutter.resolve_microbatches(jitem, stages, explicit)
    elif fn == "stack_stage_params":
        stages = _stages(args[0])
        got = schedule.stack_stage_params(
            [convert.params_from_jax(s, "cpu") for s in stages])
        want = jax.device_get(jschedule.stack_stage_params(stages))
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    elif fn == "_balanced_partition":
        costs, k = args
        assert cutter._balanced_partition(list(costs), k) == \
            jcutter._balanced_partition(list(costs), k)
    else:
        jitem, item = _capture_pair(args[0])
        assert cutter._stacked_layer_count(item) == \
            jcutter._stacked_layer_count(jitem) == args[0]


@pytest.mark.parametrize("p,m", [(p, m) for p in (1, 2, 3, 4)
                                 for m in (2, 4, 6, 8)])
def test_executor_ticks_against_the_jax_count(p, m):
    """The port's executor always broadcasts (``M + S - 1`` ticks, ``M S``
    sequential); the JAX executor runs its sharded conveyor (``M + 2S -
    3``) when M % S == 0 and S > 1: the two agree at S = 2 (Queue C)."""
    sharded = m % p == 0 and p > 1
    for sch in ("shift", "sequential", "shift-noskip", "1f1b"):
        jsch = "sequential" if sch == "sequential" else "shift"
        want = jschedule.num_schedule_steps(p, m, False, jsch)
        assert schedule.executor_ticks(p, m, sch) == want
        conveyor = jschedule.num_schedule_steps(p, m, sharded, jsch)
        assert (schedule.executor_ticks(p, m, sch) == conveyor) == \
            (not sharded or p == 2 or jsch == "sequential")


# -- the builder --------------------------------------------------------------


def _items(scan=True):
    cfg = jlm.lm_tiny(max_len=16)
    cfg.scan_layers = scan
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    batch = jlm.synthetic_batch(cfg, batch_size=8, seq_len=16)
    pcfg = lm.lm_tiny(max_len=16)
    pcfg.scan_layers = scan
    return (JGraphItem.capture(jlm.make_loss_fn(cfg), params, optax.sgd(0.1),
                               example_batch=batch),
            GraphItem.capture(lm.make_loss_fn(pcfg),
                              convert.params_from_jax(params, "cpu"), None,
                              example_batch=batch))


@pytest.mark.parametrize("how", ["explicit", "env", "hint", "auto"])
@pytest.mark.parametrize("base", ["AllReduce", "PS"])
def test_pipeline_proto_matches_jax(monkeypatch, tmp_path, how, base):
    jitem, item = _items()
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(8, hint=2 if how == "hint" else None))
    if how == "env":
        monkeypatch.setenv("AUTODIST_PIPELINE_STAGES", "2")
    kwargs = {"num_stages": 2} if how == "explicit" else {}
    want = jstrategy.Pipeline(base=getattr(jstrategy, base)(),
                              **kwargs).build(jitem,
                                              jrs.ResourceSpec(str(path)))
    got = strategy.Pipeline(base=getattr(strategy, base)(), **kwargs).build(
        item, ResourceSpec(str(path)))
    assert dict(got.graph_config.mesh_axes) == {"data": 4, "pipe": 2}
    assert got.graph_config.pipeline_microbatches == 4
    split = {n.var_name: n.partitioner for n in got.node_config
             if n.partitioner.endswith(":pipe")}
    assert split and all(k.startswith("blocks/") for k in split)
    assert set(split.values()) == {"0:2:pipe"}
    assert cutter.last_cut().source == how
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()


def _both_raise(jbuild, build):
    with pytest.raises(ValueError) as want:
        jbuild()
    with pytest.raises(ValueError) as got:
        build()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["stages_0", "unresolved", "indivisible",
                                  "no_match"])
def test_pipeline_value_errors_are_the_jax_ones(tmp_path, case):
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(8))
    spec, jspec = ResourceSpec(str(path)), jrs.ResourceSpec(str(path))
    if case == "stages_0":
        _both_raise(lambda: jstrategy.Pipeline(num_stages=0),
                    lambda: strategy.Pipeline(num_stages=0))
        return
    jitem, item = _items(scan=case != "unresolved")
    kwargs = {"unresolved": {}, "indivisible": {"num_stages": 4},
              "no_match": {"num_stages": 2,
                           "stage_pattern": r"^nothing/"}}[case]
    _both_raise(lambda: jstrategy.Pipeline(**kwargs).build(jitem, jspec),
                lambda: strategy.Pipeline(**kwargs).build(item, spec))


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_pipeline_with_no_arguments_builds_the_jax_proto(tmp_path, devices):
    """``Pipeline()``: the cutter's own stage count (8 stacked layers:
    the largest divisor of the devices, the least step share)."""
    jitem, item = _cut_pair("stacked", 8)
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    want = jstrategy.Pipeline().build(jitem, jrs.ResourceSpec(str(path)))
    got = strategy.Pipeline().build(item, ResourceSpec(str(path)))
    assert dict(got.graph_config.mesh_axes) == {
        "data": 1, "pipe": devices}
    assert cutter.last_cut().source == "auto"
    assert cutter.last_cut().num_stages == devices
    got.proto.id = want.proto.id = ""
    assert got.proto.SerializeToString() == want.proto.SerializeToString()


# -- the cutter ---------------------------------------------------------------

CUT_RTOL = 1e-12
SGD = functools.partial(torch.optim.SGD, lr=0.1)


class _Calibration:
    """A duck-typed calibration: ``scope_scales()`` as the JAX
    ``Calibration`` returns it."""

    def scope_scales(self):
        return {"layer1": {"compute": 2.0}, "blocks": {"compute": 0.5},
                "embed": {"compute": 3.0}, "lm_head": {"compute": 1.5}}


def _cut_pair(layout, layers=4):
    """(JAX GraphItem, port GraphItem) of lm_tiny with ``layers`` layers
    in the ``stacked`` or the ``indexed`` layout, batch 8 x 16."""
    cfg, pcfg = _zoo_cfg(scan=layout == "stacked"), \
        _port_cfg(scan=layout == "stacked")
    cfg.num_layers = pcfg.num_layers = layers
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    batch = jlm.synthetic_batch(cfg, batch_size=8, seq_len=16)
    return (JGraphItem.capture(jlm.make_loss_fn(cfg), params, optax.sgd(0.1),
                               example_batch=batch),
            GraphItem.capture(lm.make_loss_fn(pcfg),
                              convert.params_from_jax(params, "cpu"), SGD,
                              example_batch=batch))


def _same_cut(got, want):
    """``to_json()`` equal: scopes and boundaries exact, FLOPs at
    ``CUT_RTOL``."""
    g, w = got.to_json(), want.to_json()
    flops = lambda d: [d["total_flops"]] + [  # noqa: E731
        s["flops"] for s in d["stages"]]
    np.testing.assert_allclose(flops(g), flops(w), rtol=CUT_RTOL)
    for d in (g, w):
        d.pop("total_flops")
        for st in d["stages"]:
            st.pop("flops")
    assert g == w


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("num_stages", [1, 2, 3, 4])
@pytest.mark.parametrize("layout", ["stacked", "indexed"])
def test_cutter_matches_jax(layout, num_stages, calibrated):
    jitem, item = _cut_pair(layout)
    calib = _Calibration() if calibrated else None
    want = jcutter.top_level_costs(jitem, calib)
    got = cutter.top_level_costs(item, calib)
    assert [g[0] for g in got] == [w[0] for w in want]
    # The port's blocks group holds its L layers; the JAX scan body once.
    np.testing.assert_allclose(
        [g[1] for g in got],
        [w[1] * (4 if w[0] == "blocks" else 1) for w in want],
        rtol=CUT_RTOL)
    cut = cutter.cut_stages(item, num_stages, calibration=calib)
    _same_cut(cut, jcutter.cut_stages(jitem, num_stages, calibration=calib))
    if not calibrated:
        assert sum(st["flops"] for st in cut.stages) == \
            cut.total_flops == item.flops_estimate()


@pytest.mark.parametrize("layers", [4, 8])
@pytest.mark.parametrize("devices", [2, 4, 8])
def test_resolve_stages_matches_jax(tmp_path, monkeypatch, devices, layers):
    monkeypatch.delenv("AUTODIST_PIPELINE_STAGES", raising=False)
    jitem, item = _cut_pair("stacked", layers)
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(devices))
    got = cutter.resolve_stages(item, ResourceSpec(str(path)))
    assert got == jcutter.resolve_stages(jitem, jrs.ResourceSpec(str(path)))
    assert got == (min(devices, layers), "auto")


def _indexed_layer_models():
    """``tests/test_pipeline_subsystem.py::_indexed_layer_model`` in both
    packages: three indexed layer scopes, a scope-less matmul between them
    and an unscoped prelude."""
    params = {"layer0": {"w": np.ones((8, 8), np.float32)},
              "mid": np.ones((8, 8), np.float32),
              "layer1": {"w": np.ones((8, 32), np.float32)},
              "layer2": {"w": np.ones((32, 8), np.float32)},
              "pre": np.ones((8, 8), np.float32)}

    def jloss(p, b):
        x = b @ p["pre"]
        with jax.named_scope("layer0"):
            x = jnp.tanh(x @ p["layer0"]["w"])
        x = x @ p["mid"]
        with jax.named_scope("layer1"):
            x = jnp.tanh(x @ p["layer1"]["w"])
        with jax.named_scope("layer2"):
            x = jnp.tanh(x @ p["layer2"]["w"])
        return jnp.mean(x ** 2)

    def loss(p, b):
        x = b @ p["pre"]
        with named_scope("layer0"):
            x = torch.tanh(x @ p["layer0"]["w"])
        x = x @ p["mid"]
        with named_scope("layer1"):
            x = torch.tanh(x @ p["layer1"]["w"])
        with named_scope("layer2"):
            x = torch.tanh(x @ p["layer2"]["w"])
        return torch.mean(x ** 2)
    batch = np.ones((4, 8), np.float32)
    return (JGraphItem.capture(jloss, params, optax.sgd(0.1),
                               example_batch=batch),
            GraphItem.capture(loss, convert.params_from_jax(params, "cpu"),
                              SGD, example_batch=batch))


@pytest.mark.parametrize("num_stages", [2, 3])
def test_cutter_rolls_unattributed_into_the_nearest_stage(num_stages):
    jitem, item = _indexed_layer_models()
    cut = cutter.cut_stages(item, num_stages)
    _same_cut(cut, jcutter.cut_stages(jitem, num_stages))
    total = sum(st["flops"] for st in cut.stages)
    assert total == item.flops_estimate() == jitem.flops_estimate()
    scoped = sum(r["flops"] for r in item.op_provenance() if r["scope"])
    assert total > scoped  # the scope-less matmuls landed in a stage
    assert "layer0" in cut.stages[0]["scopes"]


def test_cutter_is_deterministic():
    jitem, item = _indexed_layer_models()
    a = cutter.cut_stages(item, 2).to_json()
    assert a == cutter.cut_stages(item, 2).to_json() == \
        cutter.cut_stages(_indexed_layer_models()[1], 2).to_json()
    _same_cut(cutter.cut_stages(item, 3), jcutter.cut_stages(jitem, 3))


def test_cutter_stacked_blocks_layout():
    jitem, item = _cut_pair("stacked")
    cut = cutter.cut_stages(item, 2)
    _same_cut(cut, jcutter.cut_stages(jitem, 2))
    assert cut.num_layers == 4 and cut.num_stages == 2
    assert cut.imbalance == 0.0
    assert [st["scopes"] for st in cut.stages] == [
        ("embed", "blocks[0]", "blocks[1]"),
        ("blocks[2]", "blocks[3]", "ln_f", "lm_head")]


def test_resolve_stages_precedence(tmp_path, monkeypatch):
    jitem, item = _cut_pair("stacked")
    path = tmp_path / "spec.yml"
    path.write_text(_spec_text(4))
    spec, jspec = ResourceSpec(str(path)), jrs.ResourceSpec(str(path))
    monkeypatch.setenv("AUTODIST_PIPELINE_STAGES", "2")
    assert cutter.resolve_stages(item, spec) == \
        jcutter.resolve_stages(jitem, jspec) == (2, "env")
    monkeypatch.delenv("AUTODIST_PIPELINE_STAGES")
    assert cutter.resolve_stages(item, spec) == \
        jcutter.resolve_stages(jitem, jspec) == (4, "auto")
    assert cutter.resolve_stages(item, spec, explicit=2) == \
        jcutter.resolve_stages(jitem, jspec, explicit=2) == (2, "explicit")
    path.write_text(_spec_text(4, hint=2))
    assert cutter.resolve_stages(item, ResourceSpec(str(path))) == \
        jcutter.resolve_stages(jitem, jrs.ResourceSpec(str(path))) == \
        (2, "hint")


def test_pipeline_name_resolves():
    from autodist_tpu.tuner.auto import builder_from_name as jfrom_name
    got = strategy.builder_from_name("pipeline")
    assert type(got).__name__ == type(jfrom_name("pipeline")).__name__ == \
        "Pipeline"


# -- scan_layers --------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_scan_layers_encode_matches_jax_and_the_unstacked_model(causal):
    """JAX params of the stacked layout carried across by ``convert``: the
    port's ``encode`` equals the JAX one (rtol / atol 1e-5, f32), and the
    same weights unstacked give the port's bits."""
    cfg = _zoo_cfg()
    cfg.causal = causal
    params = jax.device_get(jT.init(jax.random.PRNGKey(3), cfg))
    ids = np.random.RandomState(0).randint(0, cfg.vocab, (4, 16))
    want = np.asarray(jT.encode(params, cfg, jnp.asarray(ids)))
    pcfg = _port_cfg()
    pcfg.causal = causal
    got_params = convert.params_from_jax(params, "cpu")
    assert tuple(got_params["blocks"]["mlp"]["up"]["kernel"].shape) == \
        (4, 64, 256)
    got = T.encode(got_params, pcfg, torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    flat = {k: v for k, v in got_params.items() if k != "blocks"}
    for i in range(4):
        flat[f"layer{i}"] = jax.tree_util.tree_map(
            lambda l: l[i], got_params["blocks"])
    ucfg = _port_cfg(scan=False)
    ucfg.causal = causal
    assert torch.equal(T.encode(flat, ucfg, torch.as_tensor(ids)), got)


def test_scan_layers_init_stacks_the_unstacked_draws():
    """The port's init draws the same layers in either layout."""
    stacked = T.init(_port_cfg(), torch.Generator().manual_seed(0), "cpu")
    flat = T.init(_port_cfg(scan=False), torch.Generator().manual_seed(0),
                  "cpu")
    for i in range(4):
        want = {path_to_name(p): t for p, t in
                flatten_with_path(flat[f"layer{i}"])[0]}
        got = {path_to_name(p): t[i] for p, t in
               flatten_with_path(stacked["blocks"])[0]}
        assert sorted(got) == sorted(want)
        for name, t in want.items():
            assert torch.equal(got[name], t), name
    assert torch.equal(stacked["embed"]["embedding"],
                       flat["embed"]["embedding"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_the_stacked_tree_both_ways(dtype):
    """``params_from_jax`` / ``params_to_numpy`` keep the ``blocks``
    tree's keys, leading layer dim and bits."""
    cfg = _zoo_cfg()
    params = jax.device_get(jlm.init(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map(
        lambda l: np.asarray(jnp.asarray(l, getattr(jnp, dtype))), params)
    back = convert.params_to_numpy(convert.params_from_jax(params, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict((jpath_to_name(p), l) for p, l in
               jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(got) == sorted(jpath_to_name(p) for p, _ in want)
    for p, l in want:
        g = got[jpath_to_name(p)]
        assert g.shape == l.shape and g.dtype == l.dtype
        np.testing.assert_array_equal(g.view(np.uint8), l.view(np.uint8))
    assert got["blocks/attn/query/kernel"].shape[0] == 4


def test_decode_step_refuses_scan_layers():
    cfg = _port_cfg()
    with pytest.raises(NotImplementedError) as got:
        T.decode_step({}, cfg, {}, torch.zeros(2), torch.zeros(2))
    with pytest.raises(NotImplementedError) as want:
        jT.decode_step({}, _zoo_cfg(), {}, jnp.zeros(2), jnp.zeros(2))
    assert str(got.value) == str(want.value)


def test_scan_blocks_refuses_layers_the_stages_do_not_divide():
    """Three stacked layers over a pipe axis of 2: the JAX ``ValueError``."""
    from autodist_tpu.ops import scan_blocks as jscan
    from autodist_tpu.parallel import context as jctx
    from autodist_tpu_torch.cluster import Mesh
    from autodist_tpu_torch.ops import scan_blocks
    from autodist_tpu_torch.parallel import context as ctx_mod
    stacked = {"w": np.ones((3, 4, 4), np.float32)}
    jc = jctx.ParallelContext(_jmesh({"data": 4, "pipe": 2}),
                              pipeline_microbatches=2)
    with jctx.use(jc), pytest.raises(ValueError) as want:
        jscan(stacked, lambda p, a: a @ p["w"], jnp.ones((4, 4)))
    devices = np.empty(2, dtype=object)
    devices[:] = [torch.device("cpu")] * 2
    pc = ctx_mod.ParallelContext(Mesh(devices.reshape(1, 2),
                                      ("data", "pipe")),
                                 pipeline_microbatches=2)
    with ctx_mod.use(pc), pytest.raises(ValueError) as got:
        scan_blocks({"w": torch.ones(3, 4, 4)}, lambda p, a: a @ p["w"],
                    torch.ones(4, 4))
    assert str(got.value) == str(want.value)


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, hashlib, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.cluster import Cluster
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.parallel import moe
from autodist_tpu_torch.parallel.sharding_rules import apply_sharding_rules
from autodist_tpu_torch.pipeline import schedule
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
res = {}


def named(tree):
    return {path_to_name(p): t.detach().float().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}
#GRAPH_PATHS


def raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return type(e).__name__, str(e)
    return None


# pipeline_apply on {data: 1, pipe: 4}.
cluster = Cluster(ResourceSpec.local("cpu"))
cluster.start("cpu")
mesh = cluster.build_mesh({"data": 1, "pipe": world})
fn = lambda p, x: torch.tanh(x @ p["w"] + p["b"])
for m in MICRO:
    for sched in SCHEDULES:
        stacked = {k: v.clone().requires_grad_()
                   for k, v in inp["stages"].items()}
        x = inp["x"][m].clone().requires_grad_()
        schedule.counts.update(forward_ticks=0, backward_ticks=0, hops=0)
        y = schedule.pipeline_apply(stacked, fn, x, m, mesh, schedule=sched)
        # Every rank computes the loss whole: its backward is seeded 1 / S.
        (y ** 2).mean().backward(torch.tensor(1.0 / world))
        res[f"pa_{m}_{sched}"] = {
            "out": y.detach().numpy().copy(),
            "w": stacked["w"].grad.numpy().copy(),
            "b": stacked["b"].grad.numpy().copy(),
            "x": None if x.grad is None else x.grad.numpy().copy(),
            "counts": dict(schedule.counts)}
cluster.terminate()

# The zoo LM under Pipeline(2, 4) on {data: 2, pipe: 2}.
zcfg = lm.lm_tiny(max_len=16)
zcfg.num_layers, zcfg.scan_layers = 4, True
SGD = functools.partial(torch.optim.SGD, lr=0.1)


def session(builder, loss_fn, params, opt, example, mesh_axes=None):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, mesh_axes=mesh_axes,
                  device="cpu")
    item = ad.capture(loss_fn, params, opt, example_batch=example)
    return ad.create_distributed_session(item)


def rows(runner, batch):
    mesh = runner.program.mesh
    per = len(batch[0]) // mesh.shape["data"]
    d = mesh.axis_index("data")
    return tuple(a[d * per:(d + 1) * per] for a in batch)


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def train(builder, loss_fn, params, opt, batches, steps, prepare=None,
          mesh_axes=None):
    runner = session(builder, loss_fn, params, opt,
                     tuple(a[:2] for a in batches[0]), mesh_axes)
    if prepare is not None:
        prepare(runner)
    state = runner.create_state()
    losses = []
    for b in batches[:steps]:
        state, m = runner.step(state, rows(runner, b))
        losses.append(float(m["loss"]))
    kinds = runner.var_kinds
    stored = {path_to_name(p): t for p, t in
              flatten_with_path(state.params)[0]}
    return runner, state, {
        "losses": losses, "params": named(runner.logical_params(state)),
        "mesh": dict(runner.program.mesh.shape),
        "kinds": {n: k for n, (k, _) in kinds.items()},
        "schedule": runner.program.parallel_context().pipeline_schedule,
        "pipe_index": runner.program.mesh.axis_index("pipe"),
        "whole": digest(t for n, t in sorted(stored.items())
                        if kinds[n][0] != "tp"),
        "pieces": digest(t for n, t in sorted(stored.items())
                         if kinds[n][0] == "tp"),
        "stored_bytes": sum(t.numel() * t.element_size()
                            for t in stored.values()),
        "blocks_rows": {n: tuple(t.shape) for n, t in stored.items()
                        if n.startswith("blocks/")}}


def zoo(sched, prepare=None):
    os.environ["AUTODIST_PIPELINE_SCHEDULE"] = sched
    try:
        return train(S.Pipeline(num_stages=2, num_microbatches=4),
                     lm.make_loss_fn(zcfg), inp["zoo"], SGD,
                     inp["zoo_batches"], ZOO_STEPS, prepare)
    finally:
        del os.environ["AUTODIST_PIPELINE_SCHEDULE"]


schedule.counts.update(forward_ticks=0, backward_ticks=0, hops=0)
runner, state, res["zoo_shift"] = zoo("shift")
res["zoo_shift"]["counts"] = dict(schedule.counts)
mgr = CheckpointManager(runner, os.path.join(out, "pp_ckpt"))
mgr.save(ZOO_STEPS, state, force=True)
mgr.wait_until_finished()
mgr.close()
state, m = runner.step(state, rows(runner, inp["zoo_batches"][ZOO_STEPS]))
res["zoo_next_loss"] = float(m["loss"])
mine = rows(runner, inp["zoo_batches"][0])
other = ((mine[0] + 1 + runner.program.mesh.axis_index("pipe")) %
         zcfg.vocab,)
res["mismatch"] = raises(lambda: runner.step(state, other))
res["graph_mismatch"] = first_call_raises(runner, other)
GRAPH_BATCHES = [rows(runner, b) for b in inp["zoo_batches"][:2]] * 2
res["graph_zoo"] = graph_paths(runner, GRAPH_BATCHES)
# The schedule's counts over two calls of the eager step and of the graph
# step.
res["graph_counts"] = {}
for path in ("eager", "aot"):
    call = runner.step if path == "eager" else runner.make_callable(
        GRAPH_BATCHES[0], aot=True, shard_inputs=True)
    state = runner.create_state()
    schedule.counts.update(forward_ticks=0, backward_ticks=0, hops=0)
    for b in GRAPH_BATCHES[:2]:
        state, _ = call(state, b)
    res["graph_counts"][path] = dict(schedule.counts)
del runner, state, mgr

for sched in ("sequential", "shift-noskip", "1f1b"):
    res[f"zoo_{sched}"] = zoo(sched)[2]


# The planted faults.
def data_only(runner):
    runner._grad_group = runner.program.mesh.group("data")


def head_on_every_rank(runner):
    runner._backward_seed = lambda loss: torch.ones_like(loss)


res["fault_data_only"] = zoo("shift", data_only)[2]
res["fault_head"] = zoo("shift", head_on_every_rank)[2]


# The user model: pipeline_apply in the loss, stages split by rules.
class PipeRules(S.StrategyBuilder):
    def build(self, graph_item, resource_spec):
        return apply_sharding_rules(
            S.AllReduce().build(graph_item, resource_spec), graph_item, 2,
            rules=((r"^stages/", 0),), mesh_axis="pipe")


def user_loss(p, batch):
    x, labels = batch
    h = x @ p["inproj"]["kernel"]
    h = schedule.pipeline_apply(p["stages"], fn, h, 4)
    logits = h @ p["head"]["kernel"]
    return -torch.log_softmax(logits, -1)[
        torch.arange(labels.shape[0]), labels.long()].mean()


res["user"] = train(PipeRules(), user_loss, inp["user"],
                    functools.partial(torch.optim.SGD, lr=0.1),
                    [inp["user_batch"]] * USER_STEPS, USER_STEPS,
                    mesh_axes={"data": 2, "pipe": 2})[2]

# Pipe composed with expert (pipe with model trains:
# tests/test_torch_two_axis.py).
res["compose_expert"] = raises(lambda: session(
    S.Pipeline(num_stages=2, num_microbatches=2, base=S.ModelParallel(
        S.AllReduce(), model_axis=2, rules=moe.EXPERT_RULES,
        mesh_axis="expert")),
    lm.make_loss_fn(zcfg), inp["zoo"], SGD, (inp["zoo_batches"][0][0][:2],)))
autodist_mod._reset_default()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''.replace("MICRO", repr(MICRO)).replace("SCHEDULES", repr(SCHEDULES)) \
   .replace("ZOO_STEPS", str(ZOO_STEPS)).replace("USER_STEPS",
                                                   str(USER_STEPS)) \
   .replace("#GRAPH_PATHS", GRAPH_PATHS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's cases, run once per test session (the first xdist
    worker to need them runs them under a file lock): {case: [rank 0's
    result, ...]}, and the world's directory."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "pp_world"
    with open(shared / "pp_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            zparams, _, zbatches = _zoo_lm()
            uparams, ubatch = _user_model()
            stages = _stages()
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({
                    "stages": {k: torch.as_tensor(np.stack(
                        [s[k] for s in stages])) for k in ("w", "b")},
                    "x": {m: torch.tensor(_x(m)) for m in MICRO},
                    "zoo": convert.params_from_jax(zparams, "cpu"),
                    "zoo_batches": [tuple(torch.as_tensor(a) for a in b)
                                    for b in zbatches],
                    "user": convert.params_from_jax(uparams, "cpu"),
                    "user_batch": tuple(torch.as_tensor(a)
                                        for a in ubatch)}, f)
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


@functools.lru_cache(maxsize=None)
def _jax_pipeline_apply(num_micro):
    """JAX ``pipeline_apply`` on its ``{data: 2, pipe: 4}`` mesh: (output,
    d loss / d stacked w, b, d loss / d x) of ``(out ** 2).mean()``."""
    stacked = jschedule.stack_stage_params(_stages())
    x = jnp.asarray(_x(num_micro))
    mesh = _jmesh({"data": 2, "pipe": 4})

    def loss(s, x):
        return (jschedule.pipeline_apply(s, _jstage_fn, x, num_micro,
                                         mesh) ** 2).mean()
    out = jax.jit(lambda s, x: jschedule.pipeline_apply(
        s, _jstage_fn, x, num_micro, mesh))(stacked, x)
    gs, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, x)
    return jax.device_get((out, gs["w"], gs["b"], gx))


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("num_micro", MICRO)
def test_pipeline_apply_matches_jax(world, num_micro, sched):
    """Outputs on every rank, each stage's gradients on its rank and the
    input's on stage 0, at the JAX test's 1e-5; the ticks the executor ran
    and its hops (one at each tick at which a stage sends: M + S - 2 each
    way under shift, M (S - 1) sequential)."""
    out, gw, gb, gx = _jax_pipeline_apply(num_micro)
    runs = world[f"pa_{num_micro}_{sched}"]
    for r, run in enumerate(runs):
        np.testing.assert_allclose(run["out"], out, rtol=PA_TOL,
                                   atol=PA_TOL)
        np.testing.assert_allclose(run["w"][r], gw[r], rtol=PA_TOL,
                                   atol=PA_TOL)
        np.testing.assert_allclose(run["b"][r], gb[r], rtol=PA_TOL,
                                   atol=PA_TOL)
        others = [i for i in range(WORLD) if i != r]
        assert not run["w"][others].any()  # a rank holds its stage only
        if r == 0:
            np.testing.assert_allclose(run["x"], gx, rtol=PA_TOL,
                                       atol=PA_TOL)
        else:
            assert run["x"] is None or not run["x"].any()
        ticks = schedule.executor_ticks(WORLD, num_micro, sched)
        assert run["counts"]["forward_ticks"] == ticks
        assert run["counts"]["backward_ticks"] == ticks
        want_hops = num_micro + WORLD - 2 if sched != "sequential" else \
            num_micro * WORLD - num_micro
        assert run["counts"]["hops"] == 2 * want_hops


@pytest.mark.parametrize("sched", ["sequential", "shift-noskip", "1f1b"])
@pytest.mark.parametrize("num_micro", MICRO)
def test_schedules_are_bitwise_shift(world, num_micro, sched):
    """``sequential`` and ``shift-noskip``: outputs and gradients bitwise
    ``shift``'s (same microbatch order in every stage's accumulation);
    ``1f1b``: the output (hence the loss) bitwise, its gradients from the
    recomputed stage bitwise too on the CPU."""
    for got, want in zip(world[f"pa_{num_micro}_{sched}"],
                         world[f"pa_{num_micro}_shift"]):
        for key in ("out", "w", "b", "x"):
            if want[key] is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], want[key])


@functools.lru_cache(maxsize=None)
def _jax_zoo():
    """The JAX Pipeline(2, 4) run of ``_zoo_lm`` on its 8-device mesh
    ({data: 4, pipe: 2}), SGD 0.1: (losses, params). (SGD: under Adam the
    attention key bias, whose gradient is zero but for roundings, takes
    steps of up to the learning rate from either package's noise.)"""
    params, loss_fn, batches = _zoo_lm()
    return _jax_run(jstrategy.Pipeline(num_stages=2, num_microbatches=4),
                    loss_fn, params, optax.sgd(0.1), batches[:ZOO_STEPS])


def _jax_run(builder, loss_fn, params, opt, batches, prepare=None):
    _jreset()
    ad = JAutoDist(strategy_builder=builder)
    item = ad.capture(loss_fn, params, opt, example_batch=batches[0])
    if prepare is not None:
        prepare(ad, item)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    losses = []
    for b in batches:
        state, metrics = runner.step(state, b)
        losses.append(float(jax.device_get(metrics["loss"])))
    want = {jpath_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(
                runner.logical_params(state)))[0]}
    return losses, want


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


def test_zoo_lm_trains_under_pipeline_like_jax(world):
    """``_zoo_lm`` (4 stacked layers, batch 16 x 16) under
    ``Pipeline(num_stages=2, num_microbatches=4)``, 4 SGD steps on
    ``{data: 2, pipe: 2}``: every rank's losses and logical params against
    the JAX run on its 8-device mesh at rtol 1e-4, atol 1e-5."""
    losses, params = _jax_zoo()
    for r, res in enumerate(world["zoo_shift"]):
        assert res["mesh"] == {"data": 2, "pipe": 2}
        assert res["schedule"] == "shift"
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        assert sorted(res["params"]) == sorted(params)
        for k in params:
            np.testing.assert_allclose(res["params"][k], params[k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
        assert _excess(res, (losses, params)) <= 1.0


@pytest.mark.parametrize("sched", ["sequential", "shift-noskip", "1f1b"])
def test_zoo_lm_schedules_bitwise_shift(world, sched):
    """The acceptance pin of ``tests/test_pipeline_subsystem.py:102`` in
    the port: the loss trajectory and the params bitwise under every
    schedule (``1f1b`` recomputes the stage: the same bits on the CPU)."""
    for got, want in zip(world[f"zoo_{sched}"], world["zoo_shift"]):
        assert got["schedule"] == sched
        assert got["losses"] == want["losses"]
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_pipe_ranks_store_their_stage_and_keep_whole_params_bitwise(world):
    """Each rank stores 2 of the 4 stacked layers (kind ``tp`` over pipe),
    the two ranks of a pipe group hold other layers and bitwise the same
    whole parameters, and the data replicas agree."""
    runs = world["zoo_shift"]
    for res in runs:
        assert set(res["blocks_rows"]) and all(
            shape[0] == 2 for shape in res["blocks_rows"].values())
        assert {k for n, k in res["kinds"].items()
                if n.startswith("blocks/")} == {"tp"}
        assert {k for n, k in res["kinds"].items()
                if not n.startswith("blocks/")} == {"ar"}
    assert [r["pipe_index"] for r in runs] == [0, 1, 0, 1]
    assert len({r["whole"] for r in runs}) == 1
    assert runs[0]["pieces"] != runs[1]["pieces"]
    assert runs[0]["pieces"] == runs[2]["pieces"]
    assert runs[1]["pieces"] == runs[3]["pieces"]


def test_the_schedule_ran_its_ticks_in_every_step(world):
    """Per step one forward and one backward over ``M + S - 1`` ticks (4
    microbatches, 2 stages: 5; the JAX conveyor's count at S = 2)."""
    for res in world["zoo_shift"]:
        assert res["counts"]["forward_ticks"] == ZOO_STEPS * 5
        assert res["counts"]["backward_ticks"] == ZOO_STEPS * 5
        assert jschedule.num_schedule_steps(2, 4, True) == 5


@pytest.mark.parametrize("fault", ["fault_data_only", "fault_head"])
def test_planted_faults_read_beyond_the_tolerance(world, fault):
    """The whole parameters' gradients averaged over the data group alone
    (no sum over the pipe group: the pipe ranks' embeddings part), and the
    head counted on every pipe rank (the backward seeded 1, not 1 / S):
    each reads many times the tolerance from the JAX run."""
    want = _jax_zoo()
    runs = world[fault]
    assert min(_excess(res, want) for res in runs) > 20
    if fault == "fault_data_only":
        assert len({r["whole"] for r in runs}) > 1


@functools.lru_cache(maxsize=None)
def _jax_user():
    params, batch = _user_model()
    mesh_axes = {"data": 4, "pipe": 2}

    def prepare(ad, item):
        strategy_ = ad.build_strategy(item)
        jsharding.apply_sharding_rules(strategy_, item, 2,
                                       rules=((r"^stages/", 0),),
                                       mesh_axis="pipe")

    _jreset()
    ad = JAutoDist(strategy_builder=jstrategy.AllReduce(),
                   mesh_axes=mesh_axes)
    mesh = ad.cluster.build_mesh(mesh_axes)

    def loss_fn(p, batch):
        x, labels = batch
        h = x @ p["inproj"]["kernel"]
        h = jschedule.pipeline_apply(p["stages"], _jstage_fn, h, 4, mesh)
        logits = h @ p["head"]["kernel"]
        return -jnp.mean(jax.nn.log_softmax(logits)[
            jnp.arange(labels.shape[0]), labels])

    item = ad.capture(loss_fn, params, optax.sgd(0.1), example_batch=batch)
    prepare(ad, item)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    losses = []
    for _ in range(USER_STEPS):
        state, metrics = runner.step(state, batch)
        losses.append(float(jax.device_get(metrics["loss"])))
    want = {jpath_to_name(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(
                runner.logical_params(state)))[0]}
    return losses, want


def test_user_model_with_pipeline_apply_trains_like_jax(world):
    """``tests/test_pipeline.py::test_pipelined_model_trains_e2e``'s model
    at 2 stages: ``pipeline_apply`` in the user's loss, the stages split
    over ``pipe`` by ``apply_sharding_rules``, 3 SGD steps on ``{data: 2,
    pipe: 2}`` against the JAX run on ``{data: 4, pipe: 2}``."""
    losses, params = _jax_user()
    for r, res in enumerate(world["user"]):
        assert res["mesh"] == {"data": 2, "pipe": 2}
        assert res["kinds"]["stages/w"] == "tp"
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        for k in params:
            np.testing.assert_allclose(res["params"][k], params[k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
    assert losses[-1] < losses[0]


def test_two_stage_checkpoint_restores_on_one_process_and_continues(world):
    """The world's checkpoint (step 4) restored into a one-process
    ``AllReduce()`` Runner of the stacked LM: every leaf bitwise the
    world's logical params, and its next step's loss the world's (rtol
    1e-5)."""
    autodist_mod._reset_default()
    params, _, batches = _zoo_lm()
    ad = AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        lm.make_loss_fn(_port_cfg()), convert.params_from_jax(params, "cpu"),
        functools.partial(torch.optim.SGD, lr=0.1),
        example_batch=batches[0]))
    state = CheckpointManager(runner, world["dir"] / "pp_ckpt") \
        .restore_or_init()
    assert int(state.step) == ZOO_STEPS
    got = {path_to_name(p): t.numpy() for p, t in
           flatten_with_path(runner.logical_params(state))[0]}
    want = world["zoo_shift"][0]["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state, metrics = runner.step(state, batches[ZOO_STEPS])
    np.testing.assert_allclose(float(metrics["loss"]),
                               world["zoo_next_loss"][0], rtol=1e-5)


@pytest.mark.parametrize("case,kind,match", [
    ("mismatch", "ValueError", "pipe group were fed different batches"),
    ("graph_mismatch", "ValueError",
     "pipe group were fed different batches"),
    ("compose_expert", "NotImplementedError", "item 10\\(j\\)")])
def test_what_a_pipe_axis_refuses(world, case, kind, match):
    import re
    for res in world[case]:
        assert res is not None and res[0] == kind, res
        assert re.search(match, res[1]), res[1]


def test_graph_paths_under_a_pipe_axis_match_step_and_jax(world):
    """``make_callable(aot=True)``, ``megastep`` and ``run(unroll=2)`` of
    ``_zoo_lm`` under ``Pipeline(2, 4)`` on ``{data: 2, pipe: 2}`` (on the
    CPU the graph's function runs directly, over its static buffers), over
    the first two batches twice: bitwise the eager steps, and held to the
    JAX package's ``make_callable(aot=True)`` and ``megastep`` at the eager
    parity's tolerance."""
    params, loss_fn, batches = _zoo_lm()
    _jreset()
    ad = JAutoDist(strategy_builder=jstrategy.Pipeline(num_stages=2,
                                                       num_microbatches=4))
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, optax.sgd(0.1), example_batch=batches[0]))
    want = jax_graph_paths(runner, list(batches[:2]) * 2)
    held_graph_paths(world["graph_zoo"], want, RTOL, ATOL)


def test_the_graph_step_counts_the_schedule_per_call(world):
    """Two calls of the graph step count the ticks and hops of two eager
    steps (5 ticks a pass, and a hop a tick that sends)."""
    for res in world["graph_counts"]:
        assert res["aot"] == res["eager"]
        assert res["eager"]["forward_ticks"] == 2 * 5
        assert res["eager"]["backward_ticks"] == 2 * 5
        assert res["eager"]["hops"] > 0


def test_schedule_counts_per_replay_not_at_capture(monkeypatch):
    """The schedule's counts under a (faked) capture go to the capturing
    graph, each replay adds them, and outside a capture a call counts at
    once: the counts read per replay, as a kernel's launches do."""
    capturing = {"on": True}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(schedule, "counts",
                        {"forward_ticks": 0, "backward_ticks": 0, "hops": 0})
    mesh = types.SimpleNamespace(shape={"pipe": 1},
                                 axis_index=lambda axis: 0,
                                 group=lambda axis: None)
    gen = torch.Generator().manual_seed(0)
    stacked = {"w": torch.randn(1, 4, 4, generator=gen),
               "b": torch.zeros(1, 4)}
    x = torch.randn(8, 4, generator=gen)

    def step():
        leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
        y = schedule.run_stage(leaves, lambda p, h: torch.tanh(
            h @ p["w"] + p["b"]), x, 4, mesh)
        (y ** 2).mean().backward()

    with cuda_graph.recording_launches(7) as counts:
        step()
    assert schedule.counts == {"forward_ticks": 0, "backward_ticks": 0,
                               "hops": 0}
    graph = cuda_graph.Graph(lambda: None, "cuda")   # replays faked too
    graph.graph = types.SimpleNamespace(replay=lambda: None)
    graph.launches = counts
    for _ in range(3):
        graph()
    assert schedule.counts == {"forward_ticks": 12, "backward_ticks": 12,
                               "hops": 0}
    capturing["on"] = False
    step()
    assert schedule.counts["forward_ticks"] == 16
