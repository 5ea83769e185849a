"""Per-scope program costs in the port against the JAX package.

``GraphItem.op_provenance`` / ``scope_costs`` / ``activation_live_bytes``,
``scope_path``, the ``GraphItem`` proto and ``named_scope`` on the zoo's
tiny fixtures, with the JAX weights carried across by ``convert``:

* ``scope_costs()`` has the JAX keys and the JAX FLOPs per scope (rtol
  1e-9), but for two stated cases: every key under the stacked layout's
  ``blocks`` scope is L times the JAX one (the JAX scan body traces once,
  the port runs all L layers), and BiLSTM's ``fwd`` / ``bwd`` count every
  one of the T time steps (``lax.scan`` again);
* the records sum exactly to ``flops_estimate()``;
* ``activation_live_bytes`` equals the JAX scan on a chain whose jaxpr and
  aten trace are the same ops, and lies within ``LIVE_BAND`` of it on the
  zoo models (the traces differ: see ``LIVE_BAND``);
* the proto is byte-equal to the JAX one and loads across packages;
* a forward with scopes is bitwise the same forward with ``named_scope``
  a no-op.
"""
import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import graph_item as jgraph_item
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu_torch import convert
from autodist_tpu_torch import graph_item
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.utils import scope
from test_torch_models import _flops_pair

FLOPS_RTOL = 1e-9
# activation_live_bytes / the JAX scan on the zoo fixtures. The two walk
# different traces: the port's aten ops count a view as 0 bytes and a
# fused addmm as one output, where the JAX jaxpr has broadcast / reshape
# equations that allocate; the JAX scan sees a jit-wrapped sub-program
# (softmax, gelu, the xent) only through its outputs, the port every op
# inside it; and a lax.scan body once (the stacked LM, BiLSTM), where the
# port's loop keeps every step's outputs live until their last use. Read
# on these fixtures: 0.69 (LM, BERT), 0.94 (MLP), 1.0 (ResNet, NCF), 1.12
# (stacked LM), 2.7 (BiLSTM, T = 12).
LIVE_BAND = (0.5, 3.0)
MODELS = ["lm", "lm_stacked", "bert", "resnet", "bilstm", "ncf", "mlp"]


def _pair(name):
    """(JAX GraphItem, port GraphItem) of a tiny model, optimizer None."""
    if name != "lm_stacked":
        return _flops_pair(name)
    jcfg, cfg = jlm.lm_tiny(max_len=16), lm.lm_tiny(max_len=16)
    for c in (jcfg, cfg):
        c.num_layers, c.scan_layers = 4, True
    jparams = jax.device_get(jlm.init(jax.random.PRNGKey(0), jcfg))
    batch = jlm.synthetic_batch(jcfg, batch_size=8, seq_len=16)
    return (JGraphItem.capture(jlm.make_loss_fn(jcfg), jparams, None,
                               example_batch=batch),
            GraphItem.capture(lm.make_loss_fn(cfg),
                              convert.params_from_jax(jparams, "cpu"), None,
                              example_batch=batch))


def _scale(name, key, jitem):
    """What the port's FLOPs under ``key`` are of the JAX package's."""
    if name == "lm_stacked" and key.split("/")[0] == "blocks":
        return 4.0  # L: the JAX scan body traces once
    if name == "bilstm" and key in ("fwd", "bwd"):
        return float(jitem.batch_struct[0].shape[1])  # T time steps
    return 1.0


@pytest.mark.parametrize("name", MODELS)
def test_scope_costs_match_jax(name):
    jitem, item = _pair(name)
    want, got = jitem.scope_costs(), item.scope_costs()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key]["flops"],
                                   _scale(name, key, jitem) * w["flops"],
                                   rtol=FLOPS_RTOL, err_msg=key)
        assert got[key]["ops"] > 0 and got[key]["bytes"] >= 0
    if name in ("lm_stacked", "bilstm"):
        assert any(_scale(name, k, jitem) > 1 and want[k]["flops"] > 0
                   for k in want)


@pytest.mark.parametrize("name", MODELS)
def test_records_sum_exactly_to_flops_estimate(name):
    _, item = _pair(name)
    records = item.op_provenance()
    total = 0.0
    for rec in records:
        total += rec["flops"]
    assert total == item.flops_estimate() > 0
    assert [r["eqn"] for r in records] == list(range(len(records)))
    assert all(set(r) == {"eqn", "prim", "scope", "flops", "bytes"}
               for r in records)
    # Every matmul lands inside a scope (the JAX profiler test's check).
    mms = [r for r in records if r["flops"]]
    assert mms and all(r["scope"] for r in mms)
    # Views allocate nothing; every other op allocates its outputs.
    for r in records:
        _, op, overload = r["prim"].split(".")
        if getattr(getattr(torch.ops.aten, op), overload).is_view:
            assert r["bytes"] == 0, r


SCOPE_PATHS = ["layer0/attn", "jvp(layer0)/attn",
               "transpose(jvp(layer0))/attn",
               "jit(f)/jit(main)/transpose(jvp(stage0/block1))/conv1",
               "jit(f)/jit(main)", "", None]


@pytest.mark.parametrize("text", SCOPE_PATHS)
def test_scope_path_matches_jax(text):
    assert graph_item.scope_path(text) == jgraph_item.scope_path(text)
    assert graph_item.UNATTRIBUTED == jgraph_item.UNATTRIBUTED


def test_named_scope_nests_and_pops():
    assert scope.current_scope() == ""
    with scope.named_scope("layer0"):
        with scope.named_scope("attn"):
            assert scope.current_scope() == "layer0/attn"
        assert scope.current_scope() == "layer0"
        with pytest.raises(RuntimeError):
            with scope.named_scope("mlp"):
                raise RuntimeError
        assert scope.current_scope() == "layer0"
    assert scope.current_scope() == ""


def _chain_pair():
    def jloss(p, batch):
        (x,) = batch
        a = x * p["w"]
        b = jnp.tanh(a)
        c = b * a
        d = jnp.exp(c)
        return jnp.sum(d * b)

    def loss(p, batch):
        (x,) = batch
        a = x * p["w"]
        b = torch.tanh(a)
        c = b * a
        d = torch.exp(c)
        return torch.sum(d * b)
    rng = np.random.RandomState(0)
    params = {"w": rng.randn(16, 8).astype(np.float32)}
    batch = (rng.randn(16, 8).astype(np.float32),)
    return (JGraphItem.capture(jloss, params, None, example_batch=batch),
            GraphItem.capture(loss, {"w": torch.as_tensor(params["w"])},
                              None, example_batch=batch), jloss, params,
            batch)


def test_activation_live_bytes_equals_jax_on_a_chain():
    jitem, item, jloss, params, batch = _chain_pair()
    jaxpr = jax.make_jaxpr(jloss)(params, batch)
    print(jaxpr)
    print(item.jaxpr_text)
    prims = [e.primitive.name for e in jaxpr.jaxpr.eqns]
    ops = [r["prim"] for r in item.op_provenance()]
    assert prims == ["mul", "tanh", "mul", "exp", "mul", "reduce_sum"]
    assert ops == ["aten.mul.Tensor", "aten.tanh.default", "aten.mul.Tensor",
                   "aten.exp.default", "aten.mul.Tensor", "aten.sum.default"]
    # Three (16, 8) f32 arrays live at once: b, c and d at exp (a's last
    # use was c's product).
    assert item.activation_live_bytes() == jitem.activation_live_bytes() \
        == 3 * 16 * 8 * 4


def test_activation_live_bytes_keeps_a_views_base_and_the_outputs():
    """A view extends its base's life to the view's last use; the loss
    and an aux output stay live to the end."""
    def loss(p, batch):
        (x,) = batch
        a = x * p["w"]          # 512 B
        v = a.t()               # a view of a: 0 B
        b = torch.tanh(x)       # 512 B, a still live through v
        c = b * v.t()           # 512 B: a, b, c live (the peak)
        return c.sum(), {"aux": b}
    x = torch.ones(16, 8)
    item = GraphItem.capture(loss, {"w": torch.ones(16, 8)}, None,
                             example_batch=(x,), aux_output=True)
    assert [r["bytes"] for r in item.op_provenance()] == \
        [512.0, 0.0, 512.0, 0.0, 512.0, 4.0]
    assert item.activation_live_bytes() == 3 * 512.0


@pytest.mark.parametrize("name", MODELS)
def test_activation_live_bytes_within_a_band_of_jax(name):
    jitem, item = _pair(name)
    ratio = item.activation_live_bytes() / jitem.activation_live_bytes()
    print(f"{name}: port {item.activation_live_bytes():.0f} B, JAX "
          f"{jitem.activation_live_bytes():.0f} B, ratio {ratio:.3f}")
    assert LIVE_BAND[0] <= ratio <= LIVE_BAND[1]


def _proto_pair():
    """A capture of the same program in both packages: lm_tiny's loss
    with one bf16 parameter (a dtype name str(torch.dtype) would get
    wrong) and an int32 batch."""
    jitem, item = _flops_pair("lm")
    jparams = dict(jitem.params, extra=jnp.zeros((3,), jnp.bfloat16))
    params = dict(item.params, extra=torch.zeros(3, dtype=torch.bfloat16))
    batch = tuple(np.zeros(s.shape, s.dtype) for s in
                  jitem.batch_struct)
    return (JGraphItem.capture(jitem.loss_fn, jparams, None,
                               example_batch=batch),
            GraphItem.capture(item.loss_fn, params, None,
                              example_batch=batch))


def test_to_proto_is_byte_equal_to_jax():
    jitem, item = _proto_pair()
    assert item.to_proto().SerializeToString() == \
        jitem.to_proto().SerializeToString()
    dtypes = {v.dtype for v in item.to_proto().variables}
    assert dtypes == {"float32", "bfloat16"}
    assert item.to_proto().batch_spec[0].dtype == "int32"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_serialized_items_load_across_packages(tmp_path, writer):
    jitem, item = _proto_pair()
    path = str(tmp_path / "item.pb")
    (item if writer == "port" else jitem).serialize(path)
    got, jgot = GraphItem.deserialize(path), JGraphItem.deserialize(path)
    assert [(v.name, v.shape, v.dtype, v.trainable, v.sparse_access,
             v.size_bytes) for v in got.variables] == \
        [(v.name, v.shape, v.dtype, v.trainable, v.sparse_access,
          v.size_bytes) for v in item.variables]
    assert {v.dtype for v in got.variables} == {torch.float32,
                                               torch.bfloat16}
    assert [(v.name, v.shape, str(v.dtype)) for v in jgot.variables] == \
        [(v.name, v.shape, str(v.dtype)) for v in jitem.variables]
    assert [(t.name, t.shape, str(t.dtype)) for t in got.batch_spec] == \
        [(t.name, t.shape, str(t.dtype)) for t in jgot.batch_spec]
    assert got.batch_size == jgot.batch_size == 0  # the batch dim is None
    # The metadata-only item: no program, no provenance.
    assert got.op_provenance() == [] and got.scope_costs() == {}
    assert got.activation_live_bytes() == 0.0
    assert jgot.op_provenance() == [] and jgot.scope_costs() == {}
    assert jgot.activation_live_bytes() == 0.0
    assert got.to_proto().SerializeToString() == \
        jgot.to_proto().SerializeToString()


def test_to_proto_with_the_trace_text():
    _, item = _pair("mlp")
    pb = item.to_proto(include_jaxpr=True)
    lines = pb.jaxpr_text.splitlines()
    assert len(lines) == len(item.op_provenance())
    assert "aten.mm.default scope=dense0 flops=8192" in pb.jaxpr_text
    assert not item.to_proto().jaxpr_text


def test_graphitem_pb2_is_a_byte_identical_copy():
    import autodist_tpu.proto.graphitem_pb2 as jpb
    import autodist_tpu_torch.proto.graphitem_pb2 as pb
    with open(jpb.__file__, "rb") as a, open(pb.__file__, "rb") as b:
        assert a.read() == b.read()


def _example_batch(name):
    """The numpy batch :func:`_pair` captured with (seeded)."""
    if name == "bert":
        return jbert.synthetic_batch(jbert.bert_tiny(), 4, 32)
    if name == "lm":
        return (np.random.RandomState(0).randint(0, 256, (4, 33))
                .astype(np.int32),)
    if name == "lm_stacked":
        return jlm.synthetic_batch(jlm.lm_tiny(max_len=16), batch_size=8,
                                   seq_len=16)
    from autodist_tpu.models import ZOO as JZOO
    return JZOO[name].tiny_fixture(seed=0)[2]


@pytest.mark.parametrize("name", MODELS)
def test_scopes_change_no_bit_of_the_forward(monkeypatch, name):
    _, item = _pair(name)
    loss_fn, params = item.loss_fn, item.params
    batch = tuple(torch.as_tensor(b) for b in _example_batch(name))
    with_scopes = loss_fn(params, batch)
    noop = lambda name: contextlib.nullcontext()  # noqa: E731
    real = scope.named_scope
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("autodist_tpu_torch") \
                and getattr(mod, "named_scope", None) is real:
            monkeypatch.setattr(mod, "named_scope", noop)
    seen = []
    real_current = graph_item.current_scope
    monkeypatch.setattr(graph_item, "current_scope",
                        lambda: seen.append(real_current()) or seen[-1])
    without = loss_fn(params, batch)
    assert torch.equal(with_scopes, without)
    assert with_scopes.dtype == without.dtype
    _, item = _pair(name)
    assert item.op_provenance() and set(seen) == {""}
