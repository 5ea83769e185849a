"""The port's capture -> strategy -> compile -> transform -> placement front
half against the JAX package's, on the same models and cluster files."""
import types

import numpy as np
import jax
import pytest
import torch

from autodist_tpu import resource_spec as jrs
from autodist_tpu.cluster import Cluster as JCluster
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel import partitioner as jpart
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import transformer as JT
from autodist_tpu.proto import strategy_pb2 as jstrategy_pb2
from autodist_tpu.remapper import Remapper as JRemapper
from autodist_tpu.serve.engine import build_replica_programs as jbuild
from autodist_tpu.strategy.all_reduce_strategy import AllReduce as JAllReduce
from autodist_tpu.strategy.base import StrategyCompiler as JStrategyCompiler
from autodist_tpu_torch import convert
from autodist_tpu_torch.cluster import Cluster
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel import partitioner
from autodist_tpu_torch.models import bert, lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve.engine import build_replica_programs
from autodist_tpu_torch.strategy import AllReduce, StrategyCompiler

SPEC_8_GPUS = """
nodes:
  - address: 10.0.0.1
    gpus: [0, 1, 2, 3, 4, 5, 6, 7]
    chief: true
"""
SPEC_2_HOSTS = """
nodes:
  - address: 10.0.0.1
    gpus: [0, 1, 2, 3]
    chief: true
  - address: 10.0.0.2
    gpus: [0, 1, 2, 3]
"""


def _serve_models(name):
    """(jax apply, jax params, port apply, port params, example batch):
    the serve-path forward of each zoo transformer."""
    rng = np.random.RandomState(0)
    if name == "bert_tiny":
        jcfg, cfg = jbert.bert_tiny(), bert.bert_tiny()
        batch = (rng.randint(0, jcfg.vocab, (8, 16)).astype(np.int32),
                 rng.randint(0, 2, (8, 16)).astype(np.int32))

        def japply(p, b):
            return JT.encode(p, jcfg, b[0], segment_ids=b[1])

        def apply(p, b):
            return T.encode(p, cfg, b[0], segment_ids=b[1])
    else:
        jcfg, cfg = jlm.lm_tiny(), lm.lm_tiny()
        batch = rng.randint(0, jcfg.vocab, (8, 16)).astype(np.int32)

        def japply(p, tokens):
            return JT.logits(p, jcfg, JT.encode(p, jcfg, tokens))

        def apply(p, tokens):
            return T.logits(p, cfg, T.encode(p, cfg, tokens))
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
    return japply, jparams, apply, convert.params_from_jax(jparams, "cpu"), \
        batch


def _captures(name, **kw):
    japply, jparams, apply, params, batch = _serve_models(name)
    return (JGraphItem.capture(japply, jparams, None, example_batch=batch,
                               **kw),
            GraphItem.capture(apply, params, None, example_batch=batch, **kw))


def _spec_files(tmp_path, text):
    path = tmp_path / "spec.yml"
    path.write_text(text)
    return jrs.ResourceSpec(str(path)), ResourceSpec(str(path))


def _var_table(item):
    return [(v.name, v.shape, np.dtype(str(v.dtype).replace("torch.", "")),
             v.trainable, v.sparse_access) for v in item.variables]


@pytest.mark.parametrize("name", ["bert_tiny", "lm_tiny"])
def test_capture_matches_jax(name):
    jitem, item = _captures(name)
    assert _var_table(item) == _var_table(jitem)
    sparse = {v.name for v in item.variables if v.sparse_access}
    assert "embed/embedding" in sparse
    assert "pos_embed" not in sparse  # a slice, not a gather
    assert [(t.name, t.shape, t.dtype) for t in item.batch_spec] == \
        [(t.name, t.shape, t.dtype) for t in jitem.batch_spec]
    assert item.total_bytes == jitem.total_bytes


def test_capture_honours_sparse_and_non_trainable_overrides():
    jitem, item = _captures("bert_tiny", sparse_params=("ln_f",),
                            non_trainable=("layer1",))
    assert _var_table(item) == _var_table(jitem)
    assert item.var_by_name("ln_f/scale").sparse_access
    assert not item.var_by_name("layer1/attn/key/kernel").trainable


def test_capture_launches_no_kernel_and_leaves_params_alone():
    from autodist_tpu_torch.ops import flash_attention as fa
    _, _, apply, params, batch = _serve_models("bert_tiny")
    before = {k: v.clone() for k, v in params["embed"].items()}
    launches = fa.flash_fwd.launches
    GraphItem.capture(apply, params, None, example_batch=batch)
    assert fa.flash_fwd.launches == launches
    assert torch.equal(before["embedding"], params["embed"]["embedding"])


def test_resource_spec_parses_nodes_yaml_like_jax(tmp_path):
    for text in (SPEC_8_GPUS, SPEC_2_HOSTS):
        jspec, spec = _spec_files(tmp_path, text)
        assert spec.num_hosts == jspec.num_hosts
        assert spec.devices_per_host == jspec.devices_per_host
        assert spec.num_processes == jspec.num_processes
        assert spec.chief_address == jspec.chief_address
        assert [d.name_string() for d in spec.accelerator_devices] == \
            [d.name_string() for d in jspec.accelerator_devices]


@pytest.mark.parametrize("axes", [None, {"model": 2}, {"data": -1, "model": 4},
                                  {"model": 2, "expert": 2},
                                  {"model": 16}, {"model": 3}],
                         ids=lambda a: str(a).replace(" ", ""))
def test_build_mesh_matches_jax(tmp_path, axes):
    """Eight devices on both sides (the JAX test mesh; a spec of 8 GPUs)."""
    _, spec = _spec_files(tmp_path, SPEC_8_GPUS)

    def outcome(cluster):
        try:
            mesh = cluster.build_mesh(axes)
        except ValueError as e:
            return str(e)
        return tuple(mesh.axis_names), dict(mesh.shape)
    assert outcome(Cluster(spec)) == outcome(JCluster(jrs.ResourceSpec()))


@pytest.mark.parametrize("name", ["bert_tiny", "lm_tiny"])
def test_all_reduce_build_matches_jax(tmp_path, name):
    jspec, spec = _spec_files(tmp_path, SPEC_8_GPUS)
    jitem, item = _captures(name)
    js = JAllReduce(chunk_size=16).build(jitem, jspec)
    s = AllReduce(chunk_size=16).build(item, spec)
    assert [n.SerializeToString() for n in s.node_config] == \
        [n.SerializeToString() for n in js.node_config]
    assert list(s.graph_config.replicas) == list(js.graph_config.replicas)
    assert dict(s.graph_config.mesh_axes) == dict(js.graph_config.mesh_axes)
    # One descriptor, two copies: a port Strategy parses in the JAX package.
    back = jstrategy_pb2.Strategy.FromString(s.proto.SerializeToString())
    assert back.node_config == js.node_config


def test_strategy_compiler_prunes_like_jax(tmp_path):
    jspec, spec = _spec_files(tmp_path, SPEC_8_GPUS)
    jitem, item = _captures("bert_tiny", non_trainable=("ln_f",))
    js, s = JAllReduce().build(jitem, jspec), AllReduce().build(item, spec)
    for strategy in (js, s):  # a stale name and a non-trainable one
        for name in ("gone/kernel", "ln_f/scale"):
            strategy.proto.node_config.add(var_name=name) \
                .all_reduce_synchronizer.SetInParent()
    mesh = types.SimpleNamespace(axis_names=("data",))
    jc = JStrategyCompiler(jitem, mesh).compile(js)
    c = StrategyCompiler(item, mesh).compile(s)
    names = [n.var_name for n in c.node_config]
    assert names == [n.var_name for n in jc.node_config]
    assert "gone/kernel" not in names and "ln_f/scale" not in names
    assert len(s.node_config) == len(names) + 2  # original untouched


def test_partitioner_matches_jax():
    for text in ("", "0:8", "1:4:model", "0:2:expert,2:4:model"):
        jc = jpart.PartitionerConfig.from_string(text)
        c = partitioner.PartitionerConfig.from_string(text)
        assert c.to_string() == jc.to_string()
        assert c.partition_list(3) == jc.partition_list(3)
        assert c.active == jc.active
    jitem, item = _captures("bert_tiny")
    sizes = {"data": 2, "model": 4, "expert": 2}

    def outcome(module, var, text, axis):
        try:
            return tuple(module.param_partition_spec(
                var, module.PartitionerConfig.from_string(text), axis,
                sizes[axis], sizes))
        except ValueError as e:
            return str(e)

    for text, axis in (("0:8", "data"), ("1:4", "model"),
                       ("0:2:expert,1:4:model", "expert")):
        for name in ("embed/embedding", "layer0/mlp/up/kernel",
                     "layer0/ln1/bias"):
            got = outcome(partitioner, item.var_by_name(name), text, axis)
            want = outcome(jpart, jitem.var_by_name(name), text, axis)
            assert got == want, (text, name)


def test_transform_partition_specs_match_jax(tmp_path):
    """A partitioned node config lowers to the same per-param spec."""
    jspec, spec = _spec_files(tmp_path, SPEC_8_GPUS)
    jitem, item = _captures("bert_tiny")
    js, s = JAllReduce().build(jitem, jspec), AllReduce().build(item, spec)
    for strategy in (js, s):
        for n in strategy.node_config:
            if n.var_name in ("embed/embedding", "layer0/mlp/up/kernel"):
                n.partitioner = "0:8"
    jprog = next(jbuild(jitem, js, jspec, 1))
    prog = next(build_replica_programs(item, s, spec, 1))
    jspecs = jax.tree_util.tree_leaves(
        jprog.param_specs(), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    specs = jax.tree_util.tree_leaves(
        prog.param_specs(), is_leaf=lambda x: isinstance(
            x, partitioner.PartitionSpec))
    assert [tuple(x) for x in specs] == [tuple(x) for x in jspecs]
    assert prog.data_axis_size == jprog.data_axis_size == 8
    # 30522 does not arise here; bert_tiny's 1000-row table divides by 8.
    assert prog.paddings() == jprog.paddings()
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        prog.param_placements()


def test_one_device_program_places_and_feeds(tmp_path):
    jitem, item = _captures("bert_tiny")
    spec = ResourceSpec.local("cpu")
    prog = next(build_replica_programs(item, AllReduce().build(item, spec),
                                       spec, 1))
    assert prog.data_axis_size == 1
    assert prog.paddings() == {}
    assert all(p == () for p in jax.tree_util.tree_leaves(
        prog.param_specs(), is_leaf=lambda x: isinstance(
            x, partitioner.PartitionSpec)))
    remapper = Remapper(prog)
    placed = remapper.place_params(item.params)
    assert placed["embed"]["embedding"].device.type == "cpu"
    ids, seg = remapper.shard_batch((np.zeros((3, 16), np.int32),
                                     np.ones((3, 16), np.int32)))
    assert isinstance(ids, torch.Tensor) and ids.dtype == torch.int32
    assert tuple(prog.batch_specs((ids, seg))[0]) == ("data", None)


def test_shard_batch_divisibility_error_matches_jax(tmp_path):
    jspec, spec = _spec_files(tmp_path, SPEC_8_GPUS)
    jitem, item = _captures("lm_tiny")
    jprog = next(jbuild(jitem, JAllReduce().build(jitem, jrs.ResourceSpec()),
                        jrs.ResourceSpec(), 1))
    prog = next(build_replica_programs(item, AllReduce().build(item, spec),
                                       spec, 1))
    bad = np.zeros((3, 16), np.int32)
    with pytest.raises(ValueError) as jerr:
        JRemapper(jprog).shard_batch(bad)
    with pytest.raises(ValueError) as err:
        Remapper(prog).shard_batch(bad)
    assert str(err.value) == str(jerr.value) == \
        "global batch 3 not divisible by data-axis size 8"
