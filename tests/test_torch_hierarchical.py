"""The port's hierarchical two-leg all-reduce and its cost model against
the JAX package.

* the leg split (``resolve_legs`` with the ``AUTODIST_HIER_ICI`` override,
  the host-major ICI / DCN groups), the codec tables and the int8
  crossover, equal to the JAX package's and to the cost model's copy;
* ``hier_mean`` for the four codecs (f32, bf16, int8, int8ef) on both
  transports (subgroups; neighbour exchanges within the data group, the
  JAX ppermute arm), with an odd payload (the shard padding), on a
  4-rank gloo world split 2 hosts x 2 (``AUTODIST_HIER_ICI=2``), against
  the JAX ``hier_mean`` on a 4-device sub-mesh: three calls threading the
  int8ef residual, means and residuals at rtol 1e-5 / atol 1e-6 (the same
  quantization of the same sums; bf16 emulated on both sides);
* ``hier_mean_nested`` over ``Cluster.build_hierarchical_mesh``'s
  ``(dcn, ici)`` groups equal to the flat-group expression;
* the degenerate one-host split (h == 1) bitwise the flat compressor;
* the wire tally equal to the JAX tally of the same calls and to
  ``Topology.hier_wire_split``;
* the cost model's restored terms: ``hierarchical_ar_cost``,
  ``hier_wire_split``, ``strategy_cost(overlap=, bucket_bytes=, hier=)``
  and ``strategy_memory(bucket_bytes=)`` (the sharded EF state) equal to
  the JAX model's on a ``Topology`` given the same links (rtol 1e-9).
"""
import fcntl
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from autodist_tpu import strategy as JS
from autodist_tpu.kernel.synchronization import hierarchical as jhier
from autodist_tpu.tuner import cost_model as jcm
from autodist_tpu_torch import strategy as S
from autodist_tpu_torch.kernel.synchronization import compressor as comp
from autodist_tpu_torch.kernel.synchronization import hierarchical as hier
from autodist_tpu_torch.tuner import cost_model as cm
from test_torch_attribution_goodput import (_bert_items, _close, _specs,
                                            _topologies)

WORLD = 4
ICI = 2
CODECS = ("f32", "bf16", "int8", "int8ef")
N = 37 * 5
CALLS = 3
RTOL, ATOL = 1e-5, 1e-6


def _grads(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(WORLD, CALLS, N).astype(np.float32)


def _jax_hier(codec, grouped, grads, monkeypatch):
    """(means (W, CALLS, N), final state per device, the tally of the
    trace) of the JAX ``hier_mean`` on a 4-device sub-mesh."""
    monkeypatch.setenv("AUTODIST_HIER_ICI", str(ICI))
    st0 = jhier.init_hier_state(N, ICI, WORLD // ICI, codec)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def f(g):
        st, outs = st0, []
        for i in range(CALLS):
            out, st = jhier.hier_mean(g[0, i], "data", codec=codec,
                                      state=st, grouped=grouped)
            outs.append(out)
        st = jnp.zeros((1,)) if codec != "int8ef" else st
        return jnp.stack(outs)[None], st[None]
    jhier.reset_wire_tally()
    fm = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("data"),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    red, st = fm(jnp.asarray(grads))
    return np.asarray(red), np.asarray(st), jhier.wire_tally()


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch.cluster import Cluster
from autodist_tpu_torch.kernel.synchronization import compressor as comp
from autodist_tpu_torch.kernel.synchronization import hierarchical as hier
from autodist_tpu_torch.resource_spec import ResourceSpec

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
os.environ["AUTODIST_HIER_ICI"] = str(inp["ici"])
d, h = hier.resolve_legs(world)
groups = hier.leg_groups(list(range(world)), d)
g = torch.from_numpy(inp["grads"][rank])
res = {"legs": (d, h), "ici_size": dist.get_world_size(groups[0]),
       "dcn_size": dist.get_world_size(groups[1])}


def run(codec, **kw):
    st = hier.init_hier_state(g.shape[1], d, h, codec, device="cpu")
    outs = []
    hier.reset_wire_tally()
    for i in range(g.shape[0]):
        o, st = hier.hier_mean(g[i].clone(), None, codec=codec, state=st,
                               **kw)
        outs.append(o.numpy().copy())
    st = st.numpy().copy() if isinstance(st, torch.Tensor) else None
    return {"means": np.stack(outs), "state": st,
            "tally": hier.wire_tally()}


for codec in inp["codecs"]:
    res[f"grouped/{codec}"] = run(codec, grouped=True, groups=groups)
    res[f"ring/{codec}"] = run(codec, grouped=False)

# The nested (dcn, ici) mesh of the cluster: the same legs as its groups.
cluster = Cluster(ResourceSpec())
cluster.start(torch.device("cpu"))
mesh = cluster.build_hierarchical_mesh(devices_per_host=d)
res["nested_shape"] = dict(mesh.shape)
for codec in inp["codecs"]:
    st = hier.init_hier_state(g.shape[1], d, h, codec, device="cpu")
    outs = []
    for i in range(g.shape[0]):
        o, st = hier.hier_mean_nested(g[i].clone(), codec=codec, state=st,
                                      ici_group=mesh.group("ici"),
                                      dcn_group=mesh.group("dcn"))
        outs.append(o.numpy().copy())
    res[f"nested/{codec}"] = np.stack(outs)

# One host (AUTODIST_HIER_ICI=0, no devices_per_host): the flat codec.
os.environ["AUTODIST_HIER_ICI"] = "0"
for codec, kind in (("f32", None), ("bf16", "HorovodCompressor"),
                    ("int8", "Int8Compressor"),
                    ("int8ef", "Int8CompressorEF")):
    st = hier.init_hier_state(g.shape[1], world, 1, codec, device="cpu")
    o, st2 = hier.hier_mean(g[0].clone(), None, codec=codec, state=st)
    if kind is None:
        flat = comp.all_reduce_mean_(g[0].clone(), None)
    else:
        c = comp.Compressor.create(kind)
        flat, _ = c.reduce(g[0].clone(), c.init_state(g.shape[1:], torch.float32, "cpu"), None)
    res[f"flat/{codec}"] = (o.numpy().copy(), flat.numpy().copy())
dist.barrier()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-rank case, run once per test session on a 4-rank gloo
    world (the first xdist worker to need it runs it under a file lock)."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "hier_world"
    with open(shared / "hier_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({"grads": _grads(), "codecs": CODECS,
                             "ici": ICI}, f)
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


# -- legs and tables -----------------------------------------------------------

@pytest.mark.parametrize("world_,dph,env", [
    (8, 4, None), (8, 2, None), (8, None, None), (8, 8, None), (8, 3, None),
    (8, 4, "2"), (4, None, "2"), (4, 2, "0"), (6, 3, None), (4, 1, None)])
def test_resolve_legs_equals_jax(world_, dph, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("AUTODIST_HIER_ICI", raising=False)
    else:
        monkeypatch.setenv("AUTODIST_HIER_ICI", env)
    assert hier.resolve_legs(world_, dph) == jhier.resolve_legs(world_, dph)


@pytest.mark.parametrize("world_,d", [(8, 4), (8, 2), (4, 2), (6, 3)])
def test_leg_groups_are_host_major_as_jax(world_, d):
    assert hier.ici_groups(world_, d) == jhier.ici_groups(world_, d)
    assert hier.dcn_groups(world_, d) == jhier.dcn_groups(world_, d)


def test_codec_tables_stay_in_sync():
    assert hier.CODEC_FACTORS == jhier.CODEC_FACTORS == \
        cm.HIER_CODEC_FACTORS == jcm.HIER_CODEC_FACTORS
    assert comp._INT8_MAX_AXIS == cm._INT8_MAX_AXIS
    for n, d in ((N, 2), (1000, 4), (256, 1), (1, 8)):
        assert hier.padded_shard_len(n, d) == jhier.padded_shard_len(n, d)


@pytest.mark.parametrize("codec", CODECS)
def test_init_hier_state_shapes_equal_jax(codec):
    for d, h in ((2, 2), (4, 1)):
        got = hier.init_hier_state(N, d, h, codec)
        want = jhier.init_hier_state(N, d, h, codec)
        if codec != "int8ef":
            assert got == () == want
        else:
            assert tuple(got.shape) == tuple(want.shape)
            assert not got.any()


# -- hier_mean on the world ------------------------------------------------------

@pytest.mark.parametrize("transport", ["grouped", "ring"])
@pytest.mark.parametrize("codec", CODECS)
def test_hier_mean_matches_jax(world, codec, transport, monkeypatch):
    assert world["legs"][0] == (ICI, WORLD // ICI)
    assert world["ici_size"] == [ICI] * WORLD
    assert world["dcn_size"] == [WORLD // ICI] * WORLD
    want, want_st, _ = _jax_hier(codec, transport == "grouped", _grads(),
                                 monkeypatch)
    ref = _grads().mean(axis=0)
    for r, res in enumerate(world[f"{transport}/{codec}"]):
        np.testing.assert_allclose(res["means"], want[r], rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
        if codec == "int8ef":
            np.testing.assert_allclose(res["state"], want_st[r], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} EF")
        # Within the codec's noise of the true mean.
        tol = {"f32": 1e-6, "bf16": 5e-3}.get(codec, 2e-2)
        assert np.abs(res["means"] - ref).max() <= tol
    if codec == "int8ef":  # a real residual (the shards holding data)
        assert max(np.abs(res["state"]).max()
                   for res in world[f"{transport}/{codec}"]) > 0


@pytest.mark.parametrize("codec", CODECS)
def test_transports_and_nested_mesh_agree(world, codec):
    """The ring transport and the nested ``(dcn, ici)`` mesh compute the
    grouped transport's means (the same schedule three ways)."""
    assert world["nested_shape"][0] == {"dcn": WORLD // ICI, "ici": ICI}
    for r in range(WORLD):
        grouped = world[f"grouped/{codec}"][r]["means"]
        np.testing.assert_allclose(world[f"ring/{codec}"][r]["means"],
                                   grouped, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(world[f"nested/{codec}"][r], grouped)


@pytest.mark.parametrize("codec", CODECS)
def test_one_host_is_the_flat_codec_bitwise(world, codec):
    for got, flat in world[f"flat/{codec}"]:
        np.testing.assert_array_equal(got, flat)


@pytest.mark.parametrize("codec", CODECS)
def test_wire_tally_equals_jax_and_the_cost_model(world, codec, monkeypatch):
    _, _, jtally = _jax_hier(codec, True, _grads(), monkeypatch)
    predicted = cm.Topology(WORLD, num_hosts=WORLD // ICI).hier_wire_split(
        N * 4.0, WORLD, codec)
    for transport in ("grouped", "ring"):
        tally = world[f"{transport}/{codec}"][0]["tally"]
        for leg in ("ici", "dcn"):
            assert tally[leg] == pytest.approx(jtally[leg], rel=1e-12)
            assert tally[leg] == pytest.approx(CALLS * predicted[leg],
                                               rel=1e-12)


def test_program_wire_split_equals_jax(monkeypatch):
    monkeypatch.setenv("AUTODIST_HIER_ICI", "4")

    class _Sync:
        def __init__(self, active=False, codec=None, ckind=0):
            self.compressor_kind = ckind
            self.hier_codec = codec
            self.devices_per_host = 4
            self.pconfig = type("P", (), {"active": active})()

    syncs = {"dense": _Sync(), "sharded": _Sync(active=True),
             "hier": _Sync(codec="bf16"), "i8": _Sync(codec="int8ef",
                                                      ckind=5),
             "h16": _Sync(ckind=1)}
    sizes = {"dense": 1024.0, "sharded": 1 << 30, "hier": 1024.0,
             "i8": 4096.0, "h16": 512.0}
    got = hier.program_wire_split(syncs, sizes, 8)
    want = jhier.program_wire_split(syncs, sizes, 8)
    assert got == pytest.approx(want, rel=1e-12)


def test_gather_wire_split_equals_jax(monkeypatch):
    """A serve dispatch's parameter gathers: only storage split over the
    data axis counts, one (g-1)/g sweep, its shard hops across hosts."""
    from autodist_tpu_torch.kernel.partitioner import PartitionSpec
    monkeypatch.setenv("AUTODIST_HIER_ICI", "4")

    class _Sync:
        def __init__(self, spec):
            self.devices_per_host = 4
            self.pconfig = type("P", (), {"active": bool(spec)})()
            self._spec = spec

        def param_spec(self):
            return PartitionSpec(*self._spec)

        def partitioned_over(self, axis):
            return axis in self._spec

    syncs = {"whole": _Sync(()), "data": _Sync(("data", None)),
             "model": _Sync((None, "model")), "data1": _Sync((None, "data"))}
    sizes = {"whole": 1024.0, "data": 4096.0, "model": 8192.0,
             "data1": 512.0}
    for world in (1, 4, 8):
        assert hier.gather_wire_split(syncs, sizes, world) == pytest.approx(
            jhier.gather_wire_split(syncs, sizes, world), rel=1e-12)


# -- the cost model's restored terms -------------------------------------------

@pytest.mark.parametrize("hosts,factor", [(1, 0.5), (2, 0.25), (4, 0.5),
                                          (8, 1.0), (2, 0.2578125)])
def test_hierarchical_ar_cost_equals_jax(hosts, factor):
    topo, jtopo = _topologies(64, hosts)
    for nbytes in (1 << 10, 8 << 20, 3e8):
        assert topo.hierarchical_ar_cost(nbytes, 64, factor) == \
            pytest.approx(jtopo.hierarchical_ar_cost(nbytes, 64, factor),
                          rel=1e-12)
    for codec in CODECS:
        assert topo.hier_wire_split(5e6, 64, codec) == pytest.approx(
            jtopo.hier_wire_split(5e6, 64, codec), rel=1e-12)
        assert cm.hier_dcn_factor(codec, hosts) == \
            jcm.hier_dcn_factor(codec, hosts)
    single = _topologies(8, 1)[0]
    assert single.hierarchical_ar_cost(8 << 20, 8, 0.5) == pytest.approx(
        single.all_reduce_cost(8 << 20, 8))


COST_BUILDERS = {
    "allreduce": lambda m: m.AllReduce(chunk_size=4),
    "zero1": lambda m: m.PS(),
    "fsdp": lambda m: m.PartitionedPS(),
    "dcn_int8ef": lambda m: m.AllReduce(all_reduce_spec="DCN",
                                        compressor="Int8CompressorEF"),
    "dcn_bf16": lambda m: m.AllReduce(all_reduce_spec="DCN",
                                      compressor="HorovodCompressor"),
    "powersgd": lambda m: m.AllReduce(compressor="PowerSGDCompressor"),
}


@pytest.mark.parametrize("builder", sorted(COST_BUILDERS))
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("bucket_mb,hier_codec", [(0, None), (16, None),
                                                  (0, "int8"), (4, "bf16")])
def test_strategy_cost_knobs_equal_jax(tmp_path, builder, overlap, unroll,
                                       bucket_mb, hier_codec):
    spec, jspec = _specs(tmp_path)
    jitem, item = _bert_items()
    strategy = COST_BUILDERS[builder](S).build(item, spec)
    jstrategy = COST_BUILDERS[builder](JS).build(jitem, jspec)
    topology, jtopology = _topologies(8, 2)
    kw = dict(unroll=unroll, overlap=overlap, bucket_bytes=bucket_mb << 20,
              hier=hier_codec)
    got = cm.CostModel(topology).strategy_cost(strategy, item, **kw)
    want = jcm.CostModel(jtopology).strategy_cost(jstrategy, jitem, **kw)
    _close(got, want)
    assert got.total_ms == pytest.approx(want.total_ms, rel=1e-9)
    assert got["overlap"] is overlap


@pytest.mark.parametrize("builder", sorted(COST_BUILDERS))
@pytest.mark.parametrize("bucket_mb", [0, 1, 64])
def test_strategy_memory_bucket_cap_equals_jax(tmp_path, builder, bucket_mb):
    spec, jspec = _specs(tmp_path)
    jitem, item = _bert_items()
    strategy = COST_BUILDERS[builder](S).build(item, spec)
    jstrategy = COST_BUILDERS[builder](JS).build(jitem, jspec)
    topology, jtopology = _topologies(8, 2)
    got = cm.CostModel(topology).strategy_memory(
        strategy, item, bucket_bytes=bucket_mb << 20)
    want = jcm.CostModel(jtopology).strategy_memory(
        jstrategy, jitem, bucket_bytes=bucket_mb << 20)
    _close(got, want, skip=("activations_bytes",))


def test_hierarchical_ef_state_is_a_shard(tmp_path):
    """The hierarchical EF residual is a DCN shard (1/d of the gradient):
    priced below the flat EF state, as in the JAX package."""
    spec, _ = _specs(tmp_path)
    _, item = _bert_items()
    model = cm.CostModel(_topologies(8, 2)[0])
    flat = model.strategy_memory(
        S.AllReduce(compressor="Int8CompressorEF").build(item, spec), item)
    two = model.strategy_memory(S.AllReduce(
        all_reduce_spec="DCN", compressor="Int8CompressorEF").build(
            item, spec), item)
    assert two["sync_state_bytes"] == pytest.approx(
        flat["sync_state_bytes"] / 4)
