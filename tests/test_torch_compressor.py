"""The port's wire compressors against the JAX package.

* ``_int8_quantize``: q and scales exactly equal (odd lengths, an all-zero
  block, large and tiny magnitudes);
* every compressor's ``reduce`` on a 4-rank gloo world against the JAX
  compressor under ``shard_map`` on a 4-device sub-mesh, three calls
  threading the state: the means at rtol 1e-5 (int8 and PowerSGD 1e-4),
  the error-feedback residuals and PowerSGD's residual likewise, ``q``
  up to its columns' signs (Gram-Schmidt in the port, Householder QR in
  JAX); the requantizing int8 ring forced at W = 4 through
  ``_INT8_MAX_AXIS`` on both sides (``tests/test_int8_compressor.py``'s
  device);
* the linreg trajectory of ``tests/test_e2e_linreg.py``'s compressor cases
  (AllReduce(chunk_size=2, compressor=...), SGD 0.05, 12 steps of 32 rows)
  on the 4-rank world under each compressor and the hierarchical DCN spec
  (``AUTODIST_HIER_ICI=2``: 2 hosts x 2), held to the JAX Runner's losses
  and params on 4 devices at rtol 1e-4 (PowerSGD's rank-1 matrix leaves
  its second factor at rounding noise in both packages: 1e-3);
* the PowerSGD ``q`` seed: the JAX package's md5 of the name, the same on
  every rank, drawn by a ``torch.Generator`` (a known difference: not the
  ``jax.random`` values), and ``convert.sync_state_from_jax``.

One world runs every multi-rank case (a module fixture; each case is a
test of its own).
"""
import fcntl
import hashlib
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from autodist_tpu.kernel.synchronization import compressor as jcomp
from autodist_tpu_torch import convert
from autodist_tpu_torch.kernel.synchronization import compressor as comp

WORLD = 4
VAR = "layer0/attn/wq"
KINDS = ("NoneCompressor", "HorovodCompressor", "HorovodCompressorEF",
         "Int8Compressor", "Int8CompressorEF", "PowerSGDCompressor")
CALLS = 3
SHAPES = {"matrix": (37, 23), "vector": (300,)}
#: rtol / atol per wire (bf16 is the same emulated rounding; int8 and
#: PowerSGD differ by the sum's order and the orthogonalization).
TOL = {"NoneCompressor": (1e-5, 1e-6), "HorovodCompressor": (1e-5, 1e-6),
       "HorovodCompressorEF": (1e-5, 1e-6), "Int8Compressor": (1e-4, 1e-5),
       "Int8CompressorEF": (1e-4, 1e-5), "PowerSGDCompressor": (1e-4, 1e-5)}
LINREG_CASES = KINDS[1:] + ("DCN:Int8CompressorEF", "DCN:HorovodCompressor")
LINREG_STEPS = 12


def _grads(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(WORLD, CALLS, *shape).astype(np.float32)


def _jax_init(kind, shape):
    return jcomp.Compressor.create(kind, VAR).init_state(shape, jnp.float32)


def _jax_reduce(kind, grads):
    """(means (CALLS,) + shape, final state per device) of the JAX
    compressor on a 4-device sub-mesh."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    c = jcomp.Compressor.create(kind, VAR)
    st0 = _jax_init(kind, grads.shape[2:])

    def f(g):
        st, outs = st0, []
        for i in range(CALLS):
            red, st = c.reduce(g[0, i], st, "data")
            outs.append(red)
        return jnp.stack(outs)[None], jax.tree_util.tree_map(
            lambda x: x[None], st)
    fm = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("data"),
                               out_specs=(P("data"), P("data")),
                               check_vma=False))
    red, st = fm(jnp.asarray(grads))
    return np.asarray(red), jax.tree_util.tree_map(np.asarray, st)


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, functools, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, convert, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.kernel.synchronization import compressor as comp
from autodist_tpu_torch.kernel.synchronization import hierarchical

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
res = {}


def leaves(st):
    if isinstance(st, dict):
        return {k: v.numpy().copy() for k, v in st.items()}
    if isinstance(st, torch.Tensor):
        return st.numpy().copy()
    return st


def reduce_case(kind, shape_name, ring):
    comp._INT8_MAX_AXIS = 2 if ring else 8
    g = torch.from_numpy(inp["grads"][shape_name][rank])
    c = comp.Compressor.create(kind, inp["var"])
    st = c.init_state(g.shape[1:], torch.float32, "cpu")
    own_q = None
    if isinstance(st, dict):
        own_q = st["q"].numpy().copy()
        st = convert.sync_state_from_jax(
            {inp["var"]: inp["q0"][shape_name]}, rank, "cpu")[inp["var"]]
    outs = []
    for i in range(g.shape[0]):
        red, st = c.reduce(g[i].clone(), st, None)
        outs.append(red.numpy().copy())
    comp._INT8_MAX_AXIS = 8
    return {"means": np.stack(outs), "state": leaves(st), "own_q": own_q}


for kind in inp["kinds"]:
    for shape_name in inp["grads"]:
        res[f"{kind}/{shape_name}"] = reduce_case(kind, shape_name, False)
for kind in ("Int8Compressor", "Int8CompressorEF"):
    res[f"{kind}/ring"] = reduce_case(kind, "matrix", True)


def linreg_loss(p, b):
    bx, by = b
    return torch.mean((bx @ p["w"] + p["b"] - by) ** 2)


x, y = inp["x"], inp["y"]
local = 32 // world
for case in inp["linreg"]:
    autodist_mod._reset_default()
    spec, _, kind = case.rpartition(":")
    if spec:
        os.environ["AUTODIST_HIER_ICI"] = "2"
        builder = S.AllReduce(chunk_size=2, all_reduce_spec=spec,
                              compressor=kind)
    else:
        builder = S.AllReduce(chunk_size=2, compressor=kind)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    params = {"w": torch.from_numpy(inp["w0"]), "b": torch.from_numpy(inp["b0"])}
    item = ad.capture(linreg_loss, params,
                      functools.partial(torch.optim.SGD, lr=0.05),
                      example_batch=(x[:local], y[:local]))
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    if "w" in state.sync_state and isinstance(state.sync_state["w"], dict):
        mine = convert.sync_state_from_jax(inp["linreg_q0"], rank, "cpu")
        for k in ("q", "residual"):
            state.sync_state["w"][k].copy_(mine["w"][k])
    hierarchical.reset_wire_tally()
    losses = []
    for i in range(inp["steps"]):
        rows = slice((i % 8) * 32 + rank * local, (i % 8) * 32 + (rank + 1) * local)
        state, m = runner.step(state, (x[rows], y[rows]))
        losses.append(float(m["loss"]))
    res[f"linreg/{case}"] = {
        "losses": losses,
        "params": {k: v.detach().numpy().copy() for k, v in
                   runner.logical_params(state).items()},
        "sync_keys": sorted(state.sync_state),
        "tally": hierarchical.wire_tally(),
        "buckets": [list(b.names) for b in runner.bucket_plan()]}
    os.environ.pop("AUTODIST_HIER_ICI", None)
dist.barrier()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''


def _linreg_data():
    rng = np.random.RandomState(123)
    x = rng.randn(256, 16).astype(np.float32)
    y = (x @ np.full((16, 1), 3.0, np.float32) + 2.0 +
         0.01 * rng.randn(256, 1).astype(np.float32)).astype(np.float32)
    w0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 1)) * 0.1,
                    np.float32)
    return x, y, w0, np.zeros((1,), np.float32)


def _jax_linreg(case):
    """(losses, params, powersgd q0 per device or None) of the JAX Runner
    on 4 devices."""
    from autodist_tpu import AutoDist as JAutoDist
    from autodist_tpu.autodist import _reset_default
    from autodist_tpu.strategy import AllReduce as JAllReduce
    import os
    x, y, w0, b0 = _linreg_data()
    spec, _, kind = case.rpartition(":")
    _reset_default()
    old = os.environ.get("AUTODIST_HIER_ICI")
    if spec:
        os.environ["AUTODIST_HIER_ICI"] = "2"
    try:
        builder = JAllReduce(chunk_size=2, all_reduce_spec=spec,
                             compressor=kind) if spec else \
            JAllReduce(chunk_size=2, compressor=kind)
        ad = JAutoDist(strategy_builder=builder, devices=jax.devices()[:WORLD],
                       mesh_axes={"data": WORLD})

        def loss_fn(p, b):
            bx, by = b
            return jnp.mean((bx @ p["w"] + p["b"] - by) ** 2)
        item = ad.capture(loss_fn, {"w": jnp.asarray(w0),
                                    "b": jnp.asarray(b0)},
                          optax.sgd(0.05), example_batch=(x[:32], y[:32]))
        runner = ad.create_distributed_session(item)
        state = runner.create_state()
        q0 = None
        if kind == "PowerSGDCompressor":
            q0 = jax.tree_util.tree_map(np.asarray,
                                        jax.device_get(state.sync_state))
        losses = []
        for i in range(LINREG_STEPS):
            b = (x[(i % 8) * 32:(i % 8) * 32 + 32],
                 y[(i % 8) * 32:(i % 8) * 32 + 32])
            state, m = runner.step(state, b)
            losses.append(float(jax.device_get(m["loss"])))
        params = {k: np.asarray(jax.device_get(v))
                  for k, v in runner.logical_params(state).items()}
        return np.asarray(losses), params, q0
    finally:
        _reset_default()
        if old is None:
            os.environ.pop("AUTODIST_HIER_ICI", None)
        else:
            os.environ["AUTODIST_HIER_ICI"] = old


_JAX_LINREG = {}


def _jax_linreg_cached(case):
    if case not in _JAX_LINREG:
        _JAX_LINREG[case] = _jax_linreg(case)
    return _JAX_LINREG[case]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-rank case, run once per test session on a 4-rank gloo
    world (the first xdist worker to need it runs it under a file lock):
    {case: [rank 0's result, ...]}."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "compressor_world"
    with open(shared / "compressor_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            x, y, w0, b0 = _linreg_data()
            q0 = {name: _jax_init("PowerSGDCompressor", shape)
                  for name, shape in SHAPES.items()}
            q0 = {name: ({k: np.broadcast_to(np.asarray(v)[None],
                                             (WORLD,) + np.shape(v))
                          for k, v in st.items()} if st else ())
                  for name, st in q0.items()}
            _, _, lq0 = _jax_linreg_cached("PowerSGDCompressor")
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({"grads": {n: _grads(s, i) for i, (n, s) in
                                       enumerate(SHAPES.items())},
                             "var": VAR, "kinds": KINDS, "q0": q0,
                             "x": x, "y": y, "w0": w0, "b0": b0,
                             "linreg": LINREG_CASES, "steps": LINREG_STEPS,
                             "linreg_q0": lq0}, f)
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


# -- the quantizer -------------------------------------------------------------

def _quant_inputs():
    rng = np.random.RandomState(7)
    yield rng.randn(1000).astype(np.float32)
    yield np.zeros(300, np.float32)
    big = rng.randn(777).astype(np.float32) * 1e4
    big[256:512] = 0.0   # an all-zero block: scale 0
    yield big
    yield (rng.randn(256) * 1e-20).astype(np.float32)
    yield np.float32([0.5, -0.5, 1.5, 127.0, -254.0, 3.0])


@pytest.mark.parametrize("i", range(5))
def test_int8_quantize_equals_jax(i):
    x = list(_quant_inputs())[i]
    q, s, pad = comp._int8_quantize(torch.from_numpy(x))
    jq, js, jpad = jcomp._int8_quantize(jnp.asarray(x))
    assert pad == jpad
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("w,expect", [(2, "allgather"), (8, "allgather"),
                                      (9, "ring"), (64, "ring")])
def test_int8_transport_crossover_equals_jax(w, expect):
    assert comp.int8_transport(w) == jcomp.int8_transport(w) == expect
    assert comp._INT8_MAX_AXIS == jcomp._INT8_MAX_AXIS


def test_create_builds_every_kind():
    for kind in KINDS:
        c = comp.Compressor.create(kind, VAR)
        assert type(c).__name__ == kind
        assert type(comp.Compressor.create(
            comp._C.Value(kind))).__name__ == kind


def test_powersgd_seed_is_the_jax_name_seed():
    """The port's ``q`` seed is the JAX package's (md5 of the name), its
    draw a torch generator's: the same tensor on every call (every rank),
    standard normal, shape (n, rank)."""
    want = int(hashlib.md5(VAR.encode()).hexdigest()[:8], 16)
    assert comp.name_seed(VAR) == want
    c = comp.PowerSGDCompressor(VAR)
    a = c.init_state((37, 23), torch.float32, "cpu")
    b = c.init_state((37, 23), torch.float32, "cpu")
    assert a["q"].shape == (23, 2) and a["residual"].shape == (37, 23)
    assert torch.equal(a["q"], b["q"])
    assert c.init_state((5,), torch.float32, "cpu") == ()


def test_orthogonalize_spans_the_qr_columns():
    """Gram-Schmidt gives orthonormal columns equal to JAX's QR's up to
    their signs, and ``p_hat q^T`` does not see the signs; a zero column
    stays zero (finite)."""
    rng = np.random.RandomState(3)
    p = rng.randn(40, 2).astype(np.float32)
    got = comp.PowerSGDCompressor._orthogonalize(torch.from_numpy(p)).numpy()
    want = np.asarray(jcomp.PowerSGDCompressor._orthogonalize(jnp.asarray(p)))
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got, want * signs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.T @ got, np.eye(2), atol=1e-6)
    zero = comp.PowerSGDCompressor._orthogonalize(torch.zeros(6, 2))
    assert torch.equal(zero, torch.zeros(6, 2))


# -- reduce on the world --------------------------------------------------------

def _close(got, want, kind, what):
    rtol, atol = TOL[kind]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"{kind}: {what}")


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_reduce_matches_jax(world, kind, shape_name):
    ranks = world[f"{kind}/{shape_name}"]
    grads = _grads(SHAPES[shape_name], list(SHAPES).index(shape_name))
    want, want_state = _jax_reduce(kind, grads)
    for r, res in enumerate(ranks):
        _close(res["means"], want[r], kind, f"rank {r} means")
        st = res["state"]
        if kind.endswith("EF"):
            _close(st, want_state[r], kind, f"rank {r} residual")
        elif kind == "PowerSGDCompressor" and shape_name == "matrix":
            _close(st["residual"], want_state["residual"][r], kind,
                   f"rank {r} residual")
            q, jq = st["q"], want_state["q"][r]
            signs = np.sign(np.sum(q * jq, axis=0))
            _close(q, jq * signs, kind, f"rank {r} q up to signs")
            # The port's own draw: one q on every rank.
            assert np.array_equal(res["own_q"], ranks[0]["own_q"])
        else:
            assert st == () or st is None or len(st) == 0
    # Every rank holds the same mean.
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["means"], ranks[0]["means"])


@pytest.mark.parametrize("kind", ["Int8Compressor", "Int8CompressorEF"])
def test_forced_ring_matches_jax(world, kind, monkeypatch):
    """``_INT8_MAX_AXIS = 2``: at W = 4 the stateless wire takes the
    requantizing ring (neighbour hops) and the EF wire the bf16 switch, as
    the JAX package does with the same constant."""
    monkeypatch.setattr(jcomp, "_INT8_MAX_AXIS", 2)
    ranks = world[f"{kind}/ring"]
    want, want_state = _jax_reduce(kind, _grads(SHAPES["matrix"], 0))
    for r, res in enumerate(ranks):
        _close(res["means"], want[r], kind, f"rank {r} ring means")
        if kind.endswith("EF"):
            _close(res["state"], want_state[r], kind, f"rank {r} residual")
    flat = world["Int8Compressor/matrix"][0]["means"]
    if kind == "Int8Compressor":  # another transport: other noise
        assert not np.array_equal(ranks[0]["means"], flat)


# -- the linreg trajectory --------------------------------------------------------

@pytest.mark.parametrize("case", LINREG_CASES)
def test_linreg_trajectory_matches_jax(world, case):
    want_losses, want_params, _ = _jax_linreg_cached(case)
    rtol = 1e-3 if case == "PowerSGDCompressor" else 1e-4
    for res in world[f"linreg/{case}"]:
        np.testing.assert_allclose(res["losses"], want_losses, rtol=rtol,
                                   atol=1e-5)
        for k, v in want_params.items():
            np.testing.assert_allclose(res["params"][k], v, rtol=rtol,
                                       atol=1e-5, err_msg=k)
    first = world[f"linreg/{case}"][0]
    assert np.isfinite(first["losses"]).all()
    assert first["losses"][-1] < first["losses"][0]
    kind = case.rpartition(":")[2]
    stateful = kind.endswith("EF") or kind == "PowerSGDCompressor"
    assert bool(first["sync_keys"]) == stateful
    if case.startswith("DCN:"):
        assert first["tally"]["dcn"] > 0


def test_sync_state_from_jax_takes_the_rank_row():
    st = {"w": {"q": np.arange(8, dtype=np.float32).reshape(4, 2, 1),
                "residual": np.ones((4, 3), np.float32)},
          "b": (), "v": np.full((4, 5), 2.0, np.float32)}
    got = convert.sync_state_from_jax(st, 2, "cpu")
    assert set(got) == {"w", "v"}
    assert torch.equal(got["w"]["q"], torch.tensor([[4.0], [5.0]]))
    assert torch.equal(got["v"], torch.full((5,), 2.0))
