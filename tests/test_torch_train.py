"""Data-parallel training through the port's user API against the JAX
package's Runner on its 8-device CPU mesh.

* Linear regression on a 4-rank gloo world (one subprocess per rank, each
  feeding its quarter of every 32-row batch): the port of
  ``tests/test_e2e_linreg.py::test_strategy_trains_and_matches_single_device``
  for ``all_reduce``, at that test's tolerance (rtol 1e-5, atol 1e-6).
* The tiny BERT, LM, MLP, ResNet, BiLSTM and NCF zoo fixtures on a
  one-rank gloo world, SGD and Adam: per-step losses and final params at
  rtol 1e-4 / atol 1e-5. The
  JAX side's attention off the TPU is its dense reference in f32, the
  port's the flash kernels' plain versions: the same f32 arithmetic in
  another order, compounded over three steps. Adam runs with eps 1e-6 on
  both sides (optax and torch both add it outside the square root): with
  the default 1e-8 an entry whose true gradient is 0 (the attention key
  bias: the softmax ignores it) or within f32 rounding of 0 moves by up to
  lr in a direction the rounding noise picks, and the noise differs
  between the two libraries and between runs.
* ``precision="bf16"`` training against the JAX package's
  ``capture(precision="bf16")`` (tolerance at the test).
* The probes of the verify skill that the port supports.
"""
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import bilstm as jbilstm
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import mlp as jmlp
from autodist_tpu.models import ncf as jncf
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import AutoDist, convert
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.models import bert, bilstm, lm, mlp, ncf, resnet
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _reset_port_singleton():
    autodist_mod._reset_default()
    yield
    autodist_mod._reset_default()


def _named(tree):
    return {path_to_name(p): np.asarray(
        l.detach().cpu().numpy() if isinstance(l, torch.Tensor) else l)
        for p, l in flatten_with_path(tree)[0]}


# -- linear regression on a 4-rank gloo world --------------------------------

_LINREG_RANK = r'''
import functools, json, sys
import numpy as np, torch
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce

data = np.load(sys.argv[1])
x, y = data["x"], data["y"]
rank, world = int(sys.argv[2]), int(sys.argv[3])


def loss_fn(params, batch):
    bx, by = batch
    return torch.mean((bx @ params["w"] + params["b"] - by) ** 2)


params = {"w": torch.from_numpy(data["w"]), "b": torch.from_numpy(data["b"])}
ad = AutoDist(strategy_builder=AllReduce(chunk_size=2), device="cpu")
local = 32 // world
item = ad.capture(loss_fn, params, functools.partial(torch.optim.SGD, lr=0.05),
                  example_batch=(x[:local], y[:local]))
runner = ad.create_distributed_session(item)
state = runner.create_state()
losses = []
for i in range(5):
    rows = slice(i * 32 + rank * local, i * 32 + (rank + 1) * local)
    state, metrics = runner.step(state, (x[rows], y[rows]))
    losses.append(float(metrics["loss"]))
print(json.dumps({"rank": rank, "losses": losses,
                  "mesh": dict(runner.program.mesh.shape),
                  "buckets": [list(b.names) for b in runner.bucket_plan()],
                  "w": state.params["w"].tolist(),
                  "b": state.params["b"].tolist()}))
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(data, world, port):
    """Run the linreg rank script on ``world`` gloo ranks; returns (each
    rank's JSON result, "") or (None, the failing rank's stderr)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_", "LOCAL_"))}
    env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LINREG_RANK, str(data), str(r), str(world)],
        cwd=os.path.dirname(data), env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                return None, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, ""


def _linreg_jax(x, y, w0, b0):
    """The JAX test's run: AllReduce(chunk_size=2), optax.sgd(0.05), five
    32-row batches on the 8-device mesh."""
    def loss_fn(params, batch):
        bx, by = batch
        return jax.numpy.mean((bx @ params["w"] + params["b"] - by) ** 2)
    ad = JAutoDist(strategy_builder=JAllReduce(chunk_size=2))
    item = ad.capture(loss_fn, {"w": w0, "b": b0}, optax.sgd(0.05),
                      example_batch=(x[:8], y[:8]))
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    losses = []
    for i in range(5):
        state, metrics = runner.step(state, (x[i * 32:(i + 1) * 32],
                                             y[i * 32:(i + 1) * 32]))
        losses.append(float(metrics["loss"]))
    return losses, jax.device_get(state.params)


def test_linreg_all_reduce_on_four_gloo_ranks_matches_jax(tmp_path):
    rng = np.random.RandomState(123)  # tests/test_e2e_linreg.py:make_data
    x = rng.randn(256, 16).astype(np.float32)
    y = (x @ np.full((16, 1), 3.0, np.float32) + 2.0 +
         0.01 * rng.randn(256, 1).astype(np.float32)).astype(np.float32)
    w0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 1)) * 0.1)
    b0 = np.zeros((1,), np.float32)
    np.savez(tmp_path / "data.npz", x=x, y=y, w=w0, b=b0)
    world = 4
    for _ in range(2):  # a free port can be taken before rank 0 binds
        outs, err = _run_ranks(tmp_path / "data.npz", world, _free_port())
        if outs is not None or "ddress already in use" not in err:
            break
    assert outs is not None, err
    want_losses, want = _linreg_jax(x, y, w0, b0)
    for o in outs:
        assert o["mesh"] == {"data": world}
        assert o["buckets"] == [["b", "w"]]  # chunk_size=2: one group
        np.testing.assert_allclose(o["losses"], want_losses, rtol=1e-5,
                                   atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(o[k]), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)
        assert o["w"] == outs[0]["w"] and o["b"] == outs[0]["b"]
    assert want_losses[-1] < want_losses[0]


# -- the tiny zoo models, one gloo rank vs the JAX Runner --------------------

ZOO = {"bert_tiny": (jbert, lambda: bert.make_loss_fn(bert.bert_tiny())),
       "lm_tiny": (jlm, lambda: lm.make_loss_fn(lm.lm_tiny())),
       "mlp_tiny": (jmlp, lambda: mlp.make_loss_fn(
           mlp.MLPConfig(in_dim=16, hidden=(32,), num_classes=4))),
       "resnet_tiny": (jresnet, lambda: resnet.make_loss_fn(
           resnet.cifar_resnet(depth=8, num_classes=10,
                               dtype=torch.float32))),
       "bilstm_tiny": (jbilstm, lambda: bilstm.make_loss_fn(
           bilstm.BiLSTMConfig(vocab=500, embed_dim=32, hidden=32))),
       "ncf_tiny": (jncf, lambda: ncf.make_loss_fn(ncf.NCFConfig(
           num_users=200, num_items=100, gmf_dim=16, mlp_dims=(32, 16, 8))))}
OPTIMIZERS = {"sgd": (lambda: optax.sgd(0.1),
                      functools.partial(torch.optim.SGD, lr=0.1)),
              "adam": (lambda: optax.adam(1e-3, eps=1e-6),
                       functools.partial(torch.optim.Adam, lr=1e-3,
                                         eps=1e-6))}


def _train_both(model, jopt, topt, precision=None, steps=3):
    """Three steps of the tiny fixture through the JAX Runner and the
    port's: (JAX losses, JAX params, port losses, port params), params by
    name as numpy."""
    jmod, make_loss = ZOO[model]
    jparams, jloss_fn, batch = jmod.tiny_fixture(seed=0)
    jparams = jax.device_get(jparams)
    ad = JAutoDist(strategy_builder=JAllReduce())
    runner = ad.create_distributed_session(
        ad.capture(jloss_fn, jparams, jopt, example_batch=batch,
                   precision=precision))
    state = runner.create_state()
    want_losses = []
    for _ in range(steps):
        state, metrics = runner.step(state, batch)
        want_losses.append(float(metrics["loss"]))
    want = _named(jax.device_get(state.params))

    tad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    trunner = tad.create_distributed_session(tad.capture(
        make_loss(), convert.params_from_jax(jparams, "cpu"), topt,
        example_batch=batch, precision=precision))
    tstate = trunner.create_state()
    losses = []
    for _ in range(steps):
        tstate, metrics = trunner.step(tstate, batch)
        assert metrics["loss"].dim() == 0 and not bool(metrics["notfinite"])
        assert metrics["loss"].dtype == torch.float32
        losses.append(float(metrics["loss"]))
    got = _named(tstate.params)
    assert sorted(got) == sorted(want)
    return want_losses, want, losses, got


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model", sorted(ZOO))
def test_zoo_training_matches_jax_runner(model, opt):
    jopt, topt = OPTIMIZERS[opt]
    want_losses, want, losses, got = _train_both(model, jopt(), topt)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-5)
    assert losses[-1] < losses[0]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("model", ["resnet_tiny", "mlp_tiny"])
def test_bf16_precision_training_matches_jax(model):
    """``capture(precision="bf16")`` on both sides, SGD 0.1, three steps.
    Both round the same f32 params and inputs to bf16 and compute from
    them; the sums differ in order, which moves a result by a bf16 ulp
    (2^-8 relative) where it lands near a rounding boundary. Losses at
    rtol 1e-2; params (f32 master weights) at atol 1e-3: lr x a gradient
    difference of a few bf16 ulps. The params stay float32."""
    want_losses, want, losses, got = _train_both(
        model, optax.sgd(0.1), functools.partial(torch.optim.SGD, lr=0.1),
        precision="bf16")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    assert losses[-1] < losses[0]
    for name in want:
        assert got[name].dtype == np.float32, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-2,
                                   atol=1e-3, err_msg=name)


# -- probes -------------------------------------------------------------------

def _linreg_setup(**capture_kwargs):
    rng = np.random.RandomState(0)
    x = rng.randn(64).astype(np.float32)
    y = (3 * x + 2).astype(np.float32)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(mlp.linreg_loss, mlp.linreg_init("cpu"),
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=(x[:8], y[:8]), **capture_kwargs)
    return ad, item, (x[:8], y[:8])


def test_one_rank_world_starts_and_is_destroyed_by_reset():
    ad, item, batch = _linreg_setup()
    runner = ad.create_distributed_session(item)
    assert torch.distributed.is_initialized()
    assert torch.distributed.get_backend() == "gloo"
    assert dict(runner.program.mesh.shape) == {"data": 1}
    assert runner.remapper.device == torch.device("cpu")
    assert not runner.program.use_explicit_path
    autodist_mod._reset_default()
    assert not torch.distributed.is_initialized()


def test_second_autodist_raises():
    AutoDist(strategy_builder=AllReduce(), device="cpu")
    with pytest.raises(NotImplementedError, match="Only one AutoDist"):
        AutoDist(strategy_builder=AllReduce(), device="cpu")


def test_no_builder_and_other_compressors_are_not_ported(monkeypatch):
    """No builder builds ``PS()``, the JAX package's default (a one-rank
    world lowers it to the replicated update). ``AllReduce(compressor=
    "HorovodCompressor")`` builds: its synchronizers hold the compressor,
    the explicit path runs, and its stateless wire keeps no sync state."""
    from autodist_tpu_torch.strategy.ps_strategy import PS
    monkeypatch.delenv("AUTODIST_STRATEGY", raising=False)
    ad = AutoDist(device="cpu")
    assert isinstance(ad._strategy_builder, PS)
    item = ad.capture(mlp.linreg_loss, mlp.linreg_init("cpu"),
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=(np.zeros(8, np.float32),
                                     np.zeros(8, np.float32)))
    runner = ad.create_distributed_session(item)
    assert all(n.WhichOneof("synchronizer") == "ps_synchronizer"
               for n in runner.program.strategy.node_config)
    assert set(runner.var_kinds.values()) == {("ar", None)}
    autodist_mod._reset_default()
    monkeypatch.setenv("AUTODIST_STRATEGY", "allreduce")
    ad = AutoDist(device="cpu")
    assert isinstance(ad._strategy_builder, AllReduce)
    autodist_mod._reset_default()
    monkeypatch.delenv("AUTODIST_STRATEGY")
    ad = AutoDist(strategy_builder=AllReduce(compressor="HorovodCompressor"),
                  device="cpu")
    item = ad.capture(mlp.linreg_loss, mlp.linreg_init("cpu"),
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=(np.zeros(8, np.float32),
                                     np.zeros(8, np.float32)))
    runner = ad.create_distributed_session(item)
    from autodist_tpu_torch.kernel.synchronization.compressor import \
        HorovodCompressor
    assert all(isinstance(s.compressor, HorovodCompressor)
               for s in runner.program.synchronizers.values())
    assert runner.program.use_explicit_path
    assert runner.create_state().sync_state == {}


def test_stale_train_state_raises():
    ad, item, batch = _linreg_setup()
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    new_state, _ = runner.step(state, batch)
    with pytest.raises(RuntimeError, match="previous step"):
        runner.step(state, batch)
    runner.step(new_state, batch)  # the live handle still steps


def test_function_steps_its_internal_state():
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    x = np.linspace(-1, 1, 8).astype(np.float32)
    batch = (x, (3 * x + 2).astype(np.float32))

    @ad.function(optimizer=functools.partial(torch.optim.SGD, lr=0.1))
    def train_step(params, batch):
        return mlp.linreg_loss(params, batch)
    params = mlp.linreg_init("cpu")
    losses = [float(train_step(params, batch)["loss"]) for _ in range(3)]
    assert losses[2] < losses[1] < losses[0]
    runner, state = ad._fn_state
    assert int(state.step) == 3
    assert float(params["W"]) == 0.0  # the captured tree is untouched
    assert float(state.params["W"].detach()) != 0.0
    with pytest.raises(TypeError, match="optimizer factory"):
        ad.function(optimizer=torch.optim.SGD([torch.zeros(1)], lr=0.1))


def test_non_trainable_variable_is_left_unchanged():
    ad, item, batch = _linreg_setup(non_trainable=("b",))
    assert [v.name for v in item.trainable_variables] == ["W"]
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    for _ in range(3):
        state, _ = runner.step(state, batch)
    assert float(state.params["b"]) == 0.0
    assert not state.params["b"].requires_grad
    assert float(state.params["W"].detach()) != 0.0
    assert len(state.opt_state.param_groups[0]["params"]) == 1


def test_aux_output_and_make_callable_and_run(tmp_path):
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    x = np.linspace(-1, 1, 8).astype(np.float32)
    batch = (x, (3 * x + 2).astype(np.float32))

    def loss_fn(params, b):
        loss = mlp.linreg_loss(params, b)
        return loss, {"double": 2 * loss}
    item = ad.capture(loss_fn, mlp.linreg_init("cpu"),
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=batch, aux_output=True)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    fn = runner.make_callable(batch, shard_inputs=True)
    state, metrics = fn(state, batch)
    assert float(metrics["aux"]["double"]) == pytest.approx(
        2 * float(metrics["loss"]))
    state, metrics = runner.run(state, iter([batch] * 3), 3,
                                trace_dir=str(tmp_path / "trace"))
    assert int(state.step) == 4
    assert os.listdir(tmp_path / "trace") == ["trace-rank0.json"]
    # The ahead-of-time step (bench.py's call) and run(unroll=2) take the
    # eager step's trajectory, bitwise on the CPU.
    eager, graphed = runner.create_state(), runner.create_state()
    aot = runner.make_callable(batch, aot=True)
    for _ in range(2):
        eager, want = runner.step(eager, batch)
        graphed, got = aot(graphed, runner.remapper.shard_batch(batch))
        assert float(got["loss"]) == float(want["loss"])
        assert float(got["aux"]["double"]) == float(want["aux"]["double"])
    graphed, got = runner.run(graphed, iter([batch] * 2), 2, unroll=2)
    losses = []
    for _ in range(2):
        eager, want = runner.step(eager, batch)
        losses.append(float(want["loss"]))
    assert got["loss"].tolist() == losses
    assert got["aux"]["double"].shape == (2,)
    assert int(graphed.step) == int(eager.step) == 4
    for name, want in _named(eager.params).items():
        np.testing.assert_array_equal(_named(graphed.params)[name], want)
    # A step guard on a healthy run: no rollback, every step taken.
    from autodist_tpu_torch.resilience import StepGuard
    guard = StepGuard(check_every=1)
    state, metrics = runner.run(state, iter([batch] * 2), 2, step_guard=guard)
    assert guard.rollbacks == 0 and int(state.step) == 6
    assert not bool(metrics["notfinite"])


def test_non_divisible_global_batch_raises(tmp_path):
    """One process driving a mesh of several devices (the JAX test mesh's
    shape): the JAX package's error, word for word. A rank mesh of one
    device per process always divides: local rows x ranks."""
    from autodist_tpu_torch.cluster import Cluster
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.remapper import Remapper
    from autodist_tpu_torch.resource_spec import ResourceSpec
    spec_file = tmp_path / "spec.yml"
    spec_file.write_text("nodes:\n  - address: localhost\n"
                         "    cpus: [0, 1, 2, 3, 4, 5, 6, 7]\n")
    spec = ResourceSpec(str(spec_file))
    _, item, _ = _linreg_setup()
    cluster = Cluster(spec)
    cluster.build_mesh()
    prog = GraphTransformer(AllReduce().build(item, spec), cluster,
                            item).transform()
    with pytest.raises(ValueError, match="global batch 3 not divisible by "
                                         "data-axis size 8"):
        Remapper(prog).shard_batch((np.zeros(3, np.float32),
                                    np.zeros(3, np.float32)))
