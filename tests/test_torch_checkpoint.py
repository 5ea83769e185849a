"""The port's ``checkpoint/`` on the CPU, held to the JAX package's.

Counterparts of ``tests/test_checkpoint.py`` (round trip, manager resume,
params-only restores, serving restored params) on the port's one-rank
world, plus:

* the port's own on-disk format, read with numpy and ``json`` alone,
  bitwise its saves (a bfloat16 leaf included); atomic writes;
* a restore into a live state keeps the tensors a graph step is bound to;
* parity with the JAX package (tiny MLP, PS, Adam 1e-3 / eps 1e-6, f32):
  a resume (save at step 4 -> new manager -> ``restore_or_init`` -> steps
  5-8) gives the JAX package's losses within rtol 1e-4 / atol 1e-5 and
  the port's uninterrupted run's bitwise; the retained steps of a
  ``save_interval_steps`` / ``max_to_keep`` pair equal the JAX manager's
  (orbax's) exactly; the manifest's params entries (paths, shapes, dtypes)
  equal the JAX manifest's;
* N -> M: ``PS()`` (``zero1``), ``PartitionedPS()`` and ``PartitionedAR()``
  (``fsdp``) trained and saved on a 4-rank gloo world, with uneven dims
  stored padded, restore on 2 ranks and on 1 with params and optimizer
  state bitwise; the guarded, checkpointed loop on the 4 ranks.

The JAX package's raw (target-free) restores are not used as oracles.
"""
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu.checkpoint import CheckpointManager as JCheckpointManager
from autodist_tpu.models import mlp as jmlp
from autodist_tpu.strategy import PS as JPS
from autodist_tpu_torch import AutoDist, convert, resilience, serve
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager, Saver
from autodist_tpu_torch.checkpoint import manifest as manifest_mod
from autodist_tpu_torch.checkpoint import saver as saver_mod
from autodist_tpu_torch.checkpoint.manifest import ManifestMismatchError
from autodist_tpu_torch.models import mlp
from autodist_tpu_torch.resilience import chaos
from autodist_tpu_torch.strategy import PS, AllReduce
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # port (1 rank) vs JAX (8 devices), f32 Adam
RANK_TIMEOUT_S = 120
CFG = dict(in_dim=16, hidden=(32,), num_classes=4)  # mlp.tiny_fixture's


@pytest.fixture(autouse=True)
def _clean_state():
    autodist_mod._reset_default()
    resilience.clear_events()
    chaos.reset()
    yield
    autodist_mod._reset_default()
    resilience.clear_events()
    chaos.reset()


def _port(strategy=None, hidden=(32,)):
    jparams, _, batch = jmlp.tiny_fixture(seed=0)
    cfg = mlp.MLPConfig(in_dim=16, hidden=hidden, num_classes=4)
    params = (convert.params_from_jax(jax.device_get(jparams), "cpu")
              if hidden == (32,) else mlp.init(cfg, device="cpu"))
    ad = AutoDist(strategy_builder=strategy or PS(), device="cpu")
    item = ad.capture(mlp.make_loss_fn(cfg), params,
                      functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _jax():
    params, loss_fn, batch = jmlp.tiny_fixture(seed=0)
    ad = JAutoDist(strategy_builder=JPS())
    item = ad.capture(loss_fn, params, optax.adam(1e-3, eps=1e-6),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _batches(batch):
    return iter(lambda: batch, None)


def _named(tree):
    return {path_to_name(p): (l.detach().cpu() if isinstance(l, torch.Tensor)
                              else torch.from_numpy(np.array(l)))
            for p, l in flatten_with_path(tree)[0]}


def _logical(runner, state):
    return _named(manifest_mod.state_tree(runner.to_logical(state)))


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def _train(runner, batch, state, steps=3):
    metrics = None
    for _ in range(steps):
        state, metrics = runner.step(state, batch)
    return state, metrics


# -- round trips --------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    """Params, Adam's moments and its ``step`` tensor come back bitwise,
    into a fresh state of the runner, with a manifest beside them."""
    runner, batch = _port()
    state, _ = _train(runner, batch, runner.create_state())
    saver = Saver(runner)
    saver.save(state, tmp_path / "ckpt")
    assert os.path.isfile(manifest_mod.sidecar_path(tmp_path / "ckpt"))
    restored = saver.restore(tmp_path / "ckpt")
    assert int(restored.step) == 3 and restored.step.dtype == torch.int64
    assert restored.opt_state is not state.opt_state
    _assert_bitwise(_logical(runner, restored), _logical(runner, state))
    for p, q in zip(*(o.param_groups[0]["params"]
                      for o in (state.opt_state, restored.opt_state))):
        a, b = state.opt_state.state[p], restored.opt_state.state[q]
        assert a["step"].device == b["step"].device
        assert torch.equal(a["step"], b["step"]) and float(b["step"]) == 3
    # and it trains on as the original does
    s1, m1 = runner.step(state, batch)
    s2, m2 = runner.step(restored, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_bitwise(_logical(runner, s2), _logical(runner, s1))


def test_restore_into_a_live_state_keeps_the_graph_step_bound(tmp_path):
    """``restore(into=state)`` copies into the state's own tensors: the
    ``make_callable(aot=True)`` step bound to them keeps working (no new
    callable) and retraces the saved trajectory bitwise."""
    runner, batch = _port(AllReduce())
    step = runner.make_callable(batch, aot=True)
    state = runner.create_state()
    for _ in range(2):
        state, _ = step(state, batch)
    tensors = [t for _, t in flatten_with_path(state.params)[0]]
    Saver(runner).save(state, tmp_path / "ckpt")
    after = []
    for _ in range(2):
        state, m = step(state, batch)
        after.append(m["loss"])
    old = state
    state = Saver(runner).restore(tmp_path / "ckpt", into=state)
    assert int(state.step) == 2
    assert [t for _, t in flatten_with_path(state.params)[0]] == tensors
    with pytest.raises(RuntimeError, match="stale"):
        runner.step(old, batch)
    again = []
    for _ in range(2):
        state, m = step(state, batch)
        again.append(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(again, after))
    assert step.graph is not None and len(step.graphs) == 1


def _numpy_reader(path):
    """A reader of the format with numpy and the standard library alone:
    {path: ndarray}, a bfloat16 leaf as its uint16 bits."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    with open(os.path.join(path, "arrays.bin"), "rb") as f:
        data = f.read()
    out = {}
    for e in index["leaves"]:
        dtype = np.uint16 if e["dtype"] == "bfloat16" else np.dtype(e["dtype"])
        out[e["path"]] = (e["dtype"], np.frombuffer(
            data, dtype=dtype, count=int(np.prod(e["shape"], dtype=np.int64)),
            offset=e["offset"]).reshape(e["shape"]))
    return out


def test_format_reads_with_numpy_alone(tmp_path):
    """A training checkpoint and a bare tree holding a bfloat16 leaf,
    read by a plain numpy reader: bitwise the port's raw read and the
    state saved."""
    runner, batch = _port()
    state, _ = _train(runner, batch, runner.create_state())
    Saver(runner).save(state, tmp_path / "state")
    want = _logical(runner, state)
    got = _numpy_reader(tmp_path / "state")
    assert sorted(got) == sorted(want)
    for name, (dtype, arr) in got.items():
        assert dtype == manifest_mod.dtype_name(want[name].dtype)
        np.testing.assert_array_equal(arr, want[name].numpy())
    _assert_bitwise(_named(Saver().restore_raw(tmp_path / "state")), want)

    tree = {"emb": torch.randn(5, 3).to(torch.bfloat16),
            "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "scale": torch.tensor(2.5, dtype=torch.float64)}
    Saver().save(tree, tmp_path / "bare")
    got = _numpy_reader(tmp_path / "bare")
    assert got["emb"][0] == "bfloat16"
    np.testing.assert_array_equal(
        got["emb"][1], tree["emb"].view(torch.int16).numpy().view(np.uint16))
    raw = Saver().restore_raw(tmp_path / "bare")
    _assert_bitwise(_named(raw), _named(tree))
    assert Saver().restore_params(tmp_path / "bare").keys() == tree.keys()


def test_writes_are_atomic(tmp_path, monkeypatch):
    """A save that fails mid-write leaves no checkpoint (and no temporary
    directory) behind, and an existing checkpoint at the path untouched:
    the data file torn halfway through its write, and the data written
    whole but failing its fsync (the seal's first step)."""
    runner, batch = _port()
    state, _ = _train(runner, batch, runner.create_state(), steps=1)
    Saver(runner).save(state, tmp_path / "ckpt")
    before = _named(Saver().restore_raw(tmp_path / "ckpt"))
    torn = []

    class TornData:
        """``arrays.bin`` opened for writing: half the buffer reaches the
        file, then the disk is full."""

        def __init__(self, f):
            self.f = f

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.f.close()

        def write(self, data):
            data = memoryview(data).cast("B")
            torn.append(self.f.write(data[:data.nbytes // 2]))
            self.f.flush()
            raise OSError("disk full")  # not a transient error: no retry

    def torn_open(path, mode="r", *args, **kwargs):
        f = open(path, mode, *args, **kwargs)
        return TornData(f) if os.path.basename(path) == saver_mod.ARRAYS \
            else f

    def failing_fsync(fd):
        raise OSError("disk full")

    state, _ = runner.step(state, batch)
    for module, name, fault in ((saver_mod, "open", torn_open),
                                (saver_mod.os, "fsync", failing_fsync)):
        monkeypatch.setattr(module, name, fault, raising=False)
        for path in ("ckpt", "fresh"):
            with pytest.raises(OSError, match="disk full"):
                Saver(runner).save(state, tmp_path / path)
        monkeypatch.undo()
    assert len(torn) == 2 and all(n > 0 for n in torn), torn
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "ckpt.manifest.json"]
    _assert_bitwise(_named(Saver().restore_raw(tmp_path / "ckpt")), before)
    with pytest.raises(FileExistsError):
        saver_mod.write_tree(tmp_path / "ckpt", {"x": torch.zeros(1)},
                             force=False)


# -- the manager --------------------------------------------------------------

def test_manager_save_returns_before_the_write_is_durable(tmp_path,
                                                          monkeypatch):
    """``CheckpointManager.save`` stages the state and returns while its
    writer thread still writes; ``wait_until_finished`` blocks until the
    step is durable; the step then restores bitwise the state as it was at
    the save, though the live state took a step since (the staging copy is
    the save's own)."""
    import threading
    import time
    runner, batch = _port()
    state, _ = _train(runner, batch, runner.create_state(), steps=2)
    want = {k: v.clone() for k, v in _logical(runner, state).items()}
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1)
    gate = threading.Event()
    real = os.fsync

    def held(fd):
        gate.wait(timeout=5)
        real(fd)
    monkeypatch.setattr(saver_mod.os, "fsync", held)
    assert mgr.save(2, state)
    pending = not gate.is_set() and not (tmp_path / "mgr" / "2").exists()
    state, _ = runner.step(state, batch)  # the live tensors change
    waiter = threading.Thread(target=mgr.wait_until_finished)
    waiter.start()
    time.sleep(0.3)
    waited = waiter.is_alive()
    gate.set()
    waiter.join(timeout=60)
    assert pending, "save() returned only after the write was durable"
    assert waited, "wait_until_finished() did not wait for the write"
    assert not waiter.is_alive()
    assert (tmp_path / "mgr" / "2" / saver_mod.INDEX).exists()
    assert (tmp_path / "mgr" / "manifest-2.json").exists()
    monkeypatch.undo()
    got = _named(Saver().restore_raw(tmp_path / "mgr" / "2"))
    _assert_bitwise(got, want)
    assert int(mgr.restore_or_init().step) == 2
    mgr.close()


def test_manager_second_save_waits_and_failures_raise(tmp_path, monkeypatch):
    """A second save waits for the first write; a write that fails raises
    from the wait that follows it, and its step is not listed."""
    runner, batch = _port()
    state, _ = _train(runner, batch, runner.create_state(), steps=1)
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                            max_to_keep=1)
    assert mgr.save(1, state)
    state, _ = runner.step(state, batch)
    assert mgr.save(2, state)   # waits for step 1, prunes it once 2 is durable
    mgr.wait_until_finished()
    assert sorted(os.listdir(tmp_path / "mgr")) == ["2", "manifest-2.json"]

    def failing(fd):
        raise OSError("disk full")
    monkeypatch.setattr(saver_mod.os, "fsync", failing)
    state, _ = runner.step(state, batch)
    assert mgr.save(3, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    monkeypatch.undo()
    assert mgr.all_steps() == [2]
    assert sorted(os.listdir(tmp_path / "mgr")) == ["2", "manifest-2.json"]
    mgr.close()


_CRASH = r'''
import functools, os, sys
sys.path.insert(0, sys.argv[2])
import test_torch_checkpoint as t
from autodist_tpu_torch.checkpoint import CheckpointManager
runner, batch = t._port()
state, _ = t._train(runner, batch, runner.create_state(), steps=1)
mgr = CheckpointManager(runner, sys.argv[1], save_interval_steps=1)
mgr.save(1, state)
mgr.wait_until_finished()
state, _ = runner.step(state, batch)
os.fsync = lambda fd: os._exit(3)  # the process dies mid-write
mgr.save(2, state)
mgr.wait_until_finished()
'''


def test_a_crash_mid_write_leaves_no_step(tmp_path):
    """A process killed while its writer thread writes step 2 leaves step
    2 as a temporary directory only: a new manager lists step 1 alone and
    resumes from it."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", _CRASH,
                           str(tmp_path / "mgr"), tests], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 3, done.stderr[-3000:]
    assert any(".tmp-" in f for f in os.listdir(tmp_path / "mgr"))
    runner, _ = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1)
    assert mgr.all_steps() == [1]
    assert int(mgr.restore_or_init().step) == 1
    assert not any(k == "ckpt-fallback" for _, k, _ in resilience.events())
    mgr.close()



def test_checkpoint_manager_resume(tmp_path):
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                            max_to_keep=2)
    data = _batches(batch)
    state, _ = mgr.run(mgr.restore_or_init(), data, num_steps=3)
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    # Simulated preemption: a fresh manager resumes from step 3 and
    # continues to 5 without redoing steps.
    mgr2 = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                             max_to_keep=2)
    state2 = mgr2.restore_or_init()
    assert int(state2.step) == 3
    state2, _ = mgr2.run(state2, data, num_steps=5)
    assert int(state2.step) == 5 and mgr2.all_steps() == [4, 5]
    assert sorted(f for f in os.listdir(tmp_path / "mgr")
                  if f.startswith("manifest")) == ["manifest-4.json",
                                                  "manifest-5.json"]
    mgr.close()
    mgr2.close()


def _losses_after_resume(mgr_cls, runner, batch, directory, to_logical):
    """Save at step 4 (every step saved), drop the manager (the kill), a
    new manager's ``restore_or_init``, steps 5-8 one ``run`` call each:
    (losses of steps 5-8, the logical params after step 8)."""
    mgr = mgr_cls(runner, directory, save_interval_steps=1, max_to_keep=2)
    mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=4)
    mgr.close()
    mgr = mgr_cls(runner, directory, save_interval_steps=1, max_to_keep=2)
    state = mgr.restore_or_init()
    losses = []
    for n in range(5, 9):
        state, metrics = mgr.run(state, _batches(batch), num_steps=n)
        losses.append(float(np.asarray(metrics["loss"])))
    mgr.close()
    return losses, to_logical(state)


def test_resume_trajectory_matches_jax_and_the_uninterrupted_run(tmp_path):
    jrunner, batch = _jax()
    jlosses, jparams = _losses_after_resume(
        JCheckpointManager, jrunner, batch, tmp_path / "jax",
        lambda s: _named(jax.device_get(jrunner.logical_params(s))))
    runner, batch = _port()
    losses, params = _losses_after_resume(
        CheckpointManager, runner, batch, tmp_path / "port",
        lambda s: _named(runner.logical_params(s)))
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    for name in jparams:
        np.testing.assert_allclose(params[name].numpy(),
                                   jparams[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    state, _ = _train(runner, batch, runner.create_state(), steps=4)
    straight = []
    for _ in range(4):
        state, metrics = runner.step(state, batch)
        straight.append(float(metrics["loss"]))
    assert losses == straight
    _assert_bitwise(params, _named(runner.logical_params(state)))


@pytest.mark.parametrize("interval,keep,steps,more", [
    (1, 2, 5, 2), (2, 2, 7, 3), (3, None, 10, 2), (4, 2, 9, 4),
    (100, 3, 6, 3)])
def test_retained_steps_match_orbax(tmp_path, interval, keep, steps, more):
    """Which steps exist after ``run(steps)`` and after a second manager
    resumes to ``steps + more``: the port's manager and the JAX package's
    (orbax's) agree step for step, the first save of an empty directory
    included."""
    found = []
    for name, mgr_cls, build in (("jax", JCheckpointManager, _jax),
                                 ("port", CheckpointManager, _port)):
        runner, batch = build()
        got = []
        for n in (steps, steps + more):
            mgr = mgr_cls(runner, tmp_path / name, save_interval_steps=interval,
                          max_to_keep=keep)
            mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=n)
            got.append(sorted(int(s) for s in (
                mgr._mgr.all_steps() if name == "jax" else mgr.all_steps())))
            mgr.close()
        got.append(sorted(os.listdir(tmp_path / name)))
        found.append(got)
    assert found[0] == found[1]


def test_manifest_params_entries_match_jax(tmp_path):
    """The params' manifest entries (normalized paths, logical shapes,
    dtypes) are the JAX manifest's; the world and strategy blocks carry the
    same keys; the optimizer state is described in torch's terms."""
    jrunner, batch = _jax()
    jmgr = JCheckpointManager(jrunner, tmp_path / "jax", save_interval_steps=1)
    jmgr.run(jmgr.restore_or_init(), _batches(batch), num_steps=1)
    jmgr.close()
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "port", save_interval_steps=1)
    mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=1)
    man = [manifest_mod.read_manifest(tmp_path / d / "manifest-1.json")
           for d in ("jax", "port")]

    def params(m):
        return {k: v for k, v in m["leaves"].items()
                if k.startswith("params/")}
    assert params(man[1]) == params(man[0]) and len(params(man[0])) == 4
    for key in ("world", "strategy"):
        assert man[1][key].keys() == man[0][key].keys()
    assert man[1]["step"] == man[0]["step"] == 1
    assert man[1]["world"]["data_axis"] == 1
    assert man[1]["leaves"]["opt_state/dense0/kernel/exp_avg"] == \
        man[1]["leaves"]["params/dense0/kernel"]
    assert man[1]["leaves"]["step"] == {"shape": [], "dtype": "int64"}


def test_manifest_mismatch_raises_and_never_falls_back(tmp_path):
    """Restoring model A's checkpoint into model B raises, from the
    manager and from the Saver, instead of falling back or training
    fresh."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1)
    state, _ = mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=2)
    Saver(runner).save(state, tmp_path / "ckpt")
    autodist_mod._reset_default()
    other, _ = _port(hidden=(48,))
    with pytest.raises(ManifestMismatchError, match="logical shapes"):
        CheckpointManager(other, tmp_path / "mgr").restore_or_init()
    with pytest.raises(ManifestMismatchError):
        Saver(other).restore(tmp_path / "ckpt")
    assert not any(k == "ckpt-fallback" for _, k, _ in resilience.events())


def test_params_only_restore_from_manager_step(tmp_path):
    """``CheckpointManager.restore_params(step=...)`` reads a managed
    training checkpoint params-only (default: the latest step)."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                            max_to_keep=2)
    state, _ = mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=3)
    expect = _named(runner.logical_params(state))
    for which in (None, 3):  # latest and explicit
        _assert_bitwise(_named(mgr.restore_params(step=which)), expect)
    mgr.close()
    empty = CheckpointManager(runner, tmp_path / "empty")
    with pytest.raises(ValueError, match="no checkpoint steps"):
        empty.restore_params()
    empty.close()


def test_params_only_restore_serves(tmp_path):
    """A training checkpoint (Adam moments and all) yields just the params
    through ``Saver().restore_params`` (no Runner, no optimizer), and
    ``serve.Server`` answers with them bitwise as the model's forward on
    the live training params does."""
    runner, batch = _port()
    state, _ = _train(runner, batch, runner.create_state())
    Saver(runner).save(state, tmp_path / "ckpt")
    live = runner.logical_params(state)
    autodist_mod._reset_default()
    params = Saver().restore_params(tmp_path / "ckpt")
    _assert_bitwise(_named(params), _named(live))
    cfg = mlp.MLPConfig(**CFG)

    def apply_fn(p, x):
        return mlp.apply(p, cfg, x)
    x = batch[0]
    with serve.Server(apply_fn, params, x, buckets=(8,), max_wait_ms=1,
                      device="cpu") as srv:
        got = srv.infer(x, timeout=30)
    with torch.no_grad():
        want = apply_fn(live, torch.as_tensor(x))
    assert torch.equal(got, want)


# -- N -> M --------------------------------------------------------------------

_NM_RANK = r'''
import datetime, functools, json, os, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, resilience, strategy as S
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager, Saver
from autodist_tpu_torch.resilience import StepGuard

mode, directory, rank, world = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                                int(sys.argv[4]))
if world > 1:
    dist.init_process_group("gloo", init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
rng = np.random.RandomState(0)
# No dim of w1 / w2 divides by 4: the split variables are stored padded.
init = {"w1": rng.randn(18, 6).astype(np.float32) * 0.3,
        "w2": rng.randn(6, 3).astype(np.float32) * 0.3,
        "b": np.zeros(3, np.float32)}
x = rng.randn(16, 18).astype(np.float32)
y = rng.randn(16, 3).astype(np.float32)


def loss_fn(p, batch):
    bx, by = batch
    return torch.mean((torch.tanh(bx @ p["w1"]) @ p["w2"] + p["b"] - by) ** 2)


out = {}
local = 16 // world
mine = (x[rank * local:(rank + 1) * local], y[rank * local:(rank + 1) * local])
for name in ("PS", "PartitionedPS", "PartitionedAR"):
    ad = AutoDist(strategy_builder=getattr(S, name)(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, {k: torch.from_numpy(v) for k, v in init.items()},
        functools.partial(torch.optim.Adam, lr=1e-2), example_batch=mine))
    path = os.path.join(directory, name)
    resilience.clear_events()
    if mode == "save":
        state = runner.create_state()
        for _ in range(3):
            state, _ = runner.step(state, mine)
    else:
        state = Saver(runner).restore(path)
        path = f"{path}-on-{world}"
    Saver(runner).save(state, path)
    out[name] = {"kinds": sorted({k for k, _ in runner.var_kinds.values()}),
                 "padded": sorted(runner.program.paddings()),
                 "events": [k for _, k, _ in resilience.events()]}
    if mode == "save" and name == "PS":
        # The guarded, checkpointed loop on every rank: nan_at poisons each
        # rank's batch, the mean loss carries it to all, every rank rolls
        # back to the same checkpoint; the chief writes, all read.
        os.environ["AUTODIST_CHAOS"] = "nan_at=3"
        mgr = CheckpointManager(runner, f"{path}-managed",
                                save_interval_steps=1, max_to_keep=2)
        guard = StepGuard(check_every=1)
        state, _ = mgr.run(mgr.restore_or_init(), iter(lambda: mine, None),
                           5, step_guard=guard)
        del os.environ["AUTODIST_CHAOS"]
        params = runner.logical_params(state)
        out["managed"] = {
            "rollbacks": guard.rollbacks, "steps": mgr.all_steps(),
            "step": int(state.step),
            "params": {k: v.tolist() for k, v in params.items()}}
    autodist_mod._reset_default()
if world > 1:
    dist.destroy_process_group()
print(json.dumps(out))
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(world, args, cwd):
    """Run the N -> M rank script on ``world`` gloo ranks; returns (each
    rank's JSON, "") or (None, the failing rank's stderr). A free port can
    be taken before rank 0 binds: one retry."""
    for _ in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_",
                                    "LOCAL_", "AUTODIST_"))}
        env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", _NM_RANK, *args, str(r), str(world)],
            cwd=cwd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs, err = [], ""
        try:
            for p in procs:
                out, e = p.communicate(timeout=RANK_TIMEOUT_S)
                if p.returncode != 0:
                    err = e[-4000:]
                    break
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not err:
            return outs, ""
        if "ddress already in use" not in err:
            break
    return None, err


@pytest.fixture(scope="module")
def saved_on_four(tmp_path_factory):
    """Each builder trained 3 Adam steps on a 4-rank gloo world and saved
    there: (directory, rank 0's report)."""
    directory = tmp_path_factory.mktemp("nm")
    outs, err = _run_world(4, ["save", str(directory)], str(directory))
    assert outs is not None, err
    (directory / "managed.json").write_text(
        json.dumps([o.pop("managed") for o in outs]))
    return directory, outs[0]


def test_guarded_managed_run_on_four_ranks(saved_on_four):
    """``CheckpointManager.run`` with a ``StepGuard`` under ``PS()``
    (``zero1``) on 4 gloo ranks and ``nan_at=3``: every rank rolls back
    once to the step-2 checkpoint and ends on the same params; the
    retained steps are the same on every rank."""
    directory, _ = saved_on_four
    reports = json.loads((directory / "managed.json").read_text())
    assert len(reports) == 4
    for r in reports:
        assert r["rollbacks"] == 1 and r["step"] == 5
        assert r["steps"] == [4, 5]
        assert r["params"] == reports[0]["params"]
    for name, value in reports[0]["params"].items():
        assert np.isfinite(np.asarray(value)).all(), name


@pytest.mark.parametrize("world", [2, 1])
def test_restore_on_another_world_is_bitwise(saved_on_four, world):
    """A 4-rank checkpoint (``zero1`` shards, ``fsdp`` pieces, dims padded
    to 512 rows) restores on ``world`` ranks through the cross-shape path:
    the logical params and optimizer state the new world holds, saved
    again, are bitwise the 4-rank ones."""
    directory, four = saved_on_four
    assert {k for r in four.values() for k in r["kinds"]} >= {"zero1", "fsdp"}
    assert all(r["padded"] for r in four.values())
    outs, err = _run_world(world, ["restore", str(directory)],
                           str(directory))
    assert outs is not None, err
    for name, report in outs[0].items():
        assert report["events"] == ["reshard"], name
        want = _named(Saver().restore_raw(directory / name))
        got = _named(Saver().restore_raw(directory / f"{name}-on-{world}"))
        _assert_bitwise(got, want)
        assert any(k.startswith("opt_state/w1/exp_avg") for k in want)


def test_world_changed_and_validation_helpers():
    runner, _ = _port()
    man = {"world": manifest_mod.live_world(runner),
           "leaves": manifest_mod.params_entries(runner)}
    assert not manifest_mod.world_changed(man, runner)
    manifest_mod.validate_manifest(man, runner)
    for key in ("data_axis", "devices", "processes"):
        changed = dict(man, world=dict(man["world"], **{key: 4}))
        assert manifest_mod.world_changed(changed, runner)
    missing = dict(man, leaves={k: v for k, v in man["leaves"].items()
                                if k != "params/dense1/bias"})
    with pytest.raises(ManifestMismatchError, match="lacks"):
        manifest_mod.validate_manifest(missing, runner)
    assert manifest_mod.read_manifest("/nonexistent/manifest-1.json") is None
