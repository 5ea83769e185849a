"""The port's ``resilience/`` against the JAX package's, on the CPU.

Counterparts of ``tests/test_resilience.py``: the step guard (rollback to
the last checkpoint through ``CheckpointManager.run``, to the in-memory
snapshot through ``Runner.run``, under ``unroll=K`` at block granularity,
strikes then abort, the device-side flag), SIGTERM -> emergency
checkpoint -> resume (the signal is raised inside a subprocess, never in
the test process), the truncated-checkpoint fallbacks, retry/backoff and
the chaos knobs. Parity: the same ``nan_at`` schedule on the JAX package's
8-device CPU mesh and on the port's one-rank world gives the same
rollback events and final params within rtol 1e-4 / atol 1e-5 (f32; the
tolerance of ``tests/test_torch_train.py``: the same arithmetic in another
order over a few Adam steps, eps 1e-6 on both sides).

Hygiene: ``AUTODIST_CHAOS`` is only ever set with ``monkeypatch.setenv``;
files go under ``tmp_path``; both packages' event logs and one-shot chaos
state are cleared around every test; signal handlers are restored.
"""
import functools
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import resilience as jresilience
from autodist_tpu.checkpoint import CheckpointManager as JCheckpointManager
from autodist_tpu.models import mlp as jmlp
from autodist_tpu.resilience import StepGuard as JStepGuard
from autodist_tpu.resilience import chaos as jchaos
from autodist_tpu.strategy import PS as JPS
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import AutoDist, convert, resilience
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import runner as runner_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.checkpoint.manifest import state_tree
from autodist_tpu_torch.checkpoint.saver import read_tree
from autodist_tpu_torch.models import mlp
from autodist_tpu_torch.resilience import (DivergenceAbort, Preempted,
                                           PreemptionHandler, RetryPolicy,
                                           StepGuard, chaos, retry_call)
from autodist_tpu_torch.strategy import PS, AllReduce
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5  # port (1 rank) vs JAX (8 devices), f32 Adam
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean_state():
    autodist_mod._reset_default()
    for mod in (resilience, jresilience):
        mod.clear_events()
    for mod in (chaos, jchaos):
        mod.reset()
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    autodist_mod._reset_default()
    for mod in (resilience, jresilience):
        mod.clear_events()
    for mod in (chaos, jchaos):
        mod.reset()
    for s, h in before.items():
        assert signal.getsignal(s) == h, f"{s} handler leaked"


def _port(strategy=None):
    """The tiny MLP fixture on the port's one-rank CPU world (Adam 1e-3,
    eps 1e-6), from the JAX fixture's own params."""
    jparams, _, batch = jmlp.tiny_fixture(seed=0)
    cfg = mlp.MLPConfig(in_dim=16, hidden=(32,), num_classes=4)
    ad = AutoDist(strategy_builder=strategy or PS(), device="cpu")
    item = ad.capture(mlp.make_loss_fn(cfg),
                      convert.params_from_jax(jax.device_get(jparams), "cpu"),
                      functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _jax(strategy=None):
    params, loss_fn, batch = jmlp.tiny_fixture(seed=0)
    ad = JAutoDist(strategy_builder=strategy or JPS())
    item = ad.capture(loss_fn, params, optax.adam(1e-3, eps=1e-6),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _batches(batch):
    return iter(lambda: batch, None)


def _named(tree):
    return {path_to_name(p): np.asarray(
        l.detach().cpu().numpy() if isinstance(l, torch.Tensor) else l)
        for p, l in flatten_with_path(tree)[0]}


def _logical(runner, state):
    """The checkpoint form by name: step, params and optimizer state."""
    return _named(state_tree(runner.to_logical(state)))


def _events(mod, kinds=("chaos:nan", "rollback")):
    return [(k, d) for _, k, d in mod.events() if k in kinds]


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


# -- NaN divergence -> checkpoint rollback -----------------------------------

def test_nan_at_step_rolls_back_and_recovers_like_jax(tmp_path, monkeypatch):
    """``nan_at=3`` under ``CheckpointManager.run`` (save every step,
    check every step): both packages poison step 3, roll back to the
    step-2 checkpoint once, reach step 6 healthy, record the same events,
    and end on the same params (rtol 1e-4)."""
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=3")
    jrunner, batch = _jax()
    jmgr = JCheckpointManager(jrunner, tmp_path / "jax", save_interval_steps=1,
                              max_to_keep=3)
    jguard = JStepGuard(check_every=1, max_strikes=3)
    jstate, _ = jmgr.run(jmgr.restore_or_init(), _batches(batch), num_steps=6,
                         step_guard=jguard)
    want = _named(jax.device_get(jrunner.logical_params(jstate)))
    jmgr.close()

    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "port", save_interval_steps=1,
                            max_to_keep=3)
    guard = StepGuard(check_every=1, max_strikes=3)
    state, metrics = mgr.run(mgr.restore_or_init(), _batches(batch),
                             num_steps=6, step_guard=guard)
    assert guard.rollbacks == jguard.rollbacks == 1
    assert int(state.step) == 6
    assert np.isfinite(float(metrics["loss"]))
    assert _events(resilience) == _events(jresilience) == [
        ("chaos:nan", "poisoned batch at step 3"),
        ("rollback", "divergence at step 3: restored step 2 (strike 1/3)")]
    _assert_params_close(_named(runner.logical_params(state)), want)
    mgr.close()


def test_guard_never_persists_poisoned_state(tmp_path, monkeypatch):
    """The guard checks before every periodic save: no retained step holds
    non-finite params, whatever the check cadence (5 > the interval 1)."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "ckpt", save_interval_steps=1,
                            max_to_keep=5)
    guard = StepGuard(check_every=5, max_strikes=3)
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=2")
    state, _ = mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=4,
                       step_guard=guard)
    assert guard.rollbacks == 1 and mgr.all_steps() == [1, 2, 3, 4]
    for step in mgr.all_steps():
        raw = read_tree(os.path.join(mgr.directory, str(step)))
        for name, leaf in _named(raw["params"]).items():
            assert np.isfinite(leaf).all(), \
                f"checkpoint step {step} holds non-finite {name}"
    mgr.close()


def test_preemption_on_a_poisoned_step_persists_no_poisoned_state(
        tmp_path, monkeypatch):
    """A SIGTERM lands on the step that ``nan_at`` poisons: the guard reads
    the flag before the emergency save, rolls back to the step-2
    checkpoint, and the emergency save of that step writes nothing new.
    Every retained step is finite and the resume starts from step 2."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "ckpt", save_interval_steps=2,
                            max_to_keep=5)
    guard = StepGuard(check_every=10, max_strikes=3)
    handler = PreemptionHandler()
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=3")

    def batches():
        for n in range(1, 9):
            if n == 3:  # the signal handler's effect, set by hand
                handler._on_signal(signal.SIGTERM, None)
            yield batch

    with pytest.raises(Preempted) as e:
        mgr.run(mgr.restore_or_init(), batches(), num_steps=8,
                step_guard=guard, preemption=handler)
    assert e.value.saved_step == 2 and guard.rollbacks == 1
    assert mgr.all_steps() == [1, 2]
    assert ("preemption", "SIGTERM at step 2: emergency checkpoint skipped "
            "(dup)") in [(k, d) for _, k, d in resilience.events()]
    for step in mgr.all_steps():
        raw = read_tree(os.path.join(mgr.directory, str(step)))
        for name, leaf in _named(raw["params"]).items():
            assert np.isfinite(leaf).all(), \
                f"checkpoint step {step} holds non-finite {name}"
    state = mgr.restore_or_init()
    assert int(state.step) == 2
    assert all(np.isfinite(v).all()
               for v in _named(runner.logical_params(state)).values())
    mgr.close()


@pytest.mark.parametrize("unroll,nan_at", [(1, 2), (2, 3)])
def test_runner_run_guard_rolls_back_from_snapshot_like_jax(monkeypatch,
                                                            unroll, nan_at):
    """``Runner.run`` without a manager: the guard's device snapshot is the
    rollback target. Under ``unroll=2`` the check lands on block
    boundaries and the whole poisoned block is skipped. Both packages:
    one rollback, the same events, the same final params (rtol 1e-4)."""
    monkeypatch.setenv("AUTODIST_CHAOS", f"nan_at={nan_at}")
    jrunner, batch = _jax(JAllReduce())
    jguard = JStepGuard(check_every=1, max_strikes=2)
    jstate, jm = jrunner.run(jrunner.create_state(), _batches(batch),
                             num_steps=4, step_guard=jguard, unroll=unroll)
    want = _named(jax.device_get(jrunner.logical_params(jstate)))

    runner, batch = _port(AllReduce())
    guard = StepGuard(check_every=1, max_strikes=2)
    state, metrics = runner.run(runner.create_state(), _batches(batch),
                                num_steps=4, step_guard=guard, unroll=unroll)
    assert guard.rollbacks == jguard.rollbacks == 1
    assert _events(resilience) == _events(jresilience)
    assert np.isfinite(np.asarray(metrics["loss"])).all()
    assert int(state.step) == int(jax.device_get(jstate.step))
    _assert_params_close(_named(runner.logical_params(state)), want)
    if unroll > 1:  # rolled back into the graph's own tensors
        (graph_step,) = runner._graphs.values()
        assert graph_step.bound_to(state)


def test_rollback_before_the_first_step_drops_optimizer_state(monkeypatch):
    """A rollback to the step-0 snapshot (taken before Adam made its state)
    drops the optimizer's state and the graph step captures anew; the run
    then equals a clean run from the same init (bitwise: the same eager
    arithmetic on the CPU)."""
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=1")
    runner, batch = _port(AllReduce())
    guard = StepGuard(check_every=1, max_strikes=2)
    state, _ = runner.run(runner.create_state(), _batches(batch), 4,
                          step_guard=guard, unroll=2)
    assert guard.rollbacks == 1
    assert runner_mod.optimizer_generation(state.opt_state) == 1
    # The poisoned block was skipped and the loop ran its 4 steps from the
    # rolled-back step 0 on (every batch is the same one).
    assert int(state.step) == 4
    clean, _ = runner.run(runner.create_state(), _batches(batch), 4,
                          unroll=2)
    got, want = _logical(runner, state), _logical(runner, clean)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_strikes_then_abort():
    runner, batch = _port()
    state = runner.create_state()
    guard = StepGuard(check_every=1, max_strikes=1)
    guard.mark_good(0, state)
    guard.rollback(1)  # strike 1: allowed
    with pytest.raises(DivergenceAbort, match="diverged"):
        guard.rollback(1)  # strike 2 > max_strikes=1
    with pytest.raises(DivergenceAbort, match="no rollback target"):
        StepGuard().rollback(1)


def test_guard_flag_is_device_side():
    """The notfinite flag comes back as a 0-dim tensor (no host read in
    the step) and reflects the loss's finiteness."""
    runner, batch = _port(AllReduce())
    state, metrics = runner.step(runner.create_state(), batch)
    assert isinstance(metrics["notfinite"], torch.Tensor)
    assert metrics["notfinite"].dim() == 0
    assert not StepGuard.diverged(metrics)
    assert StepGuard.diverged({"notfinite": torch.tensor([False, True])})
    assert not StepGuard.diverged({})


def test_guard_knobs_from_env(monkeypatch):
    assert (StepGuard().check_every, StepGuard().max_strikes) == (
        JStepGuard().check_every, JStepGuard().max_strikes) == (10, 3)
    monkeypatch.setenv("AUTODIST_GUARD_CHECK_EVERY", "7")
    monkeypatch.setenv("AUTODIST_GUARD_MAX_STRIKES", "2")
    assert (StepGuard().check_every, StepGuard().max_strikes) == (7, 2)


# -- SIGTERM -> emergency checkpoint (in a subprocess) -----------------------

_SIGTERM_CHILD = r'''
import functools, json, os, signal, sys
import numpy as np, torch
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.models import mlp
from autodist_tpu_torch.resilience import Preempted
from autodist_tpu_torch.strategy import PS

directory = sys.argv[1]
cfg = mlp.MLPConfig(in_dim=16, hidden=(32,), num_classes=4)
rng = np.random.RandomState(0)
batch = (rng.randn(8, 16).astype(np.float32),
         rng.randint(0, 4, (8,)).astype(np.int32))
ad = AutoDist(strategy_builder=PS(), device="cpu")
runner = ad.create_distributed_session(ad.capture(
    mlp.make_loss_fn(cfg), mlp.init(cfg, device="cpu"),
    functools.partial(torch.optim.Adam, lr=1e-3), example_batch=batch))
# Interval 100: no periodic save after the first step's; only the
# emergency path can write the step-4 checkpoint the parent resumes from.
mgr = CheckpointManager(runner, directory, save_interval_steps=100)
before = signal.getsignal(signal.SIGTERM)


def batches():
    n = 0
    while True:
        n += 1
        if n == 4:  # delivered while the loop is mid-stream
            os.kill(os.getpid(), signal.SIGTERM)
        yield batch


try:
    mgr.run(mgr.restore_or_init(), batches(), num_steps=10, preemption=True)
except Preempted as e:
    print(json.dumps({"saved_step": e.saved_step, "code": e.code,
                      "latest": mgr.latest_step(),
                      "restored": signal.getsignal(signal.SIGTERM) == before}),
          flush=True)
    raise
'''


def _child(script, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("AUTODIST_CHAOS", None)
    return subprocess.run([sys.executable, "-c", script, *args], env=env,
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)


def test_sigterm_emergency_checkpoint_and_resume(tmp_path):
    """A child process trains under ``CheckpointManager.run(preemption=
    True)`` and SIGTERMs itself at batch 4: it writes the step-4
    checkpoint, restores the previous handler, and exits with 128 + 15;
    this process resumes from that step and trains on to step 6."""
    proc = _child(_SIGTERM_CHILD, str(tmp_path / "ckpt"))
    assert proc.returncode == 128 + signal.SIGTERM, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"saved_step": 4, "code": 128 + signal.SIGTERM,
                   "latest": 4, "restored": True}

    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "ckpt",
                            save_interval_steps=100)
    state = mgr.restore_or_init()
    assert int(state.step) == 4
    state, metrics = mgr.run(state, _batches(batch), num_steps=6)
    assert int(state.step) == 6
    assert np.isfinite(float(metrics["loss"]))
    # The child saved step 1 (the first save of an empty directory, as
    # orbax's InitialSavePolicy does) and step 4 (the emergency); 5 and 6
    # are not interval steps.
    assert mgr.all_steps() == [1, 4]
    mgr.close()


def test_sigterm_restores_previous_handler():
    before = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler().install()
    assert signal.getsignal(signal.SIGTERM) == h._on_signal
    h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


def test_preemption_handler_uninstalled_when_the_loop_raises(tmp_path):
    """``CheckpointManager.run(preemption=True)`` restores the previous
    handlers on every exit path, an exception from the data included."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "ckpt")
    before = signal.getsignal(signal.SIGTERM)

    def failing():
        yield batch
        raise KeyError("the data pipeline broke")

    with pytest.raises(KeyError):
        mgr.run(mgr.restore_or_init(), failing(), num_steps=4,
                preemption=True)
    assert signal.getsignal(signal.SIGTERM) == before


def test_preempted_check_saves_and_raises(tmp_path):
    """The poll point itself, with the signal's effect set by hand: a
    forced save at the step and ``Preempted`` carrying 128 + signum."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "ckpt",
                            save_interval_steps=100)
    state, _ = runner.step(runner.create_state(), batch)
    handler = PreemptionHandler()
    handler.check(mgr, 1, state)  # nothing pending: no save
    assert mgr.all_steps() == []
    handler._on_signal(signal.SIGINT, None)
    with pytest.raises(Preempted) as e:
        handler.check(mgr, 1, state)
    assert e.value.code == 128 + signal.SIGINT and e.value.saved_step == 1
    assert mgr.all_steps() == [1]
    assert ("preemption", "SIGINT at step 1: emergency checkpoint written") \
        in [(k, d) for _, k, d in resilience.events()]


# -- truncated checkpoint -> previous retained step --------------------------

def test_truncated_checkpoint_falls_back_to_previous_step(tmp_path):
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                            max_to_keep=3)
    state, _ = mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=4)
    expect = _logical(runner, state)
    mgr.close()

    assert chaos.truncate_checkpoint(tmp_path / "mgr") == 4
    assert chaos.truncate_checkpoint(tmp_path / "nowhere") is None

    mgr2 = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                             max_to_keep=3)
    state2 = mgr2.restore_or_init()
    assert int(state2.step) == 3, "must fall back to the previous step"
    kinds = {k for _, k, _ in resilience.events()}
    assert "ckpt-fallback" in kinds and "chaos:ckpt-truncate" in kinds
    # The fallback state is the real step-3 state: one more step lands on
    # the uninterrupted run's step 4, bitwise (the same CPU arithmetic).
    state2, _ = runner.step(state2, batch)
    got = _logical(runner, state2)
    for name in expect:
        np.testing.assert_array_equal(got[name], expect[name], err_msg=name)
    mgr2.close()


def test_all_checkpoints_corrupt_inits_fresh(tmp_path):
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1,
                            max_to_keep=2)
    mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=2)
    mgr.close()
    for step in (2, 1):
        chaos.truncate_checkpoint(tmp_path / "mgr", step=step)
    mgr2 = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1)
    state2 = mgr2.restore_or_init()
    assert int(state2.step) == 0  # fresh init, not a crash
    init = _named(runner.program.graph_item.params)
    got = _named(state2.params)
    for name in init:
        np.testing.assert_array_equal(got[name], init[name])
    mgr2.close()


def test_sentinel_mismatch_falls_back(tmp_path):
    """A step directory whose ``step`` leaf says another step (a copied or
    renamed directory) is not trusted: the previous step is restored."""
    runner, batch = _port()
    mgr = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1)
    mgr.run(mgr.restore_or_init(), _batches(batch), num_steps=2)
    os.rename(tmp_path / "mgr" / "2", tmp_path / "mgr" / "7")
    mgr2 = CheckpointManager(runner, tmp_path / "mgr", save_interval_steps=1)
    assert mgr2.all_steps() == [1, 7]
    assert int(mgr2.restore_or_init().step) == 1
    assert any(k == "ckpt-fallback" and "sentinel" in d
               for _, k, d in resilience.events())


# -- retry / backoff ---------------------------------------------------------

def test_retry_recovers_transient_and_respects_predicate():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("transient")
        return 42

    assert retry_call(flaky, sleep=sleeps.append) == 42
    assert len(calls) == 3 and len(sleeps) == 2
    assert all(s >= 0 for s in sleeps)

    def fatal():
        raise ValueError("a bug, not a flake")

    with pytest.raises(ValueError):
        retry_call(fatal, sleep=sleeps.append)
    assert len(sleeps) == 2  # no backoff spent on non-retryable errors


def test_retry_exhausts_attempts():
    calls = []

    def always_down():
        calls.append(1)
        raise ConnectionError("unavailable")

    with pytest.raises(ConnectionError):
        retry_call(always_down, policy=RetryPolicy(max_attempts=3),
                   sleep=lambda _: None)
    assert len(calls) == 3
    assert any(k == "retry" for _, k, _ in resilience.events())


def test_retry_backoff_grows():
    sleeps = []

    def always_down():
        raise TimeoutError("x")

    with pytest.raises(TimeoutError):
        retry_call(always_down,
                   policy=RetryPolicy(max_attempts=4, base_delay=1.0,
                                      multiplier=2.0, jitter=0.0),
                   sleep=sleeps.append)
    assert sleeps == [1.0, 2.0, 4.0]


@pytest.mark.parametrize("exc", [
    RuntimeError("wait timeout after 300ms, keys: /k"),
    RuntimeError("Connection reset by peer"), OSError("try again"),
    TimeoutError("x"), RuntimeError("shape mismatch"), ValueError("timeout"),
    KeyError("deadline")])
def test_transient_predicate_matches_jax(exc):
    from autodist_tpu.resilience.retry import transient_runtime_error as jt
    from autodist_tpu_torch.resilience.retry import transient_runtime_error
    assert transient_runtime_error(exc) == jt(exc)


def test_retry_attempts_from_env(monkeypatch):
    from autodist_tpu_torch.resilience.retry import default_policy
    assert default_policy().max_attempts == 4
    monkeypatch.setenv("AUTODIST_RETRY_MAX_ATTEMPTS", "0")
    assert default_policy().max_attempts == 1


# -- chaos harness -----------------------------------------------------------

def test_chaos_knob_parsing(monkeypatch):
    assert not chaos.active()
    raw = "nan_at=3, kv_delay_ms=50,kill_at=5:1,flag"
    monkeypatch.setenv("AUTODIST_CHAOS", raw)
    assert chaos.knobs() == jchaos.knobs() == {
        "nan_at": "3", "kv_delay_ms": "50", "kill_at": "5:1", "flag": "1"}
    assert chaos.active()


def test_chaos_kv_delay_sleeps_and_records(monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS", "kv_delay_ms=20")
    t0 = time.monotonic()
    chaos.maybe_delay_kv_fetch()
    assert time.monotonic() - t0 >= 0.02
    assert any(k == "chaos:kv-delay" for _, k, _ in resilience.events())


@pytest.mark.parametrize("container", ["numpy", "torch"])
def test_chaos_nan_poisons_only_float_leaves(monkeypatch, container):
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=1")
    ints = np.arange(4, dtype=np.int32)
    floats = np.ones((4,), np.float32)
    if container == "torch":
        ints, floats = torch.from_numpy(ints), torch.from_numpy(floats)
    out_f, out_i = chaos.maybe_poison_batch(1, (floats, ints))
    assert np.isnan(np.asarray(out_f)).all()
    np.testing.assert_array_equal(np.asarray(out_i), np.asarray(ints))
    assert np.isfinite(np.asarray(floats)).all()  # the input is not written
    # one-shot: a rolled-back loop re-reaching step 1 is not re-poisoned
    again_f, _ = chaos.maybe_poison_batch(1, (floats, ints))
    assert np.isfinite(np.asarray(again_f)).all()
    assert chaos.maybe_poison_batch(2, floats) is floats


def test_chaos_oom_fires_once(monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS", "oom_at=2")
    chaos.maybe_oom(1)
    with pytest.raises(RuntimeError, match="out of memory"):
        chaos.maybe_oom(2)
    chaos.maybe_oom(2)  # once per process
    assert [k for _, k, _ in resilience.events()] == ["chaos:oom"]


def test_runner_run_injects_oom(monkeypatch):
    """``Runner.run`` calls the OOM hook before each dispatch (as the JAX
    Runner's observed loop does); the state is not advanced."""
    monkeypatch.setenv("AUTODIST_CHAOS", "oom_at=2")
    runner, batch = _port(AllReduce())
    state = runner.create_state()
    with pytest.raises(RuntimeError, match="chaos oom_at=2"):
        runner.run(state, _batches(batch), 3)


class _FlakyStore:
    """A c10d store whose first wait raises ``first``; it holds the
    chief's proto and id."""

    def __init__(self, first, strategy):
        self.first, self.waits = first, 0
        self.blob = strategy.proto.SerializeToString()
        self.id = strategy.id.encode()

    def wait(self, keys, timeout):
        self.waits += 1
        if self.waits == 1:
            raise self.first

    def get(self, key):
        return self.id if key.endswith("/id") else self.blob


def _fetch_through(monkeypatch, first):
    """A worker's ``AutoDist._ship_or_fetch_strategy`` against a store
    whose first wait raises ``first`` (three attempts, no backoff);
    returns (the fetched strategy, the chief's, the store)."""
    import torch.distributed as dist
    from autodist_tpu_torch.resilience import retry
    runner, _ = _port()
    store = _FlakyStore(first, runner.program.strategy)
    monkeypatch.setattr(dist.distributed_c10d, "_get_default_store",
                        lambda: store)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(retry, "default_policy", lambda: RetryPolicy(
        max_attempts=3, base_delay=0.0, jitter=0.0))
    ad = autodist_mod._default_autodist
    return (ad._ship_or_fetch_strategy(runner.program.graph_item),
            runner.program.strategy, store)


def test_strategy_fetch_retries_a_store_flake_and_honours_kv_delay(
        monkeypatch):
    """A worker's strategy fetch (``AutoDist._ship_or_fetch_strategy``)
    goes through ``retry_call``: a store wait that loses its connection
    once is retried and the chief's proto is used; ``kv_delay_ms`` delays
    the fetch and records its event."""
    import torch.distributed as dist
    monkeypatch.setenv("AUTODIST_CHAOS", "kv_delay_ms=5")
    got, want, store = _fetch_through(
        monkeypatch, dist.DistNetworkError("Connection reset by peer"))
    assert got.id == want.id and store.waits == 2
    kinds = [k for _, k, _ in resilience.events()]
    assert kinds == ["chaos:kv-delay", "retry"]


def test_strategy_fetch_does_not_retry_its_own_timeout(monkeypatch):
    """A wait that runs out ``AUTODIST_STRATEGY_SHIP_TIMEOUT_MS`` is the
    answer (nothing was shipped for this program), not a flake: it raises
    at once, so the timeout bounds the whole wait."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="no strategy was shipped") as e:
        _fetch_through(monkeypatch, dist.DistStoreError(
            "wait timeout after 5ms, keys: /k"))
    assert isinstance(e.value.__cause__, dist.DistStoreError)
    assert [k for _, k, _ in resilience.events()] == []


def test_events_are_recorded_with_timestamps():
    resilience.record_event("retry", "x")
    (t, kind, detail), = resilience.events()
    assert kind == "retry" and detail == "x"
    assert abs(t - time.time()) < 60
