"""Chaos under the compressed wires, after ``tests/test_chaos_compressed.py``:
the ``AUTODIST_CHAOS`` fault matrix with the bf16, int8 + EF and PowerSGD
compressors and the hierarchical int8 + EF wire. ``TrainState.sync_state``
(the EF residuals, PowerSGD's ``q`` and residual, the DCN-shard residual)
must survive what the params survive:

* a NaN rollback from the guard's snapshot restores the sync state (the
  poisoned residual is not re-injected): finite params and residuals, and
  a snapshot's sync state copied back exactly;
* a checkpointed rollback never persists a poisoned residual: every
  retained step's params and ``sync_state`` are finite;
* a truncated checkpoint falls back to the previous step and training
  resumes through the compressed wire;
* a checkpoint restores across sync paths (a PS checkpoint under an EF
  runner, and the reverse), and a restore on another world size or leg
  split reinitializes the sync state and records it (a
  ``checkpoint-restore`` event saying so).

The one-rank cases run in this process (a one-rank gloo world: the
compressors quantize and keep residuals there too); the hierarchical ones
on a 4-rank gloo world split 2 hosts x 2 (``AUTODIST_HIER_ICI=2``), one
module fixture for all of them. The JAX package's
``test_hier_reshard_reinitializes_leg_split_sync_state`` fails on its own
tree (its orbax restore of the resharded checkpoint), so the port's
reshard case is held to that test's stated contract alone (params
value-exact, the sync state reinitialized at the new split's shape and
finite, training continuing), not to a JAX run.
"""
import fcntl
import functools
import pickle

import numpy as np
import pytest
import torch

from autodist_tpu_torch import AutoDist, resilience
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.checkpoint.saver import read_tree
from autodist_tpu_torch.models import mlp
from autodist_tpu_torch.resilience import StepGuard, chaos
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                           path_to_name)

COMPRESSORS = ["HorovodCompressor", "Int8CompressorEF", "PowerSGDCompressor"]
WORLD = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.delenv("AUTODIST_CHAOS", raising=False)
    monkeypatch.setenv("AUTODIST_TELEMETRY", "0")
    monkeypatch.setenv("AUTODIST_WORKING_DIR", str(tmp_path / "wd"))
    autodist_mod._reset_default()
    resilience.clear_events()
    chaos.reset()
    yield
    autodist_mod._reset_default()
    resilience.clear_events()
    chaos.reset()


def _build(builder):
    params, loss_fn, batch = mlp.tiny_fixture(device="cpu")
    ad = AutoDist(strategy_builder=builder, device="cpu")
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.Adam, lr=1e-3),
                      example_batch=batch)
    runner = ad.create_distributed_session(item)
    return runner, batch


def _batches(batch):
    return iter(lambda: batch, None)


def _named(tree):
    return {path_to_name(p): t.detach().clone()
            for p, t in flatten_with_path(tree)[0]}


def _reinit_recorded(events):
    return any(k == "checkpoint-restore" and "reinitialized" in d
               for _, k, d in events)


def _finite(tree, what):
    for t in leaves(tree):
        assert torch.isfinite(torch.as_tensor(t)).all(), what


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_nan_rollback_recovers_through_compressed_wire(compressor,
                                                       monkeypatch):
    runner, batch = _build(AllReduce(compressor=compressor))
    assert runner.program.use_explicit_path
    guard = StepGuard(check_every=1, max_strikes=2)
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=2")
    state = runner.create_state()
    # The bf16 wire is stateless; the EF and PowerSGD wires keep state.
    assert bool(state.sync_state) == (compressor != "HorovodCompressor")
    state, metrics = runner.run(state, _batches(batch), num_steps=4,
                                step_guard=guard)
    assert guard.rollbacks == 1
    assert torch.isfinite(metrics["loss"]).all()
    _finite(runner.logical_params(state), "params after rollback")
    _finite(state.sync_state, f"{compressor} sync_state")
    kinds = {k for _, k, _ in resilience.events()}
    assert "chaos:nan" in kinds and "rollback" in kinds


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_snapshot_restores_the_sync_state_exactly(compressor):
    """The guard's snapshot holds the sync state: a poisoned residual
    copied back to the snapshot's values, in the state's own tensors."""
    runner, batch = _build(AllReduce(compressor=compressor))
    state = runner.create_state()
    for _ in range(2):
        state, _ = runner.step(state, batch)
    guard = StepGuard(check_every=1)
    guard.mark_good(2, state)
    want = [t.clone() for t in leaves(state.sync_state)]
    live = leaves(state.sync_state)
    assert any(t.abs().sum() > 0 for t in want) or \
        compressor == "HorovodCompressor"
    with torch.no_grad():
        for t in live:
            t.fill_(float("nan"))
    good, back = guard.rollback(3)
    assert good == 2
    got = leaves(back.sync_state)
    assert all(a is b for a, b in zip(got, live))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_checkpointed_rollback_never_persists_poisoned_state(
        compressor, tmp_path, monkeypatch):
    runner, batch = _build(AllReduce(compressor=compressor))
    mgr = CheckpointManager(runner, tmp_path / "ckpt",
                            save_interval_steps=1, max_to_keep=3)
    guard = StepGuard(check_every=1, max_strikes=3)
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_at=3")
    state = mgr.restore_or_init()
    state, metrics = mgr.run(state, _batches(batch), num_steps=6,
                             step_guard=guard)
    assert guard.rollbacks == 1
    assert int(state.step) == 6
    assert torch.isfinite(metrics["loss"]).all()
    mgr.wait_until_finished()
    for step in mgr.all_steps():
        raw = read_tree(tmp_path / "ckpt" / str(step))
        assert ("sync_state" in raw) == (compressor != "HorovodCompressor")
        raw.setdefault("sync_state", {})
        for key in ("params", "sync_state"):
            _finite(raw[key], f"step {step} {key} ({compressor})")
    mgr.close()


def test_truncated_checkpoint_falls_back_and_resumes_compressed(tmp_path):
    runner, batch = _build(AllReduce(compressor="Int8CompressorEF"))
    mgr = CheckpointManager(runner, tmp_path / "ckpt",
                            save_interval_steps=1, max_to_keep=3)
    state = mgr.restore_or_init()
    state, _ = mgr.run(state, _batches(batch), num_steps=3)
    mgr.wait_until_finished()
    saved = {k: v.clone() for k, v in state.sync_state.items()}
    corrupted = chaos.truncate_checkpoint(tmp_path / "ckpt")
    assert corrupted == 3
    restored = mgr.restore_or_init(into=state)
    assert int(restored.step) < 3
    # The previous step's residuals, not the live (step 3) ones.
    assert any(not torch.equal(restored.sync_state[k], v)
               for k, v in saved.items())
    restored, metrics = mgr.run(restored, _batches(batch), num_steps=4)
    assert torch.isfinite(metrics["loss"]).all()
    assert int(restored.step) == 4
    kinds = {k for _, k, _ in resilience.events()}
    assert "chaos:ckpt-truncate" in kinds
    assert not _reinit_recorded(resilience.events())
    mgr.close()


def test_checkpoints_restore_across_sync_paths(tmp_path):
    """A PS (no sync state) checkpoint restores under an int8 + EF runner
    (its residuals reinitialized, recorded), and the EF checkpoint under a
    PS runner (its sync state ignored): params value-exact both ways."""
    ps, batch = _build(PS())
    mgr = CheckpointManager(ps, tmp_path / "ps", save_interval_steps=1)
    state = mgr.restore_or_init()
    state, _ = ps.step(state, batch)
    mgr.save(1, state, force=True)
    mgr.wait_until_finished()
    want = _named(ps.logical_params(state))
    assert "sync_state" not in read_tree(tmp_path / "ps" / "1")
    mgr.close()
    autodist_mod._reset_default()

    ef, batch = _build(AllReduce(compressor="Int8CompressorEF"))
    mgr = CheckpointManager(ef, tmp_path / "ps")
    state = mgr.restore_or_init()
    for k, v in _named(ef.logical_params(state)).items():
        assert torch.equal(v, want[k]), k
    assert all(not t.any() for t in leaves(state.sync_state))
    assert _reinit_recorded(resilience.events())
    state, _ = ef.step(state, batch)
    emgr = CheckpointManager(ef, tmp_path / "ef", save_interval_steps=1)
    emgr.save(2, state, force=True)
    emgr.wait_until_finished()
    want = _named(ef.logical_params(state))
    assert "sync_state" in read_tree(tmp_path / "ef" / "2")
    mgr.close()
    emgr.close()
    autodist_mod._reset_default()

    ps, batch = _build(PS())
    mgr = CheckpointManager(ps, tmp_path / "ef")
    state = mgr.restore_or_init()
    assert state.sync_state == {}
    for k, v in _named(ps.logical_params(state)).items():
        assert torch.equal(v, want[k]), k
    mgr.close()


# -- the hierarchical wire on a 4-rank world ------------------------------------

_RANK = r'''
import datetime, functools, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist, resilience
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.checkpoint.saver import read_tree
from autodist_tpu_torch.models import mlp
from autodist_tpu_torch.resilience import StepGuard, chaos
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.utils.tree import (flatten_with_path, leaves,
                                           path_to_name)

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["AUTODIST_TELEMETRY"] = "0"
os.environ["AUTODIST_WORKING_DIR"] = os.path.join(out, f"wd{rank}")
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
res = {}


def build():
    autodist_mod._reset_default()
    params, loss_fn, batch = mlp.tiny_fixture(device="cpu")
    ad = AutoDist(strategy_builder=AllReduce(all_reduce_spec="DCN",
                                             compressor="Int8CompressorEF"),
                  device="cpu")
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.Adam, lr=1e-3),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def named(tree):
    return {path_to_name(p): t.detach().numpy().copy()
            for p, t in flatten_with_path(tree)[0]}


def finite(tree):
    return all(bool(torch.isfinite(torch.as_tensor(t)).all())
               for t in leaves(tree))


def batches(batch):
    return iter(lambda: batch, None)


os.environ["AUTODIST_HIER_ICI"] = "2"
# (1) the guard's rollback under the hierarchical EF wire.
runner, batch = build()
state = runner.create_state()
res["shapes"] = {k: tuple(v.shape) for k, v in state.sync_state.items()}
os.environ["AUTODIST_CHAOS"] = "nan_at=2"
chaos.reset()
guard = StepGuard(check_every=1, max_strikes=2)
state, m = runner.run(state, batches(batch), num_steps=4, step_guard=guard)
res["rollback"] = {"rollbacks": guard.rollbacks,
                   "loss": float(m["loss"]),
                   "params": finite(runner.logical_params(state)),
                   "sync": finite(state.sync_state),
                   "kinds": sorted({k for _, k, _ in resilience.events()})}
# (2) the checkpointed rollback.
resilience.clear_events()
chaos.reset()
os.environ["AUTODIST_CHAOS"] = "nan_at=3"
ckpt = os.path.join(out, "ckpt")
mgr = CheckpointManager(runner, ckpt, save_interval_steps=1, max_to_keep=3)
state = mgr.restore_or_init()
guard = StepGuard(check_every=1, max_strikes=3)
state, m = mgr.run(state, batches(batch), num_steps=6, step_guard=guard)
mgr.wait_until_finished()
os.environ.pop("AUTODIST_CHAOS")
retained = {}
for step in mgr.all_steps():
    raw = read_tree(os.path.join(ckpt, str(step)))
    retained[step] = {"params": finite(raw["params"]),
                      "sync": finite(raw["sync_state"]),
                      "shape": tuple(leaves(raw["sync_state"])[0].shape)}
res["ckpt"] = {"rollbacks": guard.rollbacks, "step": int(state.step),
               "loss": float(m["loss"]), "retained": retained}
res["expect"] = named(runner.logical_params(state))
mgr.close()
# (3) another leg split on the same world: d = 1 x h = 4.
resilience.clear_events()
os.environ["AUTODIST_HIER_ICI"] = "1"
runner, batch = build()
mgr = CheckpointManager(runner, ckpt)
state = mgr.restore_or_init()
res["resplit"] = {
    "step": int(state.step),
    "params": named(runner.logical_params(state)),
    "shapes": {k: tuple(v.shape) for k, v in state.sync_state.items()},
    "zero": {k: not t.any() for k, t in state.sync_state.items()},
    "kinds": sorted({k for _, k, _ in resilience.events()}),
    "reinit": any(k == "checkpoint-restore" and "reinitialized" in d
                  for _, k, d in resilience.events())}
state, m = runner.step(state, batch)
res["resplit"]["loss"] = float(m["loss"])
res["resplit"]["sync"] = finite(state.sync_state)
mgr.close()
dist.barrier()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The hierarchical cases, run once per test session on a 4-rank gloo
    world (the first xdist worker to need it runs it under a file lock):
    ``(per-rank results, the checkpoint directory)``."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "chaos_hier_world"
    with open(shared / "chaos_hier_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            outs, err = _run_world(_RANK, WORLD, [str(out)], str(out))
            (out / "error").write_text(err if outs is None else "")
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    per_rank = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    return per_rank, out / "ckpt"


def test_hier_nan_rollback_restores_per_leg_ef_state(world):
    """The DCN-shard residual (a 256-multiple shard a rank, not the whole
    gradient) comes back finite from the guard's rollback."""
    for res in world[0]:
        assert all(len(s) == 1 and s[0] % 256 == 0
                   for s in res["shapes"].values())
        r = res["rollback"]
        assert r["rollbacks"] == 1 and np.isfinite(r["loss"])
        assert r["params"] and r["sync"]
        assert "chaos:nan" in r["kinds"] and "rollback" in r["kinds"]


def test_hier_checkpointed_rollback_never_persists_dcn_residuals(world):
    for res in world[0]:
        c = res["ckpt"]
        assert c["rollbacks"] == 1 and c["step"] == 6
        assert np.isfinite(c["loss"])
        assert c["retained"]
        for step, r in c["retained"].items():
            assert r["params"] and r["sync"], step
            assert r["shape"][0] == WORLD  # every rank's residual stacked


def test_hier_resplit_reinitializes_leg_split_sync_state(world):
    """Another leg split on the same world (d 2 -> 1): the params restore
    value-exact, each residual whose shard shape changed reinitializes at
    the new shape (one whose padded shard happens to keep its shape is
    restored, as the JAX package's shape check does), the reinit is
    recorded, and training continues."""
    for res in world[0]:
        r = res["resplit"]
        assert r["step"] == 6
        for k, v in res["expect"].items():
            np.testing.assert_array_equal(r["params"][k], v)
        changed = [k for k in r["shapes"] if r["shapes"][k] != res["shapes"][k]]
        assert changed
        assert all(r["zero"][k] for k in changed)
        assert r["sync"] and np.isfinite(r["loss"])
        assert r["reinit"]


def test_restore_on_another_world_size_reinitializes(world, tmp_path):
    """The 4-rank hierarchical checkpoint restored on this one-rank world
    (the legs degenerate: a whole-gradient residual): params value-exact
    to the 4 ranks', the sync state reinitialized (recorded) and finite,
    and a step trains on."""
    per_rank, ckpt = world
    import shutil
    shutil.copytree(ckpt, tmp_path / "ckpt")
    runner, batch = _build(AllReduce(all_reduce_spec="DCN",
                                     compressor="Int8CompressorEF"))
    mgr = CheckpointManager(runner, tmp_path / "ckpt")
    state = mgr.restore_or_init()
    assert int(state.step) == 6
    for k, v in _named(runner.logical_params(state)).items():
        np.testing.assert_array_equal(v.numpy(), per_rank[0]["expect"][k])
    assert all(not t.any() for t in leaves(state.sync_state))
    kinds = {k for _, k, _ in resilience.events()}
    assert _reinit_recorded(resilience.events()) and "reshard" in kinds
    state, metrics = runner.step(state, batch)
    assert torch.isfinite(metrics["loss"]).all()
    _finite(state.sync_state, "reinitialized sync state")
    mgr.close()
