"""StepGuard: NaN/Inf divergence detection with rollback.

Counterpart of ``autodist_tpu/resilience/guard.py``. A NaN loss on one
rank poisons every rank's state within a step (the gradient reduction
spreads it), and the periodic checkpointer would then persist it. The
guard closes both holes:

* the Runner's step computes a **device-side** ``notfinite`` flag (a 0-dim
  tensor; no host sync), and the guard reads it only every
  ``check_every`` steps, and always right before a checkpoint save, so no
  poisoned state is ever persisted;
* on divergence it **rolls back** to the last good state (the bound
  CheckpointManager's latest step, or its own device snapshot when the
  loop runs without checkpoints), skips ahead in the data stream (the
  presumed-bad batches are consumed and not replayed), and counts a
  strike;
* ``max_strikes`` consecutive rollbacks without progress raise
  :class:`DivergenceAbort`: persistent divergence is a bug, not a blip.

A step updates its state's tensors in place, and a CUDA graph step is
bound to them, so a rollback copies the good values back into those same
tensors (``copy_``, outside any capture) instead of handing back new ones.
The snapshot is a second resident copy of the params, the sync state
(so a rollback restores the compressors' residuals too: a poisoned one
would re-inject the NaN at the next reduce) and the optimizer state (for
BERT-base with Adam about 1.3 GB on the device).
"""
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import leaves


class DivergenceAbort(RuntimeError):
    """Raised when rollback+retry exhausted ``max_strikes``."""


def _written(state):
    """(tensors, {update tensor: its optimizer state dict or None}): every
    tensor a step writes in place, the params, the sync state (error-
    feedback residuals, PowerSGD factors) and the optimizer's own tensors
    (``zero1`` shards) first, then their optimizer state."""
    opt = state.opt_state
    tensors = list(leaves(state.params)) + list(leaves(state.sync_state))
    seen = {id(t) for t in tensors}
    update = [p for g in opt.param_groups for p in g["params"]]
    tensors += [p for p in update if id(p) not in seen]
    return tensors, [(p, opt.state.get(p) or None) for p in update]


class _Snapshot:
    """A device copy of a state's tensors, bound to the live ones it was
    taken from: refreshed in place while they are the same tensors."""

    def __init__(self, step, state):
        self.step = step
        self.count = int(state.step)
        self.params, self.opt = state.params, state.opt_state
        self.sync = state.sync_state
        tensors, states = _written(state)
        self.tensors = [(t, t.detach().clone()) for t in tensors]
        self.states = [(p, None if st is None else
                        [(k, v, v.detach().clone()) for k, v in st.items()])
                       for p, st in states]

    def refresh(self, step, state):
        """Copy ``state`` in if it is the state this snapshot was taken of
        (the same tensors); False otherwise."""
        tensors, states = _written(state)
        if state.opt_state is not self.opt or \
                [id(t) for t in tensors] != [id(t) for t, _ in self.tensors]:
            return False
        for (p, st), (q, entries) in zip(states, self.states):
            if p is not q or (st is None) != (entries is None) or (
                    st is not None and (len(st) != len(entries) or any(
                        st.get(k) is not v for k, v, _ in entries))):
                return False
        with torch.no_grad():  # one multi-tensor copy, not one per tensor
            torch._foreach_copy_(self._copies(), self._lives())
        self.step, self.count = step, int(state.step)
        return True

    def _lives(self):
        return [t for t, _ in self.tensors] + [
            v for _, entries in self.states for _, v, _ in entries or ()]

    def _copies(self):
        return [c for _, c in self.tensors] + [
            c for _, entries in self.states for _, _, c in entries or ()]

    def restore(self):
        """Copy the snapshot back into the live tensors; returns the
        state. A parameter whose optimizer state did not exist at snapshot
        time has its state dropped (and the graph steps bound to the state
        capture anew), one whose state tensors were replaced since gets
        copies."""
        from autodist_tpu_torch.runner import TrainState, _bump_generation
        opt = self.opt
        replaced = False
        for p, entries in self.states:
            live = opt.state.get(p)
            if entries is None:
                replaced |= bool(opt.state.pop(p, None))
            elif live is None or len(live) != len(entries) or \
                    any(live.get(k) is not v for k, v, _ in entries):
                opt.state[p] = {k: copy.clone() for k, _, copy in entries}
                replaced = True
        with torch.no_grad():
            torch._foreach_copy_(self._lives(), self._copies())
        if replaced:
            _bump_generation(opt)
        return TrainState(torch.tensor(self.count, dtype=torch.int64),
                          self.params, opt, self.sync)


class StepGuard:
    """Policy + state for the guarded step loop.

    Args:
        check_every: host-check cadence in steps (typed ENV default
            ``AUTODIST_GUARD_CHECK_EVERY``). The device flag exists every
            step; only the host *read* is amortized. NaN propagates
            through the params, so a divergence between checks is still
            caught at the next one. Under ``Runner.run(unroll=K)`` the
            effective cadence rounds UP to a multiple of K (checks happen
            at megastep boundaries) and a rollback restores the
            megastep-ENTRY snapshot: the whole offending K-block is
            skipped.
        max_strikes: consecutive rollbacks tolerated before
            :class:`DivergenceAbort` (ENV ``AUTODIST_GUARD_MAX_STRIKES``).
        on_rollback: optional callback ``(step, strikes) -> None``, the
            re-seeding hook (shuffle the data pipeline, bump an rng epoch)
            invoked after state is restored.
    """

    def __init__(self, check_every=None, max_strikes=None, on_rollback=None):
        if check_every is None:
            check_every = const.ENV.AUTODIST_GUARD_CHECK_EVERY.val
        if max_strikes is None:
            max_strikes = const.ENV.AUTODIST_GUARD_MAX_STRIKES.val
        self.check_every = max(1, int(check_every))
        self.max_strikes = max(1, int(max_strikes))
        self.on_rollback = on_rollback
        self.strikes = 0
        self.rollbacks = 0          # lifetime count (reporting)
        self._snapshot = None       # _Snapshot when no manager is bound

    # -- detection -----------------------------------------------------------

    def due(self, step, unroll=1):
        """Whether the host-side flag check is due at ``step`` (1-based).
        Under ``unroll=K`` the cadence rounds up to a multiple of K."""
        return step % (-(-self.check_every // unroll) * unroll) == 0

    @staticmethod
    def diverged(metrics):
        """Host-read the device-side flag (one scalar transfer). Under
        ``Runner.run(unroll=K)`` the flag arrives aggregated over the K
        steps (``any`` on the device); a stacked per-step flag is also
        accepted."""
        flag = (metrics or {}).get("notfinite")
        if flag is None:
            return False
        return bool(torch.as_tensor(flag).any())

    # -- last-good state tracking --------------------------------------------

    def mark_good(self, step, state):
        """Record a healthy state as the in-memory rollback target: a
        device copy of its params and optimizer state, refreshed in place
        when it is the same state's tensors again (used by ``Runner.run``;
        ``CheckpointManager.run`` rolls back to its checkpoints)."""
        if self._snapshot is None or not self._snapshot.refresh(step, state):
            self._snapshot = None  # free the old copy before the new one
            self._snapshot = _Snapshot(step, state)
        self.strikes = 0

    def progressed(self):
        """A healthy check after a rollback clears the strike counter."""
        self.strikes = 0

    # -- recovery ------------------------------------------------------------

    def rollback(self, step, manager=None, state=None):
        """Restore the last good state; returns ``(good_step, state)``.

        With ``manager`` the state comes from its newest intact checkpoint
        (``restore_or_init(into=state)``: copied into the live ``state``'s
        tensors when it is given); else the snapshot is copied back into
        the tensors it was taken of. Raises :class:`DivergenceAbort` once
        ``max_strikes`` consecutive rollbacks have not produced a healthy
        check."""
        from autodist_tpu_torch import resilience
        self.strikes += 1
        self.rollbacks += 1
        if self.strikes > self.max_strikes:
            resilience.record_event(
                "divergence-abort",
                f"step {step}: {self.strikes - 1} consecutive rollbacks "
                f"exhausted max_strikes={self.max_strikes}")
            raise DivergenceAbort(
                f"autodist_tpu_torch: loss diverged at step {step} and "
                f"{self.strikes - 1} rollbacks did not recover "
                f"(max_strikes={self.max_strikes}); aborting. Check the "
                f"learning rate / data pipeline.")
        if manager is not None:
            state = manager.restore_or_init(into=state)
            # The restored state says which step actually survived:
            # restore_or_init may have fallen back past latest_step()
            # (corrupt newest step) or to fresh init (step 0).
            good = int(state.step)
        elif self._snapshot is not None:
            good = self._snapshot.step
            state = self._snapshot.restore()
        else:
            raise DivergenceAbort(
                "autodist_tpu_torch: loss diverged and no rollback target "
                "exists (no CheckpointManager bound and no snapshot marked)")
        resilience.record_event(
            "rollback", f"divergence at step {step}: restored step {good} "
                        f"(strike {self.strikes}/{self.max_strikes})")
        logging.warning("step guard: non-finite loss at step %d — rolled "
                        "back to step %d (strike %d/%d)", step, good,
                        self.strikes, self.max_strikes)
        if self.on_rollback is not None:
            self.on_rollback(good, self.strikes)
        return good, state
