"""Worker-death supervision policies for the Coordinator.

Counterpart of ``autodist_tpu/resilience/supervision.py``: four policies,
selected by ``AUTODIST_SUPERVISION``:

* ``abort``               — tear the job down hard (the default);
* ``restart-worker``      — local launch only: respawn the dead worker's
  process with the same env contract, up to
  ``AUTODIST_MAX_WORKER_RESTARTS`` times per worker, then abort;
* ``checkpoint-and-exit`` — note the death and let the chief's step loop
  observe it (``Coordinator.failed``) and exit through the emergency
  checkpoint path with a nonzero code;
* ``elastic``             — shrink the world by one: re-form the job at
  N-1 (``Coordinator.reform_now`` re-execs the user script with the shrunk
  env contract), which resumes from the checkpoint manifest with a
  reshard. Never below ``AUTODIST_ELASTIC_MIN_WORLD`` (then abort). The
  run id survives the re-exec and each generation persists a goodput
  segment, so the stitched run ledger prices the dead time as the
  ``reexec_gap`` class.

Policies key their bookkeeping by the *logical worker index* (the launch
contract's process id), never the OS pid: a respawned worker gets a fresh
pid every incarnation, and a pid key would let a crash-looping worker
evade the restart budget forever.
"""
import os

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging


def _record(kind, detail):
    from autodist_tpu_torch import resilience
    resilience.record_event(kind, detail)


class ElasticReform(RuntimeError):
    """Raised by the chief's step loop when an elastic re-form hands off
    (only observable when the Coordinator's exec hook is stubbed: a real
    re-form replaces the process image and never returns)."""

    def __init__(self, new_world, step):
        super().__init__(
            f"autodist_tpu_torch: elastic re-form to world size {new_world} "
            f"at step {step}")
        self.new_world = new_world
        self.step = step


class AbortPolicy:
    """Any worker death aborts the whole job."""

    name = "abort"

    def on_worker_death(self, coordinator, worker_index, proc, code):
        _record("worker-death",
                f"worker {worker_index} exited {code}; aborting job")
        logging.error("worker %d exited with code %d; aborting job",
                      worker_index, code)
        coordinator.terminate()
        os._exit(1)


class RestartPolicy:
    """Respawn a dead local worker up to ``max_restarts`` times, then
    escalate to :class:`AbortPolicy`. ``restarts`` is keyed by the logical
    worker index, so every incarnation of a slot shares one budget."""

    name = "restart-worker"

    def __init__(self, max_restarts=None):
        if max_restarts is None:
            max_restarts = const.ENV.AUTODIST_MAX_WORKER_RESTARTS.val
        self.max_restarts = max(0, int(max_restarts))
        self.restarts = {}  # logical worker index -> count across incarnations
        self._escalate = AbortPolicy()

    def on_worker_death(self, coordinator, worker_index, proc, code):
        used = self.restarts.get(worker_index, 0)
        if used >= self.max_restarts:
            _record("worker-death",
                    f"worker {worker_index} exited {code} after {used} "
                    f"restarts; escalating to abort")
            self._escalate.on_worker_death(coordinator, worker_index, proc,
                                           code)
            return
        self.restarts[worker_index] = used + 1
        _record("worker-restart",
                f"worker {worker_index} exited {code}; restart "
                f"{used + 1}/{self.max_restarts}")
        logging.warning("worker %d exited with code %d; restarting "
                        "(%d/%d)", worker_index, code, used + 1,
                        self.max_restarts)
        if coordinator.respawn_worker(worker_index) is None:
            # Not respawnable (SSH-launched or unknown worker).
            self._escalate.on_worker_death(coordinator, worker_index, proc,
                                           code)


class CheckpointAndExitPolicy:
    """Record the death and let the chief's step loop drain to a final
    checkpoint: ``Coordinator.failed`` flips, the loop sees it and exits
    through the emergency-save path."""

    name = "checkpoint-and-exit"

    def on_worker_death(self, coordinator, worker_index, proc, code):
        _record("worker-death",
                f"worker {worker_index} exited {code}; chief will "
                f"checkpoint and exit")
        logging.error("worker %d exited with code %d; chief checkpoints "
                      "and exits", worker_index, code)
        coordinator.terminate()


class ElasticPolicy:
    """Survive a worker death by shrinking the fleet: request a re-form at
    world size N-1 instead of aborting.

    A one-process world (a single-controller simulation) defers to the
    chief's step loop, which drains through an emergency checkpoint and
    then re-forms (``CheckpointManager.run`` polls the coordinator). A
    world of several processes re-forms from the supervision thread: with
    a participant dead, the chief's next collective can fail or hang, so
    the step loop cannot be trusted to reach its own drain; a loop that
    does take the hand-off within ``coordinator.HANDOFF_WAIT_S`` re-forms
    itself (``Coordinator.reform_soon``). The relaunch resumes from the
    last retained periodic checkpoint. Below ``min_world``, escalates to
    abort."""

    name = "elastic"

    def __init__(self, min_world=None):
        if min_world is None:
            min_world = const.ENV.AUTODIST_ELASTIC_MIN_WORLD.val
        self.min_world = max(1, int(min_world))
        self._escalate = AbortPolicy()

    def on_worker_death(self, coordinator, worker_index, proc, code):
        world = coordinator.world_size
        target = world - 1
        if target < self.min_world:
            _record("worker-death",
                    f"worker {worker_index} exited {code}; world {world} "
                    f"cannot shrink below AUTODIST_ELASTIC_MIN_WORLD="
                    f"{self.min_world}; escalating to abort")
            self._escalate.on_worker_death(coordinator, worker_index, proc,
                                           code)
            return
        _record("worker-death",
                f"worker {worker_index} exited {code}; elastic shrink "
                f"{world} -> {target}")
        logging.warning("worker %d exited with code %d; elastic shrink "
                        "%d -> %d", worker_index, code, world, target)
        coordinator.request_reform(
            target, reason=f"worker {worker_index} died (exit {code})")
        from autodist_tpu_torch.observability.tracing import process_count
        if process_count() > 1:
            # The chief may be stuck in a collective with the dead
            # participant; re-form from this thread unless its step loop
            # takes the hand-off at once (Coordinator.reform_soon).
            coordinator.reform_soon()


_POLICIES = {
    AbortPolicy.name: AbortPolicy,
    RestartPolicy.name: RestartPolicy,
    CheckpointAndExitPolicy.name: CheckpointAndExitPolicy,
    ElasticPolicy.name: ElasticPolicy,
}


def supervision_policy(name=None):
    """Build the configured policy (``AUTODIST_SUPERVISION``; an unknown
    name warns and falls back to abort)."""
    name = name or const.ENV.AUTODIST_SUPERVISION.val or AbortPolicy.name
    cls = _POLICIES.get(name)
    if cls is None:
        logging.warning("unknown AUTODIST_SUPERVISION=%r; using abort", name)
        cls = AbortPolicy
    return cls()
