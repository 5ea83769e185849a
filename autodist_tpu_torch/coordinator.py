"""Coordinator: multi-process launch and supervision.

Counterpart of ``autodist_tpu/coordinator.py``. The chief re-runs the
*same user script* once per extra process with the env launch contract
(``AUTODIST_WORKER`` / ``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES``
/ ``AUTODIST_COORDINATOR``), on this machine (``launch: local``) or on the
spec's nodes over SSH (``launch: ssh``, :class:`~autodist_tpu_torch.ssh.
SSHLauncher`), and supervises each worker under a death policy
(``resilience/supervision.py``, ``AUTODIST_SUPERVISION``). Every process
then joins one ``torch.distributed`` world whose c10d TCP store the chief
hosts at ``AUTODIST_COORDINATOR`` (``Cluster.start``), and the workers take
the chief's strategy over that store (``AutoDist._ship_or_fetch_strategy``).

Elastic re-form: :meth:`Coordinator.reform_now` terminates the workers and
replaces this process (``os.execve``) with the same script under the
shrunk or grown contract, the run id and the next generation index; the
new generation reshard-restores from the checkpoint manifest.
"""
import os
import subprocess
import sys
import threading
import time

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.observability.tracing import process_count
from autodist_tpu_torch.utils import logging


# How long the supervision thread leaves a re-form to an attached step loop
# (``CheckpointManager.run(coordinator=...)``) before running it itself.
HANDOFF_WAIT_S = 10.0


class Coordinator:

    def __init__(self, strategy, cluster, supervision=None):
        from autodist_tpu_torch.resilience import supervision_policy
        self._strategy = strategy
        self._cluster = cluster
        self._procs = []
        self._failed = threading.Event()
        self._supervision = supervision or supervision_policy()
        # logical worker index -> (address, env) of every locally launched
        # worker, so a restart policy respawns with the same contract.
        self._worker_launch = {}
        # Set by terminate(): the watchers then take the SIGTERMs sent as
        # no death (a restart policy would respawn at shutdown).
        self._closing = False
        # Elastic re-form: a pending target world size set by
        # request_reform, consumed exactly once by reform_now.
        self._reform = None
        self._reform_reason = ""
        self._reform_done = False
        # reform_now runs once; a second caller (the step loop while the
        # supervision thread re-execs) waits here for the exec.
        self._reform_lock = threading.Lock()
        self._world_size = None
        # A strategy artifact id the NEXT generation loads instead of
        # building (set by a reshape decision).
        self._pinned_strategy_id = None
        self._loops = 0  # step loops polling this coordinator
        self._exec = os.execve  # injectable: tests stub the re-exec

    @property
    def failed(self):
        """Whether supervision observed a worker death this job (polled by
        the checkpointed step loop)."""
        return self._failed.is_set()

    @property
    def supervision(self):
        return self._supervision

    # -- elastic re-form -----------------------------------------------------

    @property
    def world_size(self):
        """The job's (target) world size: a pending re-form's target, else
        the resource spec's process count, else chief + children."""
        if self._reform is not None:
            return self._reform
        if self._world_size is not None:
            return self._world_size
        if self._cluster is not None:
            return self._cluster.resource_spec.num_processes
        return len(self._procs) + 1

    @property
    def reform_pending(self):
        """True when a re-form has been requested but not yet executed."""
        return self._reform is not None and not self._reform_done

    @property
    def reform_requested(self):
        """True from a re-form request until its exec: pending, or under
        way on another thread (``reform_now`` then never returns). The
        step loop polls this: over gloo the chief's main thread is not
        stuck in the dead peer's collective, and must hand off to the
        re-exec instead of ending the process."""
        return self._reform is not None

    def pin_strategy(self, strategy_id):
        """Pin a serialized strategy artifact for the next generation:
        :meth:`reform_now` then ships ``AUTODIST_STRATEGY_ID`` through the
        re-exec env instead of dropping it."""
        self._pinned_strategy_id = str(strategy_id) if strategy_id else None
        return self._pinned_strategy_id

    def request_reform(self, new_world, reason=""):
        """Ask for the job to re-form at ``new_world`` processes; the
        hand-off happens in :meth:`reform_now` (from the chief's step loop
        after an emergency save, or from the supervision thread)."""
        new_world = max(1, int(new_world))
        self._reform = new_world
        self._reform_reason = reason or "requested"
        from autodist_tpu_torch import resilience
        resilience.record_event(
            "re-form-request", f"target world size {new_world} ({reason})")
        return new_world

    def grow(self, extra=1, immediate=None):
        """Capacity arrived: re-form at ``world_size + extra`` (onto
        standby nodes the spec already lists). ``immediate`` unset: a
        world of several processes re-forms now, a one-process world
        defers to the step loop's drain."""
        target = self.request_reform(self.world_size + extra,
                                     reason=f"capacity arrival (+{extra})")
        if immediate is None:
            immediate = process_count() > 1
        if immediate:
            self.reform_now()
        return target

    def shrink(self, remove=1, immediate=None):
        """Planned capacity release: re-form at ``world_size - remove``
        (floored at 1); ``immediate`` as in :meth:`grow`."""
        target = self.request_reform(max(1, self.world_size - remove),
                                     reason=f"capacity release (-{remove})")
        if immediate is None:
            immediate = process_count() > 1
        if immediate:
            self.reform_now()
        return target

    def attach_loop(self, attached=True):
        """A step loop that polls this coordinator between steps starts
        (``attached``) or ends; see :meth:`reform_soon`."""
        self._loops += 1 if attached else -1

    def reform_soon(self):
        """Re-form from the supervision thread. Over gloo the chief's main
        thread is not stuck in the dead peer's collective: it fails, or
        reaches its next poll, at once. So a step loop attached to this
        coordinator gets ``HANDOFF_WAIT_S`` to take the hand-off itself
        (its drain first books the generation's steps into the goodput
        segment that :meth:`reform_now` persists); a loop that does not
        (stuck in a collective that never fails), or none, leaves it to
        this thread."""
        if self._loops:
            deadline = time.monotonic() + HANDOFF_WAIT_S
            while time.monotonic() < deadline:
                if self._reform_done:
                    return  # the loop's drain runs it
                time.sleep(0.01)
        self.reform_now()

    def reform_env(self, new_world):
        """The env the next generation runs under: the chief's own at world
        size ``new_world`` (``AUTODIST_STRATEGY_ID`` dropped unless pinned,
        no ``AUTODIST_WORKER``), with the run id and the next generation
        index when telemetry is on."""
        env = dict(os.environ)
        env[const.ENV.AUTODIST_NUM_PROCESSES.var_name] = str(new_world)
        env[const.ENV.AUTODIST_ELASTIC_WORLD.var_name] = str(new_world)
        env.pop(const.ENV.AUTODIST_STRATEGY_ID.var_name, None)
        if self._pinned_strategy_id:
            env[const.ENV.AUTODIST_STRATEGY_ID.var_name] = \
                self._pinned_strategy_id
        env.pop(const.ENV.AUTODIST_WORKER.var_name, None)
        env[const.ENV.AUTODIST_PROCESS_ID.var_name] = "0"
        if observability.enabled():
            from autodist_tpu_torch.observability import goodput
            env.update(goodput.reexec_env())
        return env

    def reform_now(self):
        """Execute the pending re-form: terminate this generation's workers
        and replace this process with the same user script under the
        re-formed env contract (:meth:`reform_env`). Before the exec, every
        pending checkpoint write is joined, this generation's goodput
        segment is persisted (its end bounds the
        re-exec gap the stitcher prices), the trace is flushed to
        ``autodist_trace_<pid>_g<generation>.json`` (the exec runs no
        atexit) and the standard streams are flushed.

        Runs once: a second caller returns when the first is done, or
        never when the first replaced the process. Under a stubbed exec
        (tests) this returns; callers then raise ElasticReform."""
        with self._reform_lock:
            if self._reform is None or self._reform_done:
                return
            self._reform_done = True
            new_world = self._reform
            self._closing = True
            for p in self._procs:
                if p.poll() is None:
                    p.terminate()
            env = self.reform_env(new_world)
            # A checkpoint still being written would be torn by the exec.
            from autodist_tpu_torch.checkpoint import saver
            saver.join_writers()
            try:
                if observability.enabled():
                    from autodist_tpu_torch.observability import (goodput,
                                                                  tracing)
                    goodput.persist_segment(
                        reason=("selfheal"
                                if str(self._reform_reason).startswith(
                                    "selfheal") else "re-exec"))
                    base, ext = os.path.splitext(tracing.default_trace_path())
                    observability.flush_trace(
                        f"{base}_g{goodput.generation()}{ext}")
            except Exception as e:  # noqa: BLE001 - never blocks a re-form
                logging.debug("goodput segment / trace not closed before "
                              "re-exec: %s", e)
            from autodist_tpu_torch import resilience
            resilience.record_event(
                "re-form", f"re-exec at world size {new_world} "
                           f"({self._reform_reason})")
            logging.warning("elastic re-form: re-exec at world size %d (%s)",
                            new_world, self._reform_reason)
            argv = [sys.executable, os.path.abspath(sys.argv[0])] + \
                sys.argv[1:]
            for stream in (sys.stdout, sys.stderr):
                try:
                    stream.flush()
                except Exception:  # noqa: BLE001 - a closed stream
                    pass
            self._exec(sys.executable, argv, env)
            # Only reachable when _exec is stubbed (tests).
            self._world_size = new_world
            self._reform = None

    # -- launch --------------------------------------------------------------

    def _env_contract(self, pid, num_workers, coordinator, worker_address):
        """The chief->worker launch contract."""
        env = {
            const.ENV.AUTODIST_WORKER.var_name: worker_address,
            const.ENV.AUTODIST_PROCESS_ID.var_name: str(pid),
            const.ENV.AUTODIST_NUM_PROCESSES.var_name: str(num_workers),
            const.ENV.AUTODIST_COORDINATOR.var_name: coordinator,
        }
        if self._strategy is not None:
            # A pre-built strategy: workers load the artifact by id.
            # Without one, the chief ships it over the store.
            env[const.ENV.AUTODIST_STRATEGY_ID.var_name] = self._strategy.id
        for passthrough in (const.ENV.AUTODIST_MIN_LOG_LEVEL,
                            const.ENV.AUTODIST_IS_TESTING):
            if passthrough.var_name in os.environ:
                env[passthrough.var_name] = os.environ[passthrough.var_name]
        try:
            # Every worker shares the chief's run id.
            from autodist_tpu_torch.observability import goodput
            env[const.ENV.AUTODIST_RUN_ID.var_name] = goodput.run_id()
        except Exception:  # noqa: BLE001 - identity is best-effort
            pass
        return env

    def launch_clients(self, num_workers=None):
        """Spawn worker processes re-running this script (chief only):
        subprocesses on this machine under ``launch: local``, the same
        script on every non-chief node over SSH under ``launch: ssh``."""
        spec = self._cluster.resource_spec
        num_workers = num_workers or spec.num_processes
        if num_workers <= 1:
            return
        coordinator = spec.coordinator or (
            f"{spec.chief_address}:{const.DEFAULT_COORDINATOR_PORT}"
            if spec.remote_launch
            else f"127.0.0.1:{const.DEFAULT_COORDINATOR_PORT}")
        script_argv = [os.path.abspath(sys.argv[0])] + sys.argv[1:]
        if spec.remote_launch:
            # The user script and its dependencies exist on every node at
            # the same absolute path.
            from autodist_tpu_torch.ssh import SSHLauncher
            launcher = SSHLauncher(spec)
            workers = [a for a in spec.node_addresses
                       if a != spec.chief_address]
            for pid, address in enumerate(workers, start=1):
                env = self._env_contract(pid, num_workers, coordinator,
                                         address)
                proc = launcher.remote_exec(
                    address, [sys.executable] + script_argv, env=env,
                    cwd=os.getcwd())
                if proc is None:  # AUTODIST_DEBUG_REMOTE: dry run
                    continue
                logging.info("ssh-launched worker %d on %s (client pid %d)",
                             pid, address, proc.pid)
                observability.record_event(
                    "worker-launch", f"worker {pid} via ssh on {address}")
                self._procs.append(proc)
                self._proc_wait_async(proc, pid)
            return
        for pid in range(1, num_workers):
            address = spec.node_addresses[
                min(pid, len(spec.node_addresses) - 1)] \
                if spec.node_addresses else f"proc-{pid}"
            env = dict(os.environ)
            env.update(self._env_contract(pid, num_workers, coordinator,
                                          address))
            self._worker_launch[pid] = (address, env)
            self._spawn_local(pid, env)

    def _worker_argv(self):
        """The command line a (re)spawned local worker runs: the same
        script."""
        return [sys.executable] + sys.argv

    def _spawn_local(self, pid, env):
        proc = subprocess.Popen(self._worker_argv(), env=env)
        logging.info("launched worker process %d (pid %d)", pid, proc.pid)
        observability.record_event("worker-launch",
                                   f"worker {pid} (os pid {proc.pid})")
        self._procs.append(proc)
        self._proc_wait_async(proc, pid)
        return proc

    def respawn_worker(self, worker_index):
        """Relaunch a dead local worker with its original env contract
        (restart-worker policy); a respawn clears the failure flag."""
        launch = self._worker_launch.get(worker_index)
        if launch is None:
            logging.error("cannot respawn worker %d: not locally launched",
                          worker_index)
            return None
        _, env = launch
        proc = self._spawn_local(worker_index, env)
        self._failed.clear()
        return proc

    def _proc_wait_async(self, proc, worker_index):
        """Dispatch a worker's death to the supervision policy. ``_failed``
        flips before the dispatch, so the step loop observes the death
        whatever the policy decides. Policies get the LOGICAL worker
        index, never ``proc.pid``."""
        def watch():
            code = proc.wait()
            if code != 0 and not self._closing:
                self._failed.set()
                self._supervision.on_worker_death(self, worker_index, proc,
                                                  code)
        threading.Thread(target=watch, daemon=True,
                         name=f"autodist-watch-{worker_index}").start()

    def join(self):
        """Wait for the worker processes to exit."""
        for p in self._procs:
            p.wait()

    def terminate(self):
        self._closing = True
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
