"""Preemption handling: SIGTERM/SIGINT => emergency checkpoint, then exit.

Counterpart of ``autodist_tpu/resilience/preemption.py``. The handler is
**cooperative**: the signal callback only sets a flag (no file I/O and no
CUDA work inside a signal frame), and the guarded step loop polls the flag
once per step (once per K-step graph under ``unroll=K``), force-saves the
live state through the bound CheckpointManager, and raises
:class:`Preempted` to unwind. Worst-case added loss: one step (one
megastep).
"""
import signal

from autodist_tpu_torch.utils import logging


class Preempted(SystemExit):
    """Raised by the step loop after the emergency save; carries the
    conventional 128+signum exit code so supervisors see a clean
    preemption, not a crash."""

    def __init__(self, signum, saved_step):
        super().__init__(128 + signum)
        self.signum = signum
        self.saved_step = saved_step


class PreemptionHandler:
    """Installs SIGTERM/SIGINT hooks that request an emergency save.

    Usage (done automatically by ``CheckpointManager.run(preemption=True)``)::

        handler = PreemptionHandler().install()
        try:
            for ...:
                state, metrics = runner.step(state, batch)
                handler.check(manager, step, state)  # raises Preempted
        finally:
            handler.uninstall()
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous = {}
        self.preempted = False
        self.signum = None

    def _on_signal(self, signum, frame):
        # Async-signal-safe by construction: set flags only.
        self.preempted = True
        self.signum = signum

    def install(self):
        """Register handlers (main thread only: the signal module's
        contract); the previous handlers are restored by
        :meth:`uninstall`."""
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._on_signal)
        except BaseException:
            self.uninstall()
            raise
        return self

    def uninstall(self):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):  # non-main thread / exotic prev
                pass
        self._previous.clear()

    def check(self, manager, step, state):
        """Poll point for step loops: on a pending preemption, force-save
        ``state`` and raise :class:`Preempted`."""
        if not self.preempted:
            return
        from autodist_tpu_torch import observability, resilience
        signame = signal.Signals(self.signum).name \
            if self.signum is not None else "?"
        logging.warning("preemption (%s) at step %d: writing emergency "
                        "checkpoint", signame, step)
        # Emergency-save span: the goodput ledger prices drain-path saves
        # as their own badput class, not as periodic checkpoint time.
        with observability.span("emergency-save", step=step,
                                why="preemption"):
            saved = manager.save(step, state, force=True)
            manager.wait_until_finished()
        resilience.record_event(
            "preemption", f"{signame} at step {step}: emergency checkpoint "
                          f"{'written' if saved else 'skipped (dup)'}")
        raise Preempted(self.signum, step)
