"""Jittered-exponential-backoff retry for transient distributed faults.

Counterpart of ``autodist_tpu/resilience/retry.py``. Applied where the
engine touches flaky shared infrastructure: strategy shipping over the
c10d store (``autodist.py``) and checkpoint I/O (``checkpoint/saver.py``).
Which exceptions are retryable is a *predicate*, not a blanket ``except
Exception``: a corruption error must fall through to the corruption
fallback, not spin the backoff loop.
"""
import random
import time
from typing import NamedTuple

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging


class RetryPolicy(NamedTuple):
    """Backoff shape: ``base_delay * multiplier^attempt``, full jitter,
    capped per-sleep at ``max_delay`` and overall at ``deadline`` seconds."""
    max_attempts: int = 4
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    deadline: float = 300.0
    jitter: float = 1.0  # 1.0 = full jitter, 0.0 = deterministic


def default_policy():
    """The process-wide policy with the typed ENV attempt override."""
    attempts = const.ENV.AUTODIST_RETRY_MAX_ATTEMPTS.val
    return RetryPolicy(max_attempts=max(1, attempts))


def retryable(*exc_types, predicate=None):
    """Build a retryable-error predicate from exception types plus an
    optional refinement (e.g. RuntimeError, but only when the message says
    the peer timed out)."""
    def check(exc):
        if exc_types and not isinstance(exc, exc_types):
            return False
        if predicate is not None and not predicate(exc):
            return False
        return True
    return check


# Flake signatures of the c10d store and the filesystem; anything else
# (a mismatched program, a programming error) must raise.
_TRANSIENT_MARKERS = ("deadline", "unavailable", "timed out", "timeout",
                      "connection", "reset", "temporarily", "try again",
                      "barrier", "heartbeat")


def transient_runtime_error(exc):
    """True for RuntimeError/ConnectionError/TimeoutError instances whose
    message looks like an infrastructure flake rather than a bug."""
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if not isinstance(exc, (RuntimeError, OSError)):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


def retry_call(fn, *args, policy=None, is_retryable=None, describe=None,
               sleep=time.sleep, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying retryable failures.

    Args:
        policy: RetryPolicy (default: :func:`default_policy`).
        is_retryable: predicate(exc) -> bool; non-matching exceptions
            propagate immediately.  Default: :func:`transient_runtime_error`.
        describe: short operation name for logs/events.
        sleep: injection point for tests (no real waiting in CI).
    """
    from autodist_tpu_torch import resilience
    policy = policy or default_policy()
    is_retryable = is_retryable or transient_runtime_error
    what = describe or getattr(fn, "__name__", "operation")
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - filtered by predicate below
            attempt += 1
            elapsed = time.monotonic() - start
            if (not is_retryable(e) or attempt >= policy.max_attempts
                    or elapsed >= policy.deadline):
                raise
            delay = min(policy.base_delay * policy.multiplier ** (attempt - 1),
                        policy.max_delay,
                        max(0.0, policy.deadline - elapsed))
            if policy.jitter:
                delay *= 1.0 - policy.jitter * random.random()
            resilience.record_event(
                "retry", f"{what}: attempt {attempt}/{policy.max_attempts} "
                         f"failed ({type(e).__name__}: {e}); "
                         f"backing off {delay:.2f}s")
            logging.warning("%s failed (attempt %d/%d): %s — retrying in "
                            "%.2fs", what, attempt, policy.max_attempts, e,
                            delay)
            sleep(delay)
