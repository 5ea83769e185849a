"""Deterministic fault injection, driven by ``AUTODIST_CHAOS``.

Counterpart of ``autodist_tpu/resilience/chaos.py``: a recovery path that
is never exercised does not work, so each failure mode can be replayed on
the CPU tests and on the card. ``AUTODIST_CHAOS`` is a comma-separated
``knob=value`` list:

* ``nan_at=N``        poison the training batch at (1-based) step N with
  NaNs (its first float leaf): gradients, loss and the state updated in
  place all go non-finite, like a numeric blow-up inside the model;
* ``kill_at=N[:P]``   hard ``os._exit(9)`` at step N (process P only;
  default: any non-chief process), a preempted or OOM-killed worker with
  no teardown and no atexit;
* ``kill_worker=P[:seed]`` probabilistic hard worker death: every step each
  non-chief process rolls a seeded sha256 coin and exits with code 9 with
  probability P, so a chaos run replays exactly; the chief (which owns
  supervision) is spared;
* ``slow_host=MS[:seed]`` a degraded host: every step the lowest
  non-chief process (:data:`SLOW_HOST_TARGET`) sleeps a deterministic
  per-(host, step) delay in [0.5 MS, 1.5 MS) before its dispatch;
* ``oom_at=N``        raise a synthetic out-of-memory ``RuntimeError`` at
  (1-based) step N, once per process;
* ``kv_delay_ms=T``   sleep T ms before every strategy fetch from the c10d
  store (strategy shipping), surfacing ship-timeout handling.

:func:`truncate_checkpoint` corrupts the latest retained checkpoint step
(called directly).

A process's index is its rank when a ``torch.distributed`` world is up,
else ``AUTODIST_PROCESS_ID``. Every injection is recorded as a
``chaos:*`` resilience event.
"""
import os
import time

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import tree_map

# The file of a checkpoint step that seals it (checkpoint/saver.py's index);
# truncation deletes it and halves every other file.
_SENTINELS = ("index",)


def knobs():
    """Parse ``AUTODIST_CHAOS`` into {name: str_value} (fresh each call:
    tests flip the env var mid-process)."""
    raw = const.ENV.AUTODIST_CHAOS.val
    out = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, value = part.partition("=")
        out[name.strip()] = value.strip() or "1"
    return out


def active():
    return bool(knobs())


def _record(kind, detail):
    from autodist_tpu_torch import resilience
    resilience.record_event(kind, detail)
    logging.warning("CHAOS %s: %s", kind, detail)


# -- batch poisoning ---------------------------------------------------------

_fired = set()  # one-shot knob instances (a transient fault happens once;
                # a rolled-back loop re-traverses the same step numbers and
                # must not be re-poisoned into an infinite strike loop)


def reset():
    """Forget one-shot injection history (test harness hook)."""
    _fired.clear()


def _is_float(x):
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def maybe_poison_batch(step, batch):
    """Return the batch, NaN-poisoned when ``nan_at`` matches ``step``
    (once per process: a transient bad batch, not a poisoned dataset).

    Only float leaves are poisoned (integer token ids cannot hold NaN);
    one poisoned leaf is enough to sink the loss. The batch given is not
    written: the poisoned leaf is a new tensor (array)."""
    k = knobs().get("nan_at")
    if k is None or int(k) != step or ("nan_at", k) in _fired:
        return batch
    _fired.add(("nan_at", k))
    poisoned = [False]

    def leaf(x):
        if poisoned[0] or not _is_float(x):
            return x
        poisoned[0] = True
        if isinstance(x, torch.Tensor):
            return torch.full_like(x, float("nan"))
        return np.full_like(np.asarray(x), np.nan)
    out = tree_map(leaf, batch)
    _record("chaos:nan", f"poisoned batch at step {step}")
    return out


# -- device OOM --------------------------------------------------------------

def maybe_oom(step):
    """Raise a synthetic device OOM when ``oom_at`` matches ``step`` (once
    per process: the retried or rolled-back loop must not re-fault)."""
    k = knobs().get("oom_at")
    if k is None or int(k) != step or ("oom_at", k) in _fired:
        return
    _fired.add(("oom_at", k))
    _record("chaos:oom", f"synthetic device OOM at step {step}")
    raise RuntimeError(
        f"CUDA out of memory: chaos oom_at={step}: out of memory while "
        f"trying to allocate (synthetic fault injection)")


# -- worker death ------------------------------------------------------------

def _process_index():
    """The rank when a world is up, else the launch contract's index."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return const.ENV.AUTODIST_PROCESS_ID.val


def _coin(text):
    import hashlib
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2.0 ** 64


def kill_worker_roll(spec, step, process_index):
    """The deterministic coin for ``kill_worker=P[:seed]``: True when
    process ``process_index`` dies at ``step`` (a seeded sha256 of (seed,
    process, step), reproducible across relaunches and processes)."""
    prob, _, seed = str(spec).partition(":")
    try:
        p = float(prob)
    except ValueError:
        return False
    if p <= 0.0:
        return False
    if p >= 1.0:
        return True
    return _coin(f"{seed}|{process_index}|{step}") < p


def maybe_kill(step, process_index=None):
    """Hard-exit at the configured step: ``kill_at=N`` (any non-chief
    process), ``kill_at=N:P`` (process P exactly), or the probabilistic
    ``kill_worker=P[:seed]`` (any non-chief process)."""
    ks = knobs()
    k = ks.get("kill_at")
    kw = ks.get("kill_worker")
    if k is None and kw is None:
        return
    if process_index is None:
        process_index = _process_index()
    if k is not None:
        at, _, proc = k.partition(":")
        want = int(proc) if proc else None
        if int(at) == step and not (
                (want is None and process_index == 0)
                or (want is not None and process_index != want)):
            _record("chaos:kill",
                    f"process {process_index} hard-exits at step {step}")
            os._exit(9)
    if kw is not None and process_index != 0 and \
            kill_worker_roll(kw, step, process_index):
        _record("chaos:kill",
                f"process {process_index} hard-exits at step {step} "
                f"(kill_worker={kw})")
        os._exit(9)


# -- degraded host -----------------------------------------------------------

#: The process a ``slow_host`` fault degrades: the lowest non-chief index
#: (the chief owns supervision).
SLOW_HOST_TARGET = 1


def slow_host_delay_ms(step, process_index, spec=None):
    """The deterministic ``slow_host=MS[:seed]`` schedule: the delay (ms)
    injected for ``process_index`` at ``step``, 0 for every process but
    :data:`SLOW_HOST_TARGET`; the magnitude jitters in [0.5 MS, 1.5 MS)
    through the same seeded coin as ``kill_worker``."""
    if spec is None:
        spec = knobs().get("slow_host")
    if spec is None or process_index != SLOW_HOST_TARGET:
        return 0.0
    ms, _, seed = str(spec).partition(":")
    try:
        ms = float(ms)
    except ValueError:
        return 0.0
    if ms <= 0.0:
        return 0.0
    return ms * (0.5 + _coin(f"slow|{seed}|{process_index}|{step}"))


def maybe_slow_host(step, process_index=None):
    """Sleep the ``slow_host`` delay when this process is the degraded
    one; records ``chaos:slow-host`` once per process. Returns the delay
    slept (ms)."""
    spec = knobs().get("slow_host")
    if spec is None:
        return 0.0
    if process_index is None:
        process_index = _process_index()
    delay = slow_host_delay_ms(step, process_index, spec=spec)
    if delay <= 0.0:
        return 0.0
    if ("slow_host", spec) not in _fired:
        _fired.add(("slow_host", spec))
        _record("chaos:slow-host",
                f"process {process_index} degraded: ~{spec.partition(':')[0]}"
                f"ms extra dispatch delay per step (from step {step})")
    time.sleep(delay / 1000.0)
    return delay


# -- store flake -------------------------------------------------------------

def maybe_delay_kv_fetch():
    """Sleep ``kv_delay_ms`` before a strategy fetch from the store
    (ship-timeout exercise)."""
    k = knobs().get("kv_delay_ms")
    if k is None:
        return
    _record("chaos:kv-delay", f"delaying KV fetch {k}ms")
    time.sleep(int(k) / 1000.0)


# -- checkpoint corruption ---------------------------------------------------

def truncate_checkpoint(directory, step=None):
    """Corrupt a retained checkpoint step directory (default: the latest):
    truncate every data file under it to half its length and delete the
    index. Returns the corrupted step, or None when nothing exists.

    Models a host preempted mid-write or a blob store returning a torn
    object: the integrity check in ``restore_or_init`` must detect it and
    fall back to the previous retained step."""
    directory = os.path.abspath(str(directory))
    if not os.path.isdir(directory):
        return None
    steps = sorted(int(d) for d in os.listdir(directory) if d.isdigit())
    if not steps:
        return None
    step = steps[-1] if step is None else int(step)
    root = os.path.join(directory, str(step))
    for dirpath, _, files in os.walk(root):
        for fname in files:
            path = os.path.join(dirpath, fname)
            try:
                size = os.path.getsize(path)
                if fname.startswith(_SENTINELS):
                    os.remove(path)
                elif size > 1:
                    with open(path, "r+b") as f:
                        f.truncate(size // 2)
            except OSError:
                continue
    _record("chaos:ckpt-truncate", f"corrupted checkpoint step {step} "
                                   f"under {directory}")
    return step
