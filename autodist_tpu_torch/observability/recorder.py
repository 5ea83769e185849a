"""Flight recorder: bounded event bus + crash-durable JSONL sidecar.

Counterpart of ``autodist_tpu/observability/recorder.py``, unchanged:
every framework-level event (compiles, checkpoint saves and restores,
strategy ships, and the whole resilience trail, which forwards here) lands
on one bounded in-memory bus AND is appended, line-buffered, to
``DEFAULT_LOG_DIR/flight_<pid>.jsonl`` (one file per process, so a
SIGKILL loses at most the current line). Events are rare (per phase, per
recovery, never per step).

On-disk growth is bounded (``AUTODIST_FLIGHT_MAX_MB``, default 64): the
sidecar rolls to a new segment once the current one reaches 1/8 of the
cap, and the oldest ``flight_*.jsonl`` files are evicted until the
directory total fits.
"""
import glob
import json
import os
import threading
import time

from collections import deque

from autodist_tpu_torch import const

_CAPACITY = 2048

#: Every event type of the JAX package (the names the goodput ledger's
#: classification keys on); the port emits a subset of them and no other
#: (``tests/test_torch_observability.py`` pins both).
EVENT_TYPES = frozenset({
    "anchors-skipped", "anomaly", "attribution", "automap",
    "chaos:ckpt-truncate", "chaos:kill",
    "chaos:kv-delay", "chaos:nan", "chaos:oom", "chaos:slow-host",
    "checkpoint-restore", "checkpoint-save",
    "ckpt-fallback", "compile", "divergence-abort", "emergency-save",
    "goodput", "memory", "mesh-built", "monitor-start", "oom",
    "pipeline", "preemption",
    "profile",
    "re-form", "re-form-request", "reshard", "retry", "retune", "rollback",
    "selfheal", "serve-compile", "serve-scale", "serve-start", "serve-stop",
    "spec-shrink",
    "straggler", "strategy-ship", "transform", "tuner", "worker-death",
    "worker-launch", "worker-restart",
})

_events = deque(maxlen=_CAPACITY)
_lock = threading.Lock()
_fh = None
_fh_failed = False
_written = 0   # bytes appended to the CURRENT segment
_segment = 0


def _cap_bytes():
    return max(1, const.ENV.AUTODIST_FLIGHT_MAX_MB.val) * (1 << 20)


def _segment_bytes():
    """Roll threshold: eviction works in whole files, so segments must be
    small relative to the cap for the bound to be tight."""
    return max(64 << 10, _cap_bytes() // 8)


def _sidecar():
    """Lazily open the JSONL sidecar; a read-only filesystem disables it
    for the process lifetime (same allowance utils/logging makes)."""
    global _fh, _fh_failed, _written
    if _fh is not None or _fh_failed:
        return _fh
    try:
        const.ensure_working_dirs()
        suffix = f"_{_segment}" if _segment else ""
        path = os.path.join(const.DEFAULT_LOG_DIR,
                            f"flight_{os.getpid()}{suffix}.jsonl")
        _fh = open(path, "a", buffering=1)
        _written = 0
    except OSError:
        _fh_failed = True
        _fh = None
    return _fh


def _evict(current_path):
    """Drop the oldest flight files until the directory total fits the
    cap; the live segment is never evicted.  Fail-open."""
    try:
        files = []
        for p in glob.glob(os.path.join(const.DEFAULT_LOG_DIR,
                                        "flight_*.jsonl")):
            if os.path.abspath(p) == os.path.abspath(current_path):
                continue
            st = os.stat(p)
            files.append((st.st_mtime, p, st.st_size))
        total = sum(sz for _, _, sz in files)
        cap = _cap_bytes()
        for _mtime, p, sz in sorted(files):
            if total <= cap:
                break
            os.remove(p)
            total -= sz
    except OSError:
        pass


def _maybe_roll():
    """Roll to the next segment and evict old files when the current one
    is full.  Caller holds the lock."""
    global _fh, _segment, _written
    if _fh is None or _written < _segment_bytes():
        return
    path = getattr(_fh, "name", "")
    try:
        _fh.close()
    except OSError:
        pass
    _fh = None
    _segment += 1
    _written = 0
    _evict(path)


def record(kind, detail="", **fields):
    """Append one event to the bus and the JSONL sidecar (fail-open)."""
    global _written
    entry = {"t": round(time.time(), 3), "kind": str(kind),
             "detail": str(detail)}
    if fields:
        entry.update({k: v for k, v in fields.items()})
    with _lock:
        _events.append(entry)
        fh = _sidecar()
        if fh is not None:
            try:
                line = json.dumps(entry, default=str) + "\n"
                fh.write(line)
                _written += len(line)
                _maybe_roll()
            except (OSError, ValueError, TypeError):
                pass
    # Mirror into the trace timeline so Perfetto shows WHEN each event
    # happened relative to the phase spans.
    try:
        from autodist_tpu_torch.observability import tracing
        tracing.record_instant(f"{kind}", {"detail": str(detail)[:200]})
    except Exception:  # noqa: BLE001 - telemetry must never kill a run
        pass


def events(limit=None):
    """Snapshot of the bus, oldest first (``limit`` keeps the newest N)."""
    with _lock:
        out = list(_events)
    if limit is not None:
        out = out[-limit:]
    return out


def clear():
    """Reset the bus (test harness hook); the sidecar file is left as-is."""
    with _lock:
        _events.clear()


def _reset_sidecar_for_tests():
    """Close the sidecar and forget its state so a monkeypatched log dir
    takes effect (test harness hook)."""
    global _fh, _fh_failed, _written, _segment
    with _lock:
        if _fh is not None:
            try:
                _fh.close()
            except OSError:
                pass
        _fh = None
        _fh_failed = False
        _written = 0
        _segment = 0


def sidecar_path():
    """Path of the JSONL sidecar, or ``None`` when disabled/unopened."""
    with _lock:
        fh = _sidecar()
    return getattr(fh, "name", None)


def read_jsonl(path):
    """Parse one flight-recorder JSONL file -> ``(events, truncated)``.

    The sidecar is appended line-buffered with no fsync: a crash (or
    SIGKILL) mid-write legitimately leaves a torn final line.  That is
    post-mortem data, not corruption — the reader skips the unparseable
    final line and surfaces ``truncated=True`` instead of raising, so
    offline consumers (tools/timeline, ad-hoc forensics) always get the
    events that DID land.  A malformed line mid-file (disk damage) is
    skipped too and counts as truncation.
    """
    events, truncated = [], False
    with open(path) as f:
        raw = f.read()
    lines = raw.split("\n")
    # Every complete append ends with a newline (the \n is part of the
    # same write()): a file not ending in one has a torn final line —
    # dropped even if the fragment happens to parse (a cut inside a
    # string field can still close), because its content can't be
    # trusted.
    if raw and not raw.endswith("\n"):
        lines = lines[:-1]
        truncated = True
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            entry = json.loads(line)
        except ValueError:
            truncated = True
            continue
        if not isinstance(entry, dict):
            truncated = True
            continue
        events.append(entry)
    return events, truncated
