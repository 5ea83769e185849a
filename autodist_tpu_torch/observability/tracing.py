"""Span-based phase tracing emitted as Chrome trace events.

Counterpart of ``autodist_tpu/observability/tracing.py``. Every framework
phase (capture -> strategy build -> transform -> compile -> ship ->
restore -> step loop) runs under a :class:`Span`; completed spans land in
a bounded in-memory ring and flush to
``DEFAULT_TRACE_DIR/autodist_trace_<pid>.json`` in the Chrome trace-event
format (Perfetto / chrome://tracing). The opt-in bridge
(``AUTODIST_TRACE=profiler``) also wraps each span in
``torch.profiler.record_function``, so framework phases line up with the
kernels in a ``torch.profiler`` trace (``Runner.run`` then records one
into ``DEFAULT_TRACE_DIR``).

Overhead discipline: a span costs two ``time.perf_counter()`` calls and
one deque append (no device work, so a span may enclose a CUDA graph
capture); the ring is bounded; flushing is explicit (end of
``Runner.run``, ``flush()``) plus a best-effort ``atexit``; everything is
fail-open. Each flush is stamped with the skew layer's clock offset
against the chief (``clock_offset_ms``, ``observability/skew.py``), so
per-rank files align on one clock.
"""
import atexit
import json
import os
import threading
import time

from collections import deque

from autodist_tpu_torch import const

_MAX_EVENTS = 20_000

_events = deque(maxlen=_MAX_EVENTS)
_lock = threading.Lock()
# Phase accumulator: name -> [first_start_us, total_us, count], kept apart
# from the ring so phase totals survive event eviction.
_phase = {}
_origin = time.perf_counter()
# Wall-clock epoch of the perf_counter origin: trace ts 0 is this moment.
_origin_epoch = time.time() - (time.perf_counter() - _origin)
_mode_cache = None


def _mode():
    """Effective AUTODIST_TRACE mode: "chrome" | "profiler" | "" (off)."""
    global _mode_cache
    if _mode_cache is None:
        raw = str(const.ENV.AUTODIST_TRACE.val).strip().lower()
        if raw in ("0", "off", "false", "none"):
            _mode_cache = ""
        elif raw in ("profiler", "torch", "jax"):
            _mode_cache = "profiler"
        else:  # default / "1" / "chrome"
            _mode_cache = "chrome"
    return _mode_cache


def refresh():
    """Re-read the AUTODIST_TRACE knob (test harness hook)."""
    global _mode_cache
    _mode_cache = None


def _now_us():
    return (time.perf_counter() - _origin) * 1e6


def perf_to_epoch(t_perf):
    """A ``perf_counter`` reading -> wall-clock epoch seconds."""
    return _origin_epoch + (t_perf - _origin)


def perf_to_us(t_perf):
    """A ``perf_counter`` reading -> trace microseconds (a span's ``ts``)."""
    return (t_perf - _origin) * 1e6


def epoch_anchor_us():
    """Wall-clock epoch (microseconds) of trace timestamp 0, stamped into
    every flushed trace so per-rank files are alignable."""
    return _origin_epoch * 1e6


class Span:
    """Context manager recording one complete ("ph": "X") trace event."""

    __slots__ = ("name", "args", "_t0", "_annotation")

    def __init__(self, name, args=None):
        self.name = name
        self.args = args or {}
        self._t0 = None
        self._annotation = None

    def __enter__(self):
        self._t0 = _now_us()
        if _mode() == "profiler":
            try:
                import torch
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            except Exception:  # noqa: BLE001 - telemetry must never kill a run
                self._annotation = None
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now_us()
        if self._annotation is not None:
            try:
                self._annotation.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
        record_complete(self.name, self._t0, t1 - self._t0, self.args)
        return False


class _NullSpan:
    """Shared no-op span for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def record_complete(name, ts_us, dur_us, args=None):
    """Append one complete event and fold it into the phase accumulator."""
    ev = {"name": name, "cat": "autodist", "ph": "X",
          "ts": round(ts_us, 1), "dur": round(dur_us, 1),
          "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF}
    if args:
        ev["args"] = {k: str(v) for k, v in args.items()}
    with _lock:
        _events.append(ev)
        acc = _phase.get(name)
        if acc is None:
            _phase[name] = [ts_us, dur_us, 1]
        else:
            acc[1] += dur_us
            acc[2] += 1


def record_instant(name, args=None):
    """Append one instant ("ph": "i") event: the flight-recorder bridge."""
    ev = {"name": name, "cat": "autodist", "ph": "i", "s": "p",
          "ts": round(_now_us(), 1), "pid": os.getpid(),
          "tid": threading.get_ident() & 0xFFFF}
    if args:
        ev["args"] = {k: str(v) for k, v in args.items()}
    with _lock:
        _events.append(ev)


def events():
    """Snapshot of buffered trace events (oldest may have been evicted)."""
    with _lock:
        return list(_events)


def phase_summary():
    """{phase: {"start_ms", "total_ms", "count"}}."""
    with _lock:
        return {name: {"start_ms": round(s / 1e3, 3),
                       "total_ms": round(d / 1e3, 3), "count": n}
                for name, (s, d, n) in _phase.items()}


def clear():
    """Drop buffered events and phase totals (test harness hook)."""
    with _lock:
        _events.clear()
        _phase.clear()


def default_trace_path():
    return os.path.join(const.DEFAULT_TRACE_DIR,
                        f"autodist_trace_{os.getpid()}.json")


def process_index():
    """This process's rank in the ``torch.distributed`` world (0 before a
    world exists): the counterpart of ``jax.process_index()``."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # noqa: BLE001 - a broken world reads as rank 0
        pass
    return 0


def process_count():
    """The ``torch.distributed`` world's size (1 before a world exists)."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
    except Exception:  # noqa: BLE001
        pass
    return 1


def flush(path=None):
    """Write buffered events as one Chrome-trace JSON file.

    Returns the path written, or ``None`` when there was nothing to write
    or the filesystem refused (fail-open: in-memory events are kept).
    """
    if _mode() == "":
        return None
    evs = events()
    if not evs:
        return None
    path = path or default_trace_path()
    meta = {"epoch_anchor_us": round(epoch_anchor_us(), 1),
            "pid": os.getpid(), "host": process_index()}
    try:
        # The skew layer's offset vs the chief, when a ping exchange ran.
        from autodist_tpu_torch.observability import skew
        est = skew.local_offset()
        if est is not None:
            meta["clock_offset_ms"] = est.get("offset_ms", 0.0)
            meta["clock_uncertainty_ms"] = est.get("uncertainty_ms", 0.0)
    except Exception:  # noqa: BLE001 - the stamp is best-effort
        pass
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms",
                       "metadata": meta}, f)
    except OSError:
        return None
    return path


def _flush_at_exit():
    try:
        from autodist_tpu_torch import observability
        if observability.enabled():
            flush()
    except Exception:  # noqa: BLE001 - interpreter teardown is hostile
        pass


atexit.register(_flush_at_exit)
