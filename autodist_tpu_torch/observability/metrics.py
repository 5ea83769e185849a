"""Low-overhead metrics registry: counters, gauges, time-window histograms.

Counterpart of ``autodist_tpu/observability/metrics.py``, unchanged.

The registry is deliberately tiny — plain Python objects behind one lock
for creation, per-instrument locks for updates.  Hot paths (the Runner
step loop) never touch it per-step: they batch host-side observations in
a local list and flush on the StepGuard cadence via
:meth:`WindowHistogram.observe_many`, so the per-dispatch cost of
telemetry is two clock reads (one a CUDA event on the card:
``runner.DispatchClock``) and a list append.

Histograms are *time-window*: a bounded deque of the last N observations
(``AUTODIST_METRICS_WINDOW``), summarized on demand.  A training job
running for days must not grow memory with step count, and the questions
telemetry answers ("why is this step slow *now*", "what is p90 over the
last few hundred steps") are windowed questions.

Under fused multi-step dispatch (``Runner.run(unroll=K)``) one host
observation covers K steps: ``step.latency_ms`` records per-dispatch/K
(so values stay comparable across unroll factors and its *count* is the
dispatch count), while ``step.count``/``step.examples`` keep counting
steps; the ``step.unroll`` gauge carries K for report readers.
"""
import threading

from collections import deque

from autodist_tpu_torch import const


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value")

    def __init__(self, name):
        self.name = name
        self._value = None

    def set(self, v):
        self._value = v

    @property
    def value(self):
        return self._value


def _quantile(sorted_vals, q):
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class WindowHistogram:
    """Bounded-window histogram: keeps the last ``window`` observations.

    ``count``/``total`` are lifetime (so throughput math stays exact);
    the distribution stats (mean/min/max/p50/p90) describe the window.
    """

    __slots__ = ("name", "_values", "_count", "_total", "_lock")

    def __init__(self, name, window):
        self.name = name
        self._values = deque(maxlen=max(1, int(window)))
        self._count = 0
        self._total = 0.0
        self._lock = threading.Lock()

    def observe(self, v):
        with self._lock:
            self._values.append(v)
            self._count += 1
            self._total += v

    def observe_many(self, vs):
        """Batch flush — the hot-loop entry point (one lock acquisition)."""
        with self._lock:
            self._values.extend(vs)
            self._count += len(vs)
            self._total += sum(vs)

    @property
    def count(self):
        return self._count

    @property
    def total(self):
        return self._total

    def summary(self):
        with self._lock:
            vals = sorted(self._values)
            count, total = self._count, self._total
        if not vals:
            return {"count": count, "total": total}
        return {
            "count": count,
            "total": total,
            "window": len(vals),
            "mean": sum(vals) / len(vals),
            "min": vals[0],
            "max": vals[-1],
            "p50": _quantile(vals, 0.50),
            "p90": _quantile(vals, 0.90),
            "p99": _quantile(vals, 0.99),
        }


class MetricsRegistry:
    """Name-keyed instrument registry with a JSON-serializable snapshot."""

    def __init__(self):
        self._instruments = {}
        self._lock = threading.Lock()

    def _get(self, name, factory):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = factory()
                    self._instruments[name] = inst
        return inst

    def counter(self, name):
        return self._get(name, lambda: Counter(name))

    def gauge(self, name):
        return self._get(name, lambda: Gauge(name))

    def histogram(self, name, window=None):
        if window is None:
            window = const.ENV.AUTODIST_METRICS_WINDOW.val
        return self._get(name, lambda: WindowHistogram(name, window))

    def snapshot(self):
        """{"counters": {...}, "gauges": {...}, "histograms": {...}}."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            instruments = dict(self._instruments)
        for name, inst in sorted(instruments.items()):
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.summary()
        return out

    def reset(self):
        """Drop all instruments (test harness hook)."""
        with self._lock:
            self._instruments.clear()


_registry = MetricsRegistry()


def registry():
    """The process-global registry."""
    return _registry
