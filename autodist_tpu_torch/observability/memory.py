"""HBM memory ledger: predicted-vs-measured device-memory accounting.

Counterpart of ``autodist_tpu/observability/memory.py``. The measured side
reads the CUDA caching allocator (``torch.cuda.memory_stats`` /
``memory_snapshot``) on a card and the bytes of the tensors the Runner
holds on the CPU; an OOM is a ``torch.OutOfMemoryError`` or "CUDA out of
memory" (:func:`is_oom`).

Step-time observability answers "where did the milliseconds go"; this
module answers the question that actually kills jobs — **where does the
HBM go, and will this candidate even fit?**  Three pieces (docs/memory.md):

* **Predicted** — :meth:`~autodist_tpu_torch.tuner.cost_model.CostModel.
  strategy_memory` prices a candidate's peak per-device footprint into
  six named ledger classes (params / optimizer / gradients / sync-state
  / activations / staging) that sum *exactly* to the predicted peak
  (tier-1 pinned), against a per-backend capacity table
  (``goodput.PEAK_HBM_GB_TABLE``, ``AUTODIST_HBM_GB`` override, spec
  ``memory:`` block).
* **Measured** — the allocator's ``memory_stats`` on a card, else the
  tensors the Runner holds (the CPU), sampled at phase boundaries and on
  the runner's flush cadence — never per step.  Predicted-vs-measured
  is reconciled with the residual *surfaced* and the worst-offender class fed to
  per-term tuner calibration under a ``mem:`` context.
* **Forensics** — the summary says whether the predicted peak fits
  ``capacity x AUTODIST_MEM_HEADROOM``; :func:`check_feasible` refuses a
  serving bucket that does not (``InfeasibleMemoryError``, raised by the
  serve and decode engines before any placement or capture; the tuner's
  search that also calls it in the JAX package is ROADMAP.md A12); a real
  device OOM at capture/dispatch produces an ``oom``
  flight event plus ``logs/oom_report.json`` naming the dominant class,
  the largest live buffers, and the nearest feasible knob.

Contract: same as every ledger here — cold-path only, fail-open, and
with ``AUTODIST_TELEMETRY=0`` the step loop makes ZERO memory calls
(no ``memory_stats``, no samples, no sidecar — test-pinned).
"""
import contextlib
import json
import os

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

#: The ledger classes, in report stacking order (mirrors
#: ``cost_model.MemoryBreakdown.CLASSES``; kept literal here so the
#: observability layer never needs the tuner import just to render).
CLASSES = ("params_bytes", "optimizer_bytes", "gradients_bytes",
           "sync_state_bytes", "activations_bytes", "staging_bytes",
           "kv_cache_bytes")

#: Classes resident between dispatches — what a boundary sample of
#: ``memory_stats`` or the held tensors can actually see.  Gradients,
#: activations, and staging are transient *within* a step: they exist
#: at the in-step peak but are dead by the time the host samples, so
#: reconciliation compares measured bytes against the resident subset.
RESIDENT_CLASSES = ("params_bytes", "optimizer_bytes", "sync_state_bytes",
                    "kv_cache_bytes")

_GB = float(1 << 30)
_MAX_SAMPLES = 64

_last_summary = None
_last_oom_report = None


class InfeasibleMemoryError(MemoryError):
    """A bucket whose predicted peak memory exceeds ``capacity x
    AUTODIST_MEM_HEADROOM``, refused *before* any placement or capture —
    the named failure the serve engines' bucket check raises instead of
    an out-of-memory error inside a CUDA graph capture."""


# ---------------------------------------------------------------------------
# capacity + feasibility + fallback

def headroom():
    """Fraction of HBM capacity a predicted peak may use and still count
    as feasible (``AUTODIST_MEM_HEADROOM``, default 0.9 — the
    slack covers workspaces and fragmentation the ledger cannot see)."""
    try:
        h = float(const.ENV.AUTODIST_MEM_HEADROOM.val)
    except Exception:  # noqa: BLE001 - a garbled knob falls to the default
        h = 0.9
    return h if h > 0 else 0.9


def check_feasible(breakdown, capacity_bytes=None):
    """Refusal reason for an infeasible breakdown, ``None`` when it fits
    (or when nothing can be said: no breakdown / no known capacity —
    the check is fail-open, it must never invent refusals). Capacity:
    ``capacity_bytes``, else the breakdown's own, else
    ``goodput.peak_hbm_bytes_per_device()``."""
    if breakdown is None:
        return None
    cap = float(capacity_bytes or breakdown.get("capacity_bytes") or 0.0)
    if cap <= 0:
        try:
            from autodist_tpu_torch.observability import goodput
            cap = float(goodput.peak_hbm_bytes_per_device())
        except Exception:  # noqa: BLE001 - unknown capacity: cannot refuse
            return None
    if cap <= 0:
        return None
    peak = float(getattr(breakdown, "peak_bytes", 0.0) or
                 sum(breakdown.get(c, 0.0) for c in CLASSES))
    limit = cap * headroom()
    if peak <= limit:
        return None
    return (f"memory: predicted {peak / _GB:.4g}GiB > "
            f"{limit / _GB:.4g}GiB ({headroom():.0%} of "
            f"{cap / _GB:.4g}GiB HBM)")


def suggest_fallback(breakdown, knobs=None):
    """Nearest feasible knob for an over-capacity breakdown: what the
    OOM report (and a human reading it at 3am) should try first, keyed
    off the dominant ledger class.  Returns ``{"knob", "value", "why"}``.
    """
    knobs = dict(knobs or {})
    dom = max(CLASSES, key=lambda c: float(breakdown.get(c, 0.0) or 0.0)) \
        if breakdown else "params_bytes"
    unroll = int(breakdown.get("unroll", knobs.get("unroll", 1)) or 1) \
        if breakdown else int(knobs.get("unroll", 1) or 1)
    if dom == "staging_bytes":
        if unroll > 1:
            return {"knob": "unroll", "value": max(1, unroll // 2),
                    "why": "input staging stacks one batch per fused "
                           "step; halving the unroll halves it"}
        depth = max(0, int(const.ENV.AUTODIST_PREFETCH_DEPTH.val))
        if depth > 0:
            # The JAX package caps the fusion bucket here
            # (AUTODIST_AR_BUCKET_MB); the port's buckets are whole
            # fusion groups, so the prefetch queue is the staging knob.
            return {"knob": "prefetch_depth", "value": depth // 2,
                    "why": "the prefetcher stages (1 + depth) batches "
                           "ahead; a shallower queue stages fewer"}
        return {"knob": "batch_size", "value": "halve the per-device batch",
                "why": "input staging scales with the per-device batch "
                       "rows"}
    if dom == "activations_bytes":
        mb = int(breakdown.get("microbatches", 0) or 0) if breakdown else 0
        if mb:
            return {"knob": "microbatches", "value": mb * 2,
                    "why": "finer microbatches shrink each in-flight "
                           "activation slab (trade against bubble)"}
        return {"knob": "batch_size", "value": "halve the per-device batch",
                "why": "the live activation set scales with the "
                       "per-device batch rows"}
    # params / optimizer / gradients / sync-state dominant: the state is
    # replicated — a sharded-state family divides it by the data axis.
    return {"knob": "strategy_family", "value": "zero1 (PS) or fsdp "
            "(PartitionedAR): sharded optimizer state",
            "why": f"{dom} dominates and is replicated per device; "
                   "sharding state/gradients divides it by the data axis"}


# ---------------------------------------------------------------------------
# predicted

def predicted_for_runner(runner, unroll=1):
    """Predicted :class:`~autodist_tpu_torch.tuner.cost_model.
    MemoryBreakdown` for one Runner's program: fail-open (``None`` when
    the program cannot be priced; the ledger then reports measured-only).
    The activation class is the port's ``GraphItem.activation_live_bytes``
    (aten outputs of one forward on ``meta`` tensors, the attention as its
    plain version runs), not the JAX package's jaxpr count."""
    try:
        from autodist_tpu_torch.tuner import cost_model as cm
        prog = runner.program
        topo = cm.Topology.for_mesh(prog.mesh)
        from autodist_tpu_torch.kernel import overlap as overlap_mod
        return cm.CostModel(topo).strategy_memory(
            prog.strategy, prog.graph_item, unroll=max(1, int(unroll)),
            bucket_bytes=overlap_mod.bucket_bytes_cap())
    except Exception as e:  # noqa: BLE001 - the ledger must never kill a run
        logging.debug("memory: predicted breakdown unavailable: %s", e)
        return None


# ---------------------------------------------------------------------------
# measured

def _median(values):
    vals = sorted(values)
    n = len(vals)
    if not n:
        return 0.0
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def _unique_bytes(tensors):
    """Bytes of the distinct storages behind ``tensors`` (a view, or a
    tensor listed twice, counts once)."""
    import torch
    seen, total, n = set(), 0.0, 0
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            continue
        n += 1
        try:
            st = t.untyped_storage()
            key = (t.device.type, st.data_ptr())
            nbytes = st.nbytes()
        except Exception:  # noqa: BLE001 - odd tensors: their own bytes
            key, nbytes = id(t), t.numel() * t.element_size()
        if key in seen:
            continue
        seen.add(key)
        total += float(nbytes)
    return total, n


def measured_sample(device=None, held=None):
    """One measured device-memory sample.

    On a CUDA device, the caching allocator's own counts
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
    ``.peak``), the counterpart of the JAX package's
    ``device.memory_stats()``. Elsewhere (the CPU), the bytes of the
    tensors ``held()`` yields (the Runner's state, its graphs' static
    buffers and the prefetcher's in-flight batches; each storage once),
    the counterpart of its ``jax.live_arrays()`` walk. One process drives
    one device, so the worst and the typical device are the same one.
    Returns ``None`` when nothing can be measured."""
    try:
        import torch
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        if device is not None and torch.device(device).type == "cuda":
            stats = torch.cuda.memory_stats(device)
            in_use = float(stats.get("allocated_bytes.all.current", 0))
            peak = float(stats.get("allocated_bytes.all.peak", in_use))
            return {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
                    "typical_bytes_in_use": in_use,
                    "source": "memory_stats", "n_live": None}
        if held is None:
            return None
        total, n = _unique_bytes(held())
        return {"bytes_in_use": total, "peak_bytes_in_use": total,
                "typical_bytes_in_use": total,
                "source": "held_tensors", "n_live": n}
    except Exception as e:  # noqa: BLE001 - measurement is best-effort
        logging.debug("memory: sample unavailable: %s", e)
        return None


def top_live_buffers(limit=10, held=None):
    """The largest live buffers (OOM forensics: what is holding the
    memory), descending by bytes: the caching allocator's active blocks
    from ``torch.cuda.memory_snapshot()`` on a card (no shapes: an
    allocator block has none), else the tensors ``held()`` yields."""
    out = []
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            blocks = []
            for seg in torch.cuda.memory_snapshot():
                for blk in seg.get("blocks", ()):
                    if blk.get("state") == "active_allocated":
                        blocks.append(int(blk.get("size", 0)))
            for nbytes in sorted(blocks, reverse=True)[:max(1, int(limit))]:
                out.append({"shape": [], "dtype": "allocator-block",
                            "nbytes": nbytes})
            return out
        if held is not None:
            ts = [t for t in held() if isinstance(t, torch.Tensor)]
            ts.sort(key=lambda t: -(t.numel() * t.element_size()))
            for t in ts[:max(1, int(limit))]:
                out.append({"shape": list(t.shape), "dtype": str(t.dtype),
                            "nbytes": int(t.numel() * t.element_size())})
    except Exception as e:  # noqa: BLE001 - forensics degrade, never raise
        logging.debug("memory: live-buffer walk failed: %s", e)
    return out


# ---------------------------------------------------------------------------
# the ledger

class MemoryLedger:
    """Per-run accumulator reconciling the predicted breakdown against
    boundary-sampled measurements.  Constructed only when telemetry is
    on; :meth:`sample` runs on the flush cadence (cold path), never in
    the step loop."""

    def __init__(self, predicted=None, unroll=1, resident_copies=1,
                 held=None):
        self.predicted = predicted  # MemoryBreakdown | None
        # () -> the tensors the loop holds: what a sample counts off the
        # card (measured_sample).
        self.held = held
        self.unroll = max(1, int(unroll))
        # How many live copies of the resident state the LOOP holds: 2
        # when a StepGuard keeps an on-device last-good rollback copy
        # (guard.mark_good), 1 otherwise.  A loop artifact, not a
        # strategy property — so it scales the reconciliation basis,
        # never the candidate's predicted classes.
        self.resident_copies = max(1, int(resident_copies))
        self._samples = []
        self._peak = 0.0
        self._typical = 0.0
        self._peak_sample = None

    def sample(self, tag=""):
        """Fold one measured sample (tagged with the phase/boundary that
        took it); tracks the running measured peak (worst device) and
        the running typical peak (median device — the reconciliation
        basis, see :func:`measured_sample`)."""
        s = measured_sample(held=self.held)
        if s is None:
            return None
        s = dict(s, tag=str(tag))
        if len(self._samples) < _MAX_SAMPLES:
            self._samples.append(s)
        if s["peak_bytes_in_use"] >= self._peak:
            self._peak = s["peak_bytes_in_use"]
            self._peak_sample = s
        self._typical = max(self._typical,
                            float(s.get("typical_bytes_in_use") or
                                  s["peak_bytes_in_use"]))
        return s

    def summary(self):
        """Predicted classes + measured peak + the reconciliation.

        The residual (measured minus predicted-resident) is surfaced,
        never absorbed: a boundary sample sees only the RESIDENT classes
        (params/optimizer/sync-state — gradients, activations, and
        staging are dead between dispatches), so that subset is the
        reconciliation basis and ``prediction_error_pct`` its relative
        error.  Empty dict when there is nothing to report.
        """
        out = {}
        pred = self.predicted
        if pred is not None:
            classes = {c: float(pred.get(c, 0.0) or 0.0) for c in CLASSES}
            peak = sum(classes.values())
            resident = sum(classes[c] for c in RESIDENT_CLASSES)
            cap = float(pred.get("capacity_bytes") or 0.0)
            out.update({
                "predicted": classes,
                "predicted_peak_bytes": peak,
                "predicted_peak_gb": round(peak / _GB, 6),
                "predicted_resident_bytes": resident,
                "dominant_class": max(CLASSES, key=classes.get),
                "unroll": int(pred.get("unroll", self.unroll) or
                              self.unroll),
            })
            if cap > 0:
                out.update({
                    "capacity_bytes": cap,
                    "capacity_gb": round(cap / _GB, 6),
                    "headroom": headroom(),
                    "feasible": peak <= cap * headroom(),
                })
        if self._peak_sample is not None:
            basis = float(self._typical or self._peak)
            out.update({
                "measured_peak_bytes": float(self._peak),
                "measured_peak_gb": round(self._peak / _GB, 6),
                "measured_typical_bytes": basis,
                "measured_typical_gb": round(basis / _GB, 6),
                "measured_source": self._peak_sample.get("source"),
                "samples": len(self._samples),
            })
            resident = out.get("predicted_resident_bytes", 0.0) * \
                self.resident_copies
            if resident > 0:
                # Reconcile against the MEDIAN device: the worst device
                # also carries host-staged arrays the per-device
                # prediction deliberately excludes (CPU rig artifact).
                # ``resident`` is scaled by the loop's live state copies
                # (the guard's rollback snapshot doubles it).
                out["resident_copies"] = self.resident_copies
                out["reconciliation_basis_bytes"] = resident
                out["residual_bytes"] = basis - resident
                out["prediction_error_pct"] = round(
                    100.0 * (basis - resident) / resident, 2)
        elif out:
            out["samples"] = len(self._samples)
        if not out:
            return {}
        out.setdefault("unroll", self.unroll)
        return out


def feed_calibration(summary, calibration=None, path=None):
    """Close the measured-vs-predicted loop: the worst-offender resident
    class (the one carrying most of the predicted resident bytes) is
    folded into per-term calibration under a ``mem:`` context, so the
    tuner learns which *memory* term drifts — separate from the time
    terms attribution feeds. Into ``calibration``, else into the file at
    ``path`` (the default one when None) under its lock."""
    if not summary:
        return None
    try:
        resident = float(summary.get("reconciliation_basis_bytes") or
                         summary.get("predicted_resident_bytes") or 0.0)
        measured = float(summary.get("measured_typical_bytes") or
                         summary.get("measured_peak_bytes") or 0.0)
        if resident <= 0 or measured <= 0:
            return None
        pred = summary.get("predicted") or {}
        worst = max(RESIDENT_CLASSES,
                    key=lambda c: float(pred.get(c, 0.0) or 0.0))
        with contextlib.ExitStack() as stack:
            if calibration is None:
                from autodist_tpu_torch.tuner.calibration import Calibration
                calibration = stack.enter_context(Calibration.locked(path))
            calibration.observe_term(f"mem:{worst}", resident, measured,
                                     context="memory")
        return calibration
    except Exception as e:  # noqa: BLE001 - calibration is best-effort
        logging.debug("memory calibration feed failed: %s", e)
        return None


# ---------------------------------------------------------------------------
# OOM forensics

def is_oom(exc):
    """Whether an exception is a device out-of-memory: a
    ``torch.OutOfMemoryError``, or an error whose text carries the CUDA
    allocator's "CUDA out of memory" (or XLA's RESOURCE_EXHAUSTED, where
    the JAX package matches)."""
    try:
        import torch
        if isinstance(exc, torch.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    text = f"{type(exc).__name__}: {exc}"
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower()


def oom_report(exc, predicted=None, context="", knobs=None, held=None):
    """OOM post-mortem: write ``logs/oom_report.json`` with the full
    predicted breakdown, the largest live buffers, and the nearest
    feasible knob, and drop an ``oom`` flight event.  Returns
    ``(report, path)`` — re-raising the exception is the caller's job
    (forensics never swallow the failure)."""
    global _last_oom_report
    report = {"error": str(exc)[:2000], "context": str(context)}
    try:
        if predicted is not None:
            classes = {c: float(predicted.get(c, 0.0) or 0.0)
                       for c in CLASSES}
            peak = sum(classes.values())
            report.update({
                "predicted": classes,
                "predicted_peak_gb": round(peak / _GB, 6),
                "dominant_class": max(CLASSES, key=classes.get),
            })
            cap = float(predicted.get("capacity_bytes") or 0.0)
            if cap > 0:
                report["capacity_gb"] = round(cap / _GB, 6)
            report["suggestion"] = suggest_fallback(predicted, knobs)
        elif knobs:
            report["suggestion"] = suggest_fallback(None, knobs)
        report["top_live_buffers"] = top_live_buffers(held=held)
    except Exception as e:  # noqa: BLE001 - a partial report still ships
        logging.debug("memory: oom report assembly degraded: %s", e)
    path = None
    try:
        const.ensure_working_dirs()
        path = os.path.join(const.DEFAULT_LOG_DIR, "oom_report.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    except OSError as e:
        logging.debug("memory: oom report not written: %s", e)
        path = None
    try:
        from autodist_tpu_torch.observability import recorder
        sug = report.get("suggestion") or {}
        hint = (f"; try {sug.get('knob')}={sug.get('value')}"
                if sug else "")
        recorder.record(
            "oom",
            f"device OOM in {context or 'dispatch'}: dominant class "
            f"{report.get('dominant_class', 'unknown')}{hint}")
    except Exception:  # noqa: BLE001 - telemetry must never kill a run
        pass
    _last_oom_report = report
    return report, path


def last_oom_report():
    """The most recent OOM report assembled in this process."""
    return _last_oom_report


# ---------------------------------------------------------------------------
# finalize (the one cold-path entry the step loops call)

def finalize(ledger, registry=None, calibration_path=None):
    """End-of-run bookkeeping: publish the ``mem.*`` gauges, stash the
    summary for cluster snapshots / report / monitor / bench, feed the
    ``mem:`` calibration terms (the file at ``calibration_path``: the
    program's, from the Runner), write the ``memory.json`` sidecar under
    ``AUTODIST_DUMP_GRAPHS``, and drop a ``memory`` flight event.
    Callers gate on telemetry — with ``AUTODIST_TELEMETRY=0`` this is
    never reached (test-pinned)."""
    if ledger is None:
        return None
    summary = ledger.summary()
    if not summary:
        return None
    if registry is not None:
        pred = summary.get("predicted") or {}
        if pred:
            registry.gauge("mem.params_gb").set(
                round(pred.get("params_bytes", 0.0) / _GB, 6))
            registry.gauge("mem.optimizer_gb").set(
                round(pred.get("optimizer_bytes", 0.0) / _GB, 6))
            registry.gauge("mem.gradients_gb").set(
                round(pred.get("gradients_bytes", 0.0) / _GB, 6))
            registry.gauge("mem.sync_state_gb").set(
                round(pred.get("sync_state_bytes", 0.0) / _GB, 6))
            registry.gauge("mem.activations_gb").set(
                round(pred.get("activations_bytes", 0.0) / _GB, 6))
            registry.gauge("mem.staging_gb").set(
                round(pred.get("staging_bytes", 0.0) / _GB, 6))
            registry.gauge("mem.predicted_peak_gb").set(
                summary["predicted_peak_gb"])
        if "capacity_gb" in summary:
            registry.gauge("mem.capacity_gb").set(summary["capacity_gb"])
        if "measured_peak_gb" in summary:
            registry.gauge("mem.measured_peak_gb").set(
                summary["measured_peak_gb"])
        if "prediction_error_pct" in summary:
            registry.gauge("mem.prediction_error_pct").set(
                summary["prediction_error_pct"])
    set_last_summary(summary)
    feed_calibration(summary, path=calibration_path)
    if const.ENV.AUTODIST_DUMP_GRAPHS.val:
        try:
            const.ensure_working_dirs()
            path = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR, "memory.json")
            with open(path, "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
        except OSError as e:
            logging.debug("memory sidecar not written: %s", e)
    try:
        from autodist_tpu_torch.observability import recorder
        measured = (f", measured {summary['measured_peak_gb']:.3f}GiB "
                    f"({summary.get('measured_source')})"
                    if "measured_peak_gb" in summary else "")
        cap = (f" of {summary['capacity_gb']:.1f}GiB capacity"
               if "capacity_gb" in summary else "")
        recorder.record(
            "memory",
            f"predicted peak {summary.get('predicted_peak_gb', 0.0):.3f}"
            f"GiB (dominant {summary.get('dominant_class', 'n/a')})"
            f"{measured}{cap}")
    except Exception:  # noqa: BLE001 - telemetry must never kill a run
        pass
    return summary


def last_summary():
    """The most recent finalized memory summary in this process
    (``None`` before the first observed step loop)."""
    return _last_summary


def set_last_summary(summary):
    global _last_summary
    _last_summary = summary


def reset():
    """Test harness hook."""
    global _last_oom_report
    set_last_summary(None)
    _last_oom_report = None
