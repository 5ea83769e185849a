"""Goodput & MFU ledger: run-level accounting that survives re-exec.

Counterpart of ``autodist_tpu/observability/goodput.py``. The peak tables
are the JAX package's (they list the H100 at 989 TFLOP/s dense bf16 and
80 GiB); a device's row is found by ``torch.cuda.get_device_name``.

The attribution ledger explains where a *step* goes; this module accounts
for the *run*: what fraction of total wall-clock was productive training
(**goodput**) versus enumerated **badput** classes::

    wall = goodput + startup + compile + restore + reshard
         + checkpoint_save + emergency_save + rollback + retune_switch
         + reexec_gap + data_wait + other

* ``goodput_ms`` — productive step time: the billed step wall-clock
  minus measured data-wait, minus any compile work that ran *inside* a
  step-loop span, and minus the part of each save that overlapped the
  loop's billed dispatch windows (those are billed into step latency but
  are not training). The JAX package subtracts every save inside the
  step-loop span: a save after the loop's last dispatch, and the
  asynchronous writer's final wait (``checkpoint-wait``), were never
  billed, so that arithmetic took them off twice;
* ``startup_ms`` — capture + strategy build/ship + transform +
  distributed init (the cost of getting to the first step);
* ``compile_ms`` — jit + AOT (+ serving bucket) compiles;
* ``restore_ms`` / ``reshard_ms`` — checkpoint restore, with the
  cross-shape (elastic) reshard carved out as its own class
  (``checkpoint.reshard_ms`` gauge);
* ``checkpoint_save_ms`` / ``emergency_save_ms`` — periodic saves vs
  drain-path saves (preemption, worker death, elastic re-form);
* ``rollback_ms`` — StepGuard rollback + replayed (unbilled) dispatches:
  step-loop span time the step histogram never billed;
* ``retune_switch_ms`` — online re-tuning switch downtime
  (docs/retuning.md): the in-place re-lower/re-compile/reshard plus the
  re-lowered program's first dispatch, so the controller's own cost is
  visible as a priced bar;
* ``selfheal_ms`` — a reshape-around-degrade episode's full downtime
  (docs/retuning.md): when a generation ended because the self-healing
  controller evicted a degraded host (``end_reason == "selfheal"``),
  the stitcher reclassifies that generation's drain (emergency save)
  AND the re-exec gap after it under this one class, so the episode
  reads as a single priced bar instead of smearing across
  ``emergency_save_ms``/``reexec_gap_ms``;
* ``reexec_gap_ms`` — dead time between elastic re-exec generations
  (priced only by the JAX package's cross-generation stitcher, which
  comes to the port with elastic re-exec: 0 in one segment);
* ``data_wait_ms`` — host time blocked on the input pipeline;
* ``other_ms`` — the remainder (imports, idle, python overhead),
  **surfaced, never absorbed**: the classes sum to the measured process
  wall-clock exactly, the same residual discipline as the attribution
  ledger.

**MFU / HFU** come from ``GraphItem.flops_estimate``: model flops per
step = 3x the forward estimate (fwd + bwd), against a per-backend
peak-flops table (``AUTODIST_PEAK_TFLOPS`` overrides unknown parts).
``mfu`` is run-level (model flops over peak x total wall-clock — badput
drags it down, which is the point); ``hfu`` is the same ratio over
productive step time only (what the hardware achieves while actually
stepping).  ``note_mfu`` feeds the tuner calibration as a sanity input
(an MFU > 1 means the peak table or the flops estimate is wrong).

**Segments** (docs/goodput.md): every chief process persists a goodput
*segment* next to its flight-recorder log
(``logs/goodput_<run>_g<generation>.json``), keyed by the run id
(``AUTODIST_RUN_ID``, minted by the chief) and the generation index
(``AUTODIST_RUN_GENERATION``). The JAX package's ``stitch_run`` /
``priced_downtime`` / ``reexec_env``, which read them across elastic
re-exec generations, come with their callers (ROADMAP.md, A5 + A9 and
A12).

Cost discipline: everything here runs on the cold finalize path (once
per ``Runner.run`` / ``CheckpointManager.run``); with
``AUTODIST_TELEMETRY=0`` no goodput call is ever made, no gauge set, and
no segment file written (spy-pinned contract test).
"""
import bisect
import glob
import itertools
import json
import os
import re
import time

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

#: Badput classes, in render order (report / monitor / bench reuse this).
#: ``goodput_ms`` + these sum to the segment's wall-clock exactly.
BADPUT_CLASSES = (
    "startup_ms", "compile_ms", "restore_ms", "reshard_ms",
    "checkpoint_save_ms", "emergency_save_ms", "rollback_ms",
    "retune_switch_ms", "selfheal_ms", "reexec_gap_ms", "data_wait_ms",
    "other_ms",
)

#: Which badput class each flight-recorder event type marks (``None`` =
#: the event prices no wall-clock).  Totality against
#: ``recorder.EVENT_TYPES`` is lint-pinned (tests/test_event_docs.py) so
#: a new event type cannot silently fall outside the taxonomy.
EVENT_CLASS = {
    "anchors-skipped": None,
    "anomaly": None,
    "attribution": None,
    "automap": None,
    "chaos:ckpt-truncate": None,
    "chaos:kill": "reexec_gap_ms",
    "chaos:kv-delay": "startup_ms",
    "chaos:nan": "rollback_ms",
    "chaos:oom": None,
    "chaos:slow-host": None,
    "checkpoint-restore": "restore_ms",
    "checkpoint-save": "checkpoint_save_ms",
    "ckpt-fallback": "restore_ms",
    "compile": "compile_ms",
    "divergence-abort": "rollback_ms",
    "emergency-save": "emergency_save_ms",
    "goodput": None,
    "mesh-built": "startup_ms",
    "memory": None,
    "monitor-start": None,
    "oom": None,
    "pipeline": None,
    "preemption": "emergency_save_ms",
    "profile": None,
    "re-form": "reexec_gap_ms",
    "re-form-request": "reexec_gap_ms",
    "reshard": "reshard_ms",
    "retry": None,
    "retune": "retune_switch_ms",
    "rollback": "rollback_ms",
    "selfheal": "selfheal_ms",
    "serve-compile": "compile_ms",
    "serve-scale": "reshard_ms",
    "serve-start": None,
    "serve-stop": None,
    "spec-shrink": "reexec_gap_ms",
    "straggler": None,
    "strategy-ship": "startup_ms",
    "transform": "startup_ms",
    "tuner": "startup_ms",
    "worker-death": "reexec_gap_ms",
    "worker-launch": "startup_ms",
    "worker-restart": "reexec_gap_ms",
}

# Phase-span -> class membership (tracing.phase_summary names).
_STARTUP_PHASES = ("capture", "strategy-build", "strategy-ship",
                   "transform", "distributed-init")
_COMPILE_PHASES = ("compile", "aot-compile", "serve-aot-compile")

#: Per-device peak TFLOP/s by device-kind substring (bf16/dense), checked
#: in order; the platform defaults catch unknown parts.  Override with
#: ``AUTODIST_PEAK_TFLOPS`` (docs/goodput.md has the table).
PEAK_TFLOPS_TABLE = (
    ("h100", 989.0), ("a100", 312.0), ("v100", 125.0),
)
PLATFORM_DEFAULT_TFLOPS = {"gpu": 312.0, "cpu": 0.05}

#: Per-device HBM capacity (GiB) by device-kind substring, same lookup
#: shape as :data:`PEAK_TFLOPS_TABLE`; the memory ledger's summary prices
#: the predicted peak against it (``AUTODIST_HBM_GB`` override, spec
#: ``memory:`` block — docs/memory.md).  The CPU "device" default is the
#: host-RAM ballpark a forced-device CPU test mesh actually has, so the
#: CPU container never prunes candidates by accident.
PEAK_HBM_GB_TABLE = (
    ("h100", 80.0), ("a100", 40.0), ("v100", 16.0),
)
PLATFORM_DEFAULT_HBM_GB = {"gpu": 40.0, "cpu": 64.0}

_process_start = time.time()
_last_summary = None
_run_id = None
# Program facts cached by the last collect(runner=...) so a runner-less
# persist (Coordinator.reform_now on the supervision thread) can still
# price MFU for the dying generation.
_cached = {"flops_per_step": None, "devices": None, "peak_per_device": None}


# ---------------------------------------------------------------------------
# run identity

def run_id():
    """The run's identity, stable across elastic re-exec generations:
    ``AUTODIST_RUN_ID`` when the launcher/previous generation set it,
    else minted once per process (the chief mints; workers and re-exec'd
    generations inherit it through the env contract)."""
    global _run_id
    env = const.ENV.AUTODIST_RUN_ID.val
    if env:
        return str(env)
    if _run_id is None:
        _run_id = f"run{int(_process_start)}p{os.getpid()}"
    return _run_id


def generation():
    """This process's generation index within the run (0 = the original
    incarnation; ``Coordinator.reform_now`` bumps it per re-exec)."""
    return max(0, int(const.ENV.AUTODIST_RUN_GENERATION.val))


# ---------------------------------------------------------------------------
# peak flops

def device_kind(device=None):
    """``(kind, platform)`` of a device: ``torch.cuda.get_device_name``
    lowercased and ``"gpu"`` for a CUDA device (the current one when
    ``device`` is None and CUDA is up), else ``("", "cpu")``. The
    counterpart of the JAX package's ``device.device_kind`` /
    ``device.platform``."""
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                return "", "cpu"
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type == "cuda":
            return torch.cuda.get_device_name(device).lower(), "gpu"
    except Exception:  # noqa: BLE001 - pre-init: fall to the CPU default
        pass
    return "", "cpu"


def peak_flops_per_device(device=None):
    """Peak FLOP/s of one device: the ``AUTODIST_PEAK_TFLOPS`` override
    when set, else the built-in table keyed by the device's name
    (``torch.cuda.get_device_name``), else its platform's default."""
    override = const.ENV.AUTODIST_PEAK_TFLOPS.val
    if override and override > 0:
        return float(override) * 1e12
    kind, platform = device_kind(device)
    for needle, tflops in PEAK_TFLOPS_TABLE:
        if needle in kind:
            return tflops * 1e12
    return PLATFORM_DEFAULT_TFLOPS.get(platform,
                                       PLATFORM_DEFAULT_TFLOPS["cpu"]) * 1e12


def peak_hbm_bytes_per_device(device=None):
    """HBM capacity of one device in bytes: the ``AUTODIST_HBM_GB``
    override when set, else the built-in table keyed by the device's name,
    else its platform's default (the same resolution as
    :func:`peak_flops_per_device`)."""
    override = const.ENV.AUTODIST_HBM_GB.val
    if override and override > 0:
        return float(override) * (1 << 30)
    kind, platform = device_kind(device)
    for needle, gb in PEAK_HBM_GB_TABLE:
        if needle in kind:
            return gb * (1 << 30)
    return PLATFORM_DEFAULT_HBM_GB.get(
        platform, PLATFORM_DEFAULT_HBM_GB["cpu"]) * (1 << 30)


# ---------------------------------------------------------------------------
# classification

class _Spans:
    """The complete spans of one name, sorted by start, for the overlap of
    an interval with the most-overlapping of them. A process's ring holds
    one ``step-loop`` span a loop, so the JAX package's scan of every span
    for every event grows with the square of the run's history; this
    visits only the spans that start before the interval ends, from the
    latest back while an earlier one can still reach it (the same
    arithmetic, so the same floats)."""

    def __init__(self, events, name):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("name") == name)
        self.starts = [a for a, _ in spans]
        self.spans = spans
        self.reach = list(itertools.accumulate((b for _, b in spans), max))

    def __bool__(self):
        return bool(self.spans)

    def covered(self, s, d):
        """Max overlap (us) of [s, s + d] with one of the spans."""
        covered = 0.0
        j = bisect.bisect_left(self.starts, s + d) - 1
        while j >= 0 and self.reach[j] > s:
            ls, le = self.spans[j]
            covered = max(covered, max(0.0, min(le, s + d) - max(ls, s)))
            j -= 1
        return covered


def _contained_in_loop_ms(events):
    """Per-phase span time scheduled INSIDE a step-loop span (us ring ->
    ms totals).  Those durations are billed into step latency (the first
    step's capture, a mid-loop save) but are not training — goodput
    subtracts them; their own class keeps the full total."""
    loops = _Spans(events, "step-loop")
    out = {}
    if not loops:
        return out
    for e in events:
        if e.get("ph") != "X" or e.get("name") == "step-loop":
            continue
        covered = loops.covered(e.get("ts", 0.0), e.get("dur", 0.0))
        if covered > 0:
            out[e["name"]] = out.get(e["name"], 0.0) + covered / 1e3
    return out


def _phase_total(phases, names):
    return sum((phases.get(n) or {}).get("total_ms", 0.0) for n in names)


def _contained_named_ms(events, outer_name, inner_names):
    """Span time of ``inner_names`` scheduled inside an ``outer_name``
    span (ms).  Used to keep nested spans out of double-charging: the
    retune-switch span wraps the re-lowered program's compile, which
    must then leave the generic compile class."""
    outers = _Spans(events, outer_name)
    if not outers:
        return 0.0
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("name") not in inner_names:
            continue
        total += outers.covered(e.get("ts", 0.0), e.get("dur", 0.0)) / 1e3
    return total


def collect(runner=None, now=None):
    """Build this process's goodput segment from lifetime telemetry
    state (metrics registry + phase spans) — a pure read, no gauges set,
    no files written.  ``runner`` (when given) prices MFU from the
    captured program; without one the last cached program facts apply.
    """
    from autodist_tpu_torch.observability import metrics, tracing
    now = time.time() if now is None else now
    wall_ms = max(0.0, (now - _process_start) * 1e3)
    snap = metrics.registry().snapshot()
    gauges = snap.get("gauges") or {}
    counters = snap.get("counters") or {}
    hists = snap.get("histograms") or {}
    phases = tracing.phase_summary()

    # Billed step time: the latency histogram observes per-dispatch/K, so
    # lifetime total x (steps / dispatches) recovers the full wall the
    # loop billed to steps (incl. data-wait and in-loop compiles).
    lat = hists.get("step.latency_ms") or {}
    dispatches = int(lat.get("count") or 0)
    steps = int(counters.get("step.count") or 0) or dispatches
    step_wall = (lat.get("total", 0.0) * (steps / dispatches)
                 if dispatches else 0.0)
    data_wait = (hists.get("step.data_wait_ms") or {}).get("total", 0.0)

    events = tracing.events()
    inside = _contained_in_loop_ms(events)
    # Emergency saves nest a checkpoint-save span; count the outer one.
    inside_saves = max(inside.get("checkpoint-save", 0.0),
                       inside.get("emergency-save", 0.0))
    # A save leaves the billed step time only where it overlapped the
    # loops' billed dispatch windows (``step-dispatches``, recorded by
    # ``runner.DispatchClock``): its stall. A save after a loop's last
    # dispatch, and the writer's final wait, were never billed as steps
    # (the JAX package subtracts every in-loop save). Without windows the
    # step-loop spans stand in, as in the JAX package.
    billed_saves = inside_saves
    if _Spans(events, "step-dispatches"):
        billed_saves = max(
            _contained_named_ms(events, "step-dispatches", (name,))
            for name in ("checkpoint-save", "emergency-save"))
    # Retune switch downtime (docs/retuning.md): the retune-switch spans
    # wrap the re-lowered program's own compile span, so the nested
    # compile time stays with the retune class and leaves the generic
    # compile class (no double charge).
    retune_ms = _phase_total(phases, ("retune-switch",))
    compile_in_retune = min(
        retune_ms,
        _contained_named_ms(events, "retune-switch",
                            ("compile", "aot-compile"))) if retune_ms \
        else 0.0
    inside_nonstep = (inside.get("compile", 0.0)
                      + inside.get("aot-compile", 0.0) + billed_saves
                      + max(0.0, inside.get("retune-switch", 0.0)
                            - compile_in_retune))
    goodput_ms = max(0.0, step_wall - data_wait - inside_nonstep)

    emergency = _phase_total(phases, ("emergency-save",))
    reshard = float(gauges.get("checkpoint.reshard_ms") or 0.0)
    restore_phase = _phase_total(phases, ("restore",))
    reshard = min(reshard, restore_phase) if restore_phase else reshard
    loop_phase = _phase_total(phases, ("step-loop",))
    # Step-loop time the histogram never billed: rolled-back dispatches
    # and the guard's restore work (the restore part keeps its class, and
    # so do the unbilled saves and the writer's final wait).
    rollback = max(0.0, loop_phase - step_wall - inside.get("restore", 0.0)
                   - (inside_saves - billed_saves)
                   - inside.get("checkpoint-wait", 0.0))

    classes = {
        "startup_ms": _phase_total(phases, _STARTUP_PHASES),
        "compile_ms": max(0.0, _phase_total(phases, _COMPILE_PHASES)
                          - compile_in_retune),
        "restore_ms": max(0.0, restore_phase - reshard),
        "reshard_ms": reshard,
        "checkpoint_save_ms": max(
            0.0, _phase_total(phases, ("checkpoint-save", "checkpoint-wait"))
            - emergency),
        "emergency_save_ms": emergency,
        "rollback_ms": rollback,
        "retune_switch_ms": retune_ms,
        "selfheal_ms": 0.0,    # priced by the cross-generation stitcher
        "reexec_gap_ms": 0.0,  # priced by the cross-generation stitcher
        "data_wait_ms": data_wait,
    }
    classes["other_ms"] = wall_ms - goodput_ms - sum(classes.values())
    classes = {k: round(v, 3) for k, v in classes.items()}

    # MFU / HFU from the captured program's flops estimate.
    flops_per_step = _cached["flops_per_step"]
    devices = _cached["devices"]
    peak_dev = _cached["peak_per_device"]
    if runner is not None:
        try:
            flops_per_step = 3.0 * float(
                runner.program.graph_item.flops_estimate())
            devices = max(1, int(runner.program.mesh.size))
            peak_dev = peak_flops_per_device(runner.remapper.device)
            _cached.update(flops_per_step=flops_per_step, devices=devices,
                           peak_per_device=peak_dev)
        except Exception as e:  # noqa: BLE001 - MFU degrades, never raises
            logging.debug("goodput: flops estimate unavailable: %s", e)
    if devices is None:
        devices = max(1, tracing.process_count())
    if peak_dev is None:
        peak_dev = peak_flops_per_device()
    peak_total = peak_dev * devices
    model_flops = (flops_per_step * steps
                   if flops_per_step and steps else None)
    mfu = hfu = None
    if model_flops and wall_ms > 0 and peak_total > 0:
        mfu = model_flops / (wall_ms / 1e3 * peak_total)
    if model_flops and goodput_ms > 0 and peak_total > 0:
        hfu = model_flops / (goodput_ms / 1e3 * peak_total)

    summary = {
        "run_id": run_id(),
        "generation": generation(),
        "pid": os.getpid(),
        "start": round(_process_start, 3),
        "end": round(now, 3),
        "wall_ms": round(wall_ms, 3),
        "goodput_ms": round(goodput_ms, 3),
        "goodput_pct": (round(100.0 * goodput_ms / wall_ms, 2)
                        if wall_ms > 0 else None),
        "classes": classes,
        "steps": steps,
        "dispatches": dispatches,
        # Switch count per segment so the stitched ledger can price a
        # MEAN per-switch downtime for the controller's goodput objective.
        "retune_switches": int(counters.get("retune.switches") or 0),
        "flops_per_step": flops_per_step,
        "model_flops": model_flops,
        "devices": devices,
        "peak_tflops_per_device": round(peak_dev / 1e12, 4),
        "peak_flops_total": peak_total,
        "mfu": mfu,
        "hfu": hfu,
    }
    # Goodput further split by the attribution terms (per-step ms,
    # same keys as the step ledger) when a finalized summary exists.
    try:
        from autodist_tpu_torch.observability import attribution
        attr = attribution.last_summary()
        if attr:
            summary["goodput_breakdown"] = {
                k: attr.get(k) for k in attribution.COMPONENTS}
    except Exception:  # noqa: BLE001 - breakdown is optional garnish
        pass
    return summary


# ---------------------------------------------------------------------------
# segment persistence

def _segment_path(run, gen):
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(run))
    return os.path.join(const.DEFAULT_LOG_DIR, f"goodput_{safe}_g{gen}.json")


def persist_segment(summary=None, reason=""):
    """Write (overwrite) this generation's goodput segment next to the
    flight-recorder log — chief-only, fail-open.  Called at finalize and
    by ``Coordinator.reform_now`` right before the re-exec, so the dying
    generation's ``end`` timestamp bounds the re-exec gap."""
    from autodist_tpu_torch.observability import tracing
    if tracing.process_index() != 0:
        return None
    if summary is None:
        summary = collect()
    if reason:
        summary = dict(summary, end_reason=str(reason))
    try:
        const.ensure_working_dirs()
        path = _segment_path(summary["run_id"], summary["generation"])
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError as e:
        logging.debug("goodput segment not persisted: %s", e)
        return None


def segments_for(run=None, log_dir=None):
    """All persisted segments of ``run`` (default: this process's run),
    sorted by (generation, start)."""
    run = run or run_id()
    log_dir = log_dir or const.DEFAULT_LOG_DIR
    out = []
    try:
        for path in glob.glob(os.path.join(log_dir, "goodput_*.json")):
            try:
                with open(path) as f:
                    seg = json.load(f)
            except (OSError, ValueError):
                continue
            if seg.get("run_id") == run:
                out.append(seg)
    except OSError:
        pass
    out.sort(key=lambda s: (s.get("generation", 0), s.get("start", 0.0)))
    return out


# ---------------------------------------------------------------------------
# finalize (the one cold-path entry the step loops call)

def finalize(runner=None, registry=None, unroll=1):
    """End-of-loop bookkeeping: build the segment, publish the
    ``goodput.*`` / ``mfu`` gauges, persist the segment file (chief),
    write the ``goodput.json`` sidecar under ``AUTODIST_DUMP_GRAPHS``,
    feed MFU to the tuner calibration as a sanity input (the file of the
    runner's program at ``unroll``, :func:`~autodist_tpu_torch.tuner.
    calibration.path_for`), and drop a
    flight-recorder event.  Callers gate on telemetry — with
    ``AUTODIST_TELEMETRY=0`` this is never reached (test-pinned)."""
    summary = collect(runner)
    set_last_summary(summary)
    if registry is not None:
        if summary["goodput_pct"] is not None:
            registry.gauge("goodput.pct").set(summary["goodput_pct"])
        registry.gauge("goodput.wall_ms").set(summary["wall_ms"])
        registry.gauge("goodput.goodput_ms").set(summary["goodput_ms"])
        for cls, v in summary["classes"].items():
            registry.gauge(f"goodput.{cls}").set(v)
        if summary["mfu"] is not None:
            registry.gauge("goodput.mfu").set(round(summary["mfu"], 6))
        if summary["hfu"] is not None:
            registry.gauge("goodput.hfu").set(round(summary["hfu"], 6))
        registry.gauge("run.generation").set(summary["generation"])
    persist_segment(summary)
    if const.ENV.AUTODIST_DUMP_GRAPHS.val:
        try:
            const.ensure_working_dirs()
            path = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR, "goodput.json")
            with open(path, "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
        except OSError as e:
            logging.debug("goodput sidecar not written: %s", e)
    try:
        if summary["mfu"] is not None:
            from autodist_tpu_torch.tuner import calibration
            path = (calibration.path_for(runner, unroll)
                    if runner is not None else None)
            with calibration.Calibration.locked(path) as cal:
                cal.note_mfu(summary["mfu"],
                             context=f"goodput run {summary['run_id']} "
                                     f"g{summary['generation']}")
    except Exception as e:  # noqa: BLE001 - calibration is best-effort
        logging.debug("goodput MFU not fed to calibration: %s", e)
    try:
        from autodist_tpu_torch.observability import recorder
        mfu_txt = (f", mfu {summary['mfu']:.5f}"
                   if summary["mfu"] is not None else "")
        recorder.record(
            "goodput",
            f"{summary['goodput_pct'] or 0:.1f}% of "
            f"{summary['wall_ms']:.0f}ms wall productive over "
            f"{summary['steps']} steps (gen {summary['generation']}"
            f"{mfu_txt})")
    except Exception:  # noqa: BLE001 - telemetry must never kill a run
        pass
    return summary


def last_summary():
    """The most recent finalized goodput segment in this process
    (``None`` before the first finalized loop)."""
    return _last_summary


def set_last_summary(summary):
    global _last_summary
    _last_summary = summary


def reset():
    """Test harness hook: forget the minted run id, cached program
    facts, and restart this process's wall clock (simulates a fresh
    generation in-process)."""
    global _last_summary, _run_id, _process_start
    _last_summary = None
    _run_id = None
    _process_start = time.time()
    _cached.update(flops_per_step=None, devices=None, peak_per_device=None)
