"""Per-layer device-time profiler: scope provenance end to end.

Counterpart of ``autodist_tpu/observability/profile.py``. The attribution
ledger reconciles a step into ``device_compute`` / ``exposed_comms`` /
... — but those terms are opaque blobs: a regression in one attention
block reads as "compute got slower". This module splits the two
device-side terms *per model scope*, threading provenance through three
layers:

* **model code** — the zoo's forward blocks run under
  ``utils.scope.named_scope`` (``"layer0/attn"``, ``"stage1/block2"``,
  ...);
* **the captured trace** — :meth:`GraphItem.op_provenance` records aten
  op -> scope -> flops/bytes, and strategy variables join by name prefix
  (``"layer0/attn/query/kernel"`` belongs to ``layer0/attn``): per-scope
  *predicted* compute, comms and wire bytes;
* **the device** — where the JAX package reads the scheduled HLO's
  ``op_name`` metadata, the port reads the ``torch.profiler`` trace that
  ``Runner.run`` records under ``AUTODIST_TRACE=profiler``
  (:func:`trace_scope_costs`): each kernel is followed to the runtime call
  that launched it, and that call to the innermost ``named_scope`` open
  on its thread (``named_scope`` opens a ``record_function`` named
  ``scope:<path>`` in that mode only). A backward kernel runs on
  autograd's thread, where no scope is open: it takes the scope of the
  forward op that made its autograd node, linked by the profiler's
  sequence number. Kernels that link to nothing stay ``(unattributed)``,
  counted; kernels a CUDA graph replays carry no scope at all (the replay
  runs no Python), so they are counted apart, and the measured structure
  comes from the eagerly launched kernels (a captured step's warm-up) or,
  with none, stays the model's. The source is named ``"torch-profiler"``
  where the JAX package names ``"scheduled-hlo"``. On the CPU (no
  kernels) the aten ops' self times stand in for kernels.

Reconciliation closes the loop against the step ledger
(``observability/attribution.py``): per-scope shares are normalized so
per-scope compute sums exactly to the ledger's ``device_compute`` and
per-scope comms to ``exposed_comms`` — anything no scope claims stays in
an explicit ``(unattributed)`` bucket, **surfaced, never absorbed**.
Per-scope measured-vs-predicted deltas feed
:meth:`Calibration.observe_term` as per-class observations.

Cost discipline: everything here runs ONCE per ``Runner.run``, on the
cold finalize path (``AUTODIST_PROFILE``, default on); with
``AUTODIST_TELEMETRY=0`` the step loop makes provably zero profiling
calls (spy-pinned).
"""
import bisect
import contextlib
import json
import os

from autodist_tpu_torch import const
#: The explicit remainder bucket — never folded into a named scope.
from autodist_tpu_torch.graph_item import UNATTRIBUTED  # noqa: F401
from autodist_tpu_torch.utils import logging

#: Scope aggregation depth: "layer0/attn/bhqd,bhkd->bhqk" (einsum
#: sub-scopes) collapses into "layer0/attn"; the zoo's own scopes are at
#: most two segments deep ("stage0/block1").
SCOPE_DEPTH = 2

#: Prefix of the ``record_function`` ranges ``named_scope`` opens under
#: ``AUTODIST_TRACE=profiler``.
SCOPE_PREFIX = "scope:"
_BACKWARD_PREFIX = "autograd::engine::evaluate_function:"

_last_profile = None


def enabled():
    """Profiler gate: telemetry master switch AND ``AUTODIST_PROFILE``."""
    from autodist_tpu_torch import observability
    return observability.enabled() and bool(const.ENV.AUTODIST_PROFILE.val)


def topk():
    return max(1, int(const.ENV.AUTODIST_PROFILE_TOPK.val))


def collapse(scope, depth=SCOPE_DEPTH):
    """Cap a scope path at ``depth`` segments (sub-scopes aggregate up)."""
    if not scope:
        return ""
    return "/".join(scope.split("/")[:depth])


def scope_of(path_text, known_scopes):
    """Attribute a scope path or a variable name to the longest known
    scope that prefixes it segment-wise, or ``None``.

    ``"layer0/attn/bhqd,bhkd->bhqk"`` matches scope ``"layer0/attn"``;
    ``"layer0/attn/query/kernel"`` (a variable name) matches the same row
    — compute and comms land on one key.
    """
    from autodist_tpu_torch.graph_item import scope_path
    segs = [s for s in scope_path(path_text).split("/") if s]
    for i in range(min(len(segs), SCOPE_DEPTH + 1), 0, -1):
        cand = "/".join(segs[:i])
        if cand in known_scopes:
            return cand
    return None


def _zero():
    return {"compute_ms": 0.0, "comms_ms": 0.0, "wire_bytes": 0.0, "ops": 0}


# ---------------------------------------------------------------------------
# model-side (capture + strategy) per-scope costs — always available


def model_scope_costs(runner, unroll=1, topology=None):
    """Per-scope *predicted* costs from the captured program:

    * compute: per-scope forward FLOPs (3x fwd+bwd, spread over devices)
      from the aten provenance, plus the optimizer-HBM update term
      attributed to the variable's owning scope;
    * comms: per-variable collective cost priced on the topology
      (``topology``, default the mesh's), attributed by variable-name
      prefix.

    Returns ``(scopes, known)`` where ``scopes`` maps scope (or
    :data:`UNATTRIBUTED`) to cost records and ``known`` is the named
    scope set the trace and variable attribution match against.
    """
    from autodist_tpu_torch.tuner import cost_model as cm
    prog = runner.program
    item = prog.graph_item
    topo = topology or cm.Topology.for_mesh(prog.mesh)
    scopes, known = {}, set()
    for scope, agg in item.scope_costs().items():
        key = collapse(scope) or UNATTRIBUTED
        if key != UNATTRIBUTED:
            known.add(key)
        rec = scopes.setdefault(key, _zero())
        rec["compute_ms"] += 3.0 * agg["flops"] / \
            (topo.num_devices * topo.device_flops) * 1e3
        rec["ops"] += agg["ops"]

    # Per-variable update + sync terms (the cost model's own splitter —
    # fused AR groups are priced per variable here, which over-counts
    # bucket latency slightly but keeps attribution per-layer).
    model = cm.CostModel(topo)
    axes = dict(prog.strategy.graph_config.mesh_axes) or \
        {const.MESH_AXIS_DATA: topo.num_devices}
    n_data = max(1, axes.get(const.MESH_AXIS_DATA, topo.num_devices))
    for var in item.trainable_variables:
        node = prog.strategy.node_by_name(var.name)
        deferred = {}
        rs, ag, oth, elems, wire = model._var_sync_cost(
            var, node, n_data, deferred)
        comms_s = rs + ag + oth
        hosts = topo._hosts_spanned(n_data)
        for wire_b, raw_b, codec, sparse_b in deferred.values():
            if codec and hosts > 1:
                comms_s += topo.hierarchical_ar_cost(
                    raw_b, n_data, cm.hier_dcn_factor(codec, hosts))
                flat_b = sparse_b  # sparse rides its own flat ring
            else:
                flat_b = wire_b + sparse_b
            if flat_b:
                comms_s += topo.all_reduce_cost(flat_b, n_data)
        key = scope_of(var.name, known) or UNATTRIBUTED
        rec = scopes.setdefault(key, _zero())
        rec["comms_ms"] += comms_s * 1e3
        rec["wire_bytes"] += wire
        rec["compute_ms"] += elems * cm.UPDATE_BYTES_PER_ELEM / \
            topo.hbm_bytes_per_s * 1e3
    return scopes, known


# ---------------------------------------------------------------------------
# trace-side per-scope costs — when a torch.profiler trace was recorded


class _Ranges:
    """One thread's ``(start, end, payload)`` ranges, for the innermost
    range holding a timestamp (ranges nest; the innermost holding one
    is the latest-starting that still reaches it)."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]

    def innermost(self, ts):
        j = bisect.bisect_right(self.starts, ts) - 1
        while j >= 0:
            s, e, payload = self.ranges[j]
            if e >= ts:
                return s, payload
            j -= 1
        return None


def _load_trace(trace):
    if isinstance(trace, dict):
        return trace.get("traceEvents") or []
    with open(trace) as f:
        return json.load(f).get("traceEvents") or []


def _seq(args):
    seq = args.get("Sequence number")
    return None if seq is None or int(seq) < 0 else int(seq)


def trace_scope_costs(trace, known_scopes, steps=1, link_backward=True):
    """Per-scope device time of a ``torch.profiler`` Chrome trace (a path
    or the loaded document), ms per step.

    Each kernel (``cat == "kernel"``) is tied to its launching runtime
    call by the correlation id, and that call's thread and time to a
    scope: the innermost ``scope:<path>`` range open around it, or, when
    an autograd backward node (``autograd::engine::evaluate_function``)
    holds it more tightly, the scope of the forward op that carries the
    node's sequence number (``link_backward``; off, such kernels go
    unattributed: the planted fault the chip check reads). Kernels under
    a ``cudaGraphLaunch`` and ``nccl`` kernels are counted apart (graph
    replays carry no scope; collectives are comms).

    Returns ``(scopes, info)``: ``scopes`` maps a known scope (or
    :data:`UNATTRIBUTED`) to a cost record, and ``info`` counts what was
    attributed, unlinked and set apart, with each kernel name's launches
    per scope (``by_kernel``).
    """
    evs = _load_trace(trace)
    steps = max(1, int(steps))
    annotations, backward, forward, cpu_ops, launches = {}, {}, {}, {}, {}
    kernels = []
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        ts, dur, tid = float(e.get("ts", 0.0)), float(e.get("dur", 0.0)), \
            e.get("tid")
        args = e.get("args") or {}
        if cat == "user_annotation" and name.startswith(SCOPE_PREFIX):
            annotations.setdefault(tid, []).append(
                (ts, ts + dur, name[len(SCOPE_PREFIX):]))
        elif cat == "cpu_op":
            seq = _seq(args)
            if name.startswith(_BACKWARD_PREFIX):
                if seq is not None:
                    backward.setdefault(tid, []).append((ts, ts + dur, seq))
                continue
            cpu_ops.setdefault(tid, []).append((ts, ts + dur, name))
            if seq is not None and not args.get("Fwd thread id"):
                forward.setdefault(tid, []).append((ts, seq))
        elif cat in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            launches[args["correlation"]] = (tid, ts, name)
        elif cat == "kernel":
            kernels.append(e)
    annotations = {t: _Ranges(r) for t, r in annotations.items()}
    backward = {t: _Ranges(r) for t, r in backward.items()}

    def scope_at(tid, ts):
        """(scope path, how) of a launch at ``ts`` on ``tid``."""
        ann = annotations.get(tid)
        ann = ann.innermost(ts) if ann is not None else None
        bwd = backward.get(tid)
        bwd = bwd.innermost(ts) if bwd is not None else None
        if bwd is not None and (ann is None or bwd[0] > ann[0]):
            if not link_backward:
                return None, "unlinked"
            path = fwd_scope.get(bwd[1])
            return (path, "backward") if path else (None, "unlinked")
        if ann is not None:
            return ann[1], "forward"
        return None, "unscoped"

    # The forward op that made each autograd node: the last op carrying
    # its sequence number (ops before a node's creation share the number).
    fwd_scope = {}
    for tid, ops in forward.items():
        for ts, seq in sorted(ops):
            ann = annotations.get(tid)
            ann = ann.innermost(ts) if ann is not None else None
            fwd_scope[seq] = ann[1] if ann is not None else None

    units = []   # (name, tid, launch ts, dur us)
    info = {"mode": "kernels" if kernels else "cpu-ops", "steps": steps,
            "units": 0, "kernel_ms": 0.0, "attributed_ms": 0.0,
            "unattributed_ms": 0.0, "unattributed": 0, "unlinked": 0,
            "graph_replay_ms": 0.0, "graph_replay_kernels": 0,
            "comms_kernel_ms": 0.0, "comms_kernels": 0, "no_launch": 0,
            "by_kernel": {}}
    if kernels:
        for k in kernels:
            name, dur = k.get("name", ""), float(k.get("dur", 0.0))
            launch = launches.get((k.get("args") or {}).get("correlation"))
            if name.startswith("nccl"):
                info["comms_kernel_ms"] += dur / 1e3 / steps
                info["comms_kernels"] += 1
                continue
            if launch is not None and "GraphLaunch" in launch[2]:
                info["graph_replay_ms"] += dur / 1e3 / steps
                info["graph_replay_kernels"] += 1
                continue
            if launch is None:
                info["no_launch"] += 1
                units.append((name, None, None, dur))
                continue
            units.append((name, launch[0], launch[1], dur))
    else:
        # The CPU: each aten op's self time (its span less its nested
        # ops'), so every op counts once and the units sum to the ops'.
        for tid, ops in cpu_ops.items():
            ops.sort(key=lambda r: (r[0], -r[1]))
            stack = []   # [start, end, name, self]
            for s, e, name in ops:
                while stack and stack[-1][1] <= s:
                    done = stack.pop()
                    units.append((done[2], tid, done[0], done[3]))
                if stack:
                    stack[-1][3] -= min(e, stack[-1][1]) - s
                stack.append([s, e, name, e - s])
            units += [(name, tid, s, self_us)
                      for s, _, name, self_us in stack]

    scopes = {}
    for name, tid, ts, dur in units:
        path, how = (None, "unscoped") if ts is None else scope_at(tid, ts)
        key = (scope_of(path, known_scopes) if path else None) \
            or UNATTRIBUTED
        if key == UNATTRIBUTED:
            info["unattributed"] += 1
            info["unattributed_ms"] += dur / 1e3 / steps
            if how == "unlinked":
                info["unlinked"] += 1
        else:
            info["attributed_ms"] += dur / 1e3 / steps
        rec = scopes.setdefault(key, _zero())
        rec["compute_ms"] += dur / 1e3 / steps
        rec["ops"] += 1
        per = info["by_kernel"].setdefault(name, {})
        per[key] = per.get(key, 0) + 1
    info["units"] = len(units)
    info["kernel_ms"] = info["attributed_ms"] + info["unattributed_ms"]
    return scopes, info


# ---------------------------------------------------------------------------
# the profile object: measured structure + model predictions


class Profile:
    """Per-scope cost structure for one program.

    ``measured`` carries the best-available per-scope structure (the
    profiler trace when recorded, else the model costs), ``predicted``
    always the model costs; ``sources`` records which is which per cost
    class — measured-vs-predicted deltas are only meaningful when the
    measured side really is a measurement (same honesty rule as the
    ledger). ``trace`` is :func:`trace_scope_costs`'s ``info`` when a
    trace was read.
    """

    def __init__(self, measured, predicted, sources, unroll=1, trace=None):
        self.measured = measured
        self.predicted = predicted
        self.sources = dict(sources)
        self.unroll = max(1, int(unroll))
        self.trace = trace

    def reconcile(self, attr_summary):
        """Normalize per-scope shares against the step ledger so the
        per-scope sums equal the ledger's terms EXACTLY:

        * compute rows sum to ``attr.device_compute_ms``;
        * comms rows sum to ``attr.exposed_comms_ms``;
        * whatever share no scope claims stays in ``(unattributed)``.

        Without a ledger summary (no observed loop yet) the raw model
        units are kept and ``reconciled`` is marked ``False``.
        """
        attr = attr_summary or {}
        ledger = {"compute_ms": attr.get("device_compute_ms"),
                  "comms_ms": attr.get("exposed_comms_ms")}
        total = {cls: sum(rec[cls] for rec in self.measured.values())
                 for cls in ("compute_ms", "comms_ms")}
        scale = {}
        for cls in ("compute_ms", "comms_ms"):
            if ledger[cls] is None:
                scale[cls] = 1.0
            elif total[cls] > 0:
                scale[cls] = ledger[cls] / total[cls]
            else:
                scale[cls] = 0.0
        rows = {}
        for scope in set(self.measured) | set(self.predicted):
            m = self.measured.get(scope, _zero())
            p = self.predicted.get(scope, _zero())
            rows[scope] = {
                "compute_ms": round(m["compute_ms"] * scale["compute_ms"], 6),
                "comms_ms": round(m["comms_ms"] * scale["comms_ms"], 6),
                "wire_bytes": round(m["wire_bytes"] or p["wire_bytes"], 1),
                "predicted_compute_ms": round(p["compute_ms"], 6),
                "predicted_comms_ms": round(p["comms_ms"], 6),
                "ops": m["ops"] or p["ops"],
            }
        # The ledger total that no measured row carried is remainder —
        # it lands in the unattributed row, never disappears.
        for cls in ("compute_ms", "comms_ms"):
            if ledger[cls] is not None and total[cls] <= 0 and ledger[cls]:
                rows.setdefault(UNATTRIBUTED, dict(_zero()))
                rows[UNATTRIBUTED][cls] = round(ledger[cls], 6)

        named = {s: r for s, r in rows.items() if s != UNATTRIBUTED}
        unatt = rows.get(UNATTRIBUTED, _zero())
        tot_c = sum(r["compute_ms"] for r in rows.values())
        tot_m = sum(r["comms_ms"] for r in rows.values())
        attributed = sum(r["compute_ms"] + r["comms_ms"]
                         for r in named.values())
        coverage = 100.0 * attributed / (tot_c + tot_m) \
            if (tot_c + tot_m) > 0 else 0.0
        top = sorted(named, key=lambda s: -(named[s]["compute_ms"] +
                                            named[s]["comms_ms"]))
        out = {
            "scopes": named,
            "unattributed": {k: unatt[k] for k in
                             ("compute_ms", "comms_ms", "wire_bytes")},
            "totals": {"compute_ms": round(tot_c, 6),
                       "comms_ms": round(tot_m, 6),
                       "wire_bytes": round(sum(r["wire_bytes"]
                                               for r in rows.values()), 1)},
            "coverage_pct": round(coverage, 2),
            "top": top[:topk()],
            "sources": dict(self.sources),
            "reconciled": any(ledger[c] is not None
                              for c in ("compute_ms", "comms_ms")),
            "unroll": self.unroll,
            "steps": attr.get("steps"),
        }
        if self.trace is not None:
            out["trace"] = self.trace
        return out


def profile_runner(runner, unroll=1, trace=None, steps=None,
                   link_backward=True):
    """Build the per-scope profile for one Runner's program.

    The model-side costs are always the prediction; with a
    ``torch.profiler`` trace (``trace``: its path or document, of
    ``steps`` steps) whose eagerly launched device work reached at least
    one named scope, the compute class is upgraded to the measured
    kernel time per scope (``sources["compute"] = "torch-profiler"``).
    A trace with no device time, or whose kernels were all graph
    replays, keeps the model source and says why in ``sources``. Comms
    stays the model's: the gradient collectives run in the Runner's sync
    code, outside any model scope.
    """
    predicted, known = model_scope_costs(runner, unroll=unroll)
    measured = {s: dict(rec) for s, rec in predicted.items()}
    sources = {"compute": "aten-flops", "comms": "strategy-model"}
    info = None
    if trace is not None:
        try:
            scopes, info = trace_scope_costs(
                trace, known, steps=steps or 1, link_backward=link_backward)
            if info["attributed_ms"] > 0:
                sources["compute"] = "torch-profiler"
                for rec in measured.values():
                    rec["compute_ms"] = 0.0
                for s, rec in scopes.items():
                    row = measured.setdefault(s, _zero())
                    row["compute_ms"] += rec["compute_ms"]
            elif info["graph_replay_kernels"]:
                sources["trace"] = ("graph replays only: their kernels "
                                    "carry no scope")
            else:
                sources["trace"] = "no device time in the trace"
        except Exception as e:  # noqa: BLE001 - fall back to model costs
            logging.debug("trace scope costs unavailable: %s", e)
            sources["trace"] = f"unreadable: {e}"
    return Profile(measured, predicted, sources, unroll=unroll, trace=info)


# ---------------------------------------------------------------------------
# finalize: gauges, sidecar, calibration feed

MEASURED_SOURCES = ("scheduled-hlo", "torch-profiler")


def feed_calibration(summary, calibration=None, path=None):
    """Per-scope measured-vs-predicted observations for the tuner, into
    ``calibration``, else the file at ``path`` under its lock.

    Only classes whose measured side is a measurement (the profiler
    trace here; the scheduled HLO in the JAX package) teach anything
    (model-vs-itself is a constant ratio); the worst top-K offenders are
    folded as per-class ``observe_term`` samples with a
    ``profile:<scope>`` context.
    """
    if not summary:
        return None
    sources = summary.get("sources") or {}
    if not any(v in MEASURED_SOURCES for v in sources.values()):
        return None
    try:
        with contextlib.ExitStack() as stack:
            if calibration is None:
                from autodist_tpu_torch.tuner.calibration import Calibration
                calibration = stack.enter_context(Calibration.locked(path))
            rows = summary.get("scopes") or {}
            offenders = sorted(
                rows, key=lambda s: -max(
                    abs(rows[s]["compute_ms"] -
                        rows[s]["predicted_compute_ms"]),
                    abs(rows[s]["comms_ms"] - rows[s]["predicted_comms_ms"])))
            for scope in offenders[:topk()]:
                r = rows[scope]
                if sources.get("compute") in MEASURED_SOURCES and \
                        r["predicted_compute_ms"] > 0 and r["compute_ms"] > 0:
                    calibration.observe_term(
                        "compute", r["predicted_compute_ms"],
                        r["compute_ms"], context=f"profile:{scope}")
                if sources.get("comms") in MEASURED_SOURCES and \
                        r["predicted_comms_ms"] > 0 and r["comms_ms"] > 0:
                    calibration.observe_term(
                        "comms", r["predicted_comms_ms"], r["comms_ms"],
                        context=f"profile:{scope}")
        return calibration
    except Exception as e:  # noqa: BLE001 - calibration is best-effort
        logging.debug("profile calibration feed failed: %s", e)
        return None


def finalize(profile, attr_summary, registry=None, calibration_path=None):
    """End-of-run bookkeeping: reconcile against the ledger, publish the
    ``profile.*`` gauges, stash the summary for the monitor, write the
    ``profile.json`` sidecar under ``AUTODIST_DUMP_GRAPHS``, and feed the
    per-class calibration (the program's file, ``calibration_path``)."""
    summary = profile.reconcile(attr_summary)
    if registry is not None:
        named = summary["scopes"]
        registry.gauge("profile.scopes").set(len(named))
        registry.gauge("profile.coverage_pct").set(summary["coverage_pct"])
        registry.gauge("profile.unattributed_ms").set(round(
            summary["unattributed"]["compute_ms"] +
            summary["unattributed"]["comms_ms"], 6))
        if summary["top"]:
            hot = summary["top"][0]
            registry.gauge("profile.top_compute_ms").set(
                named[hot]["compute_ms"])
            registry.gauge("profile.top_comms_ms").set(
                max(r["comms_ms"] for r in named.values()))
    set_last_profile(summary)
    feed_calibration(summary, path=calibration_path)
    if const.ENV.AUTODIST_DUMP_GRAPHS.val:
        try:
            const.ensure_working_dirs()
            path = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR, "profile.json")
            with open(path, "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
        except OSError as e:
            logging.debug("profile sidecar not written: %s", e)
    try:
        from autodist_tpu_torch.observability import recorder
        hot = summary["top"][0] if summary["top"] else "(none)"
        recorder.record(
            "profile",
            f"{len(summary['scopes'])} scopes, {summary['coverage_pct']:.0f}%"
            f" attributed, hottest {hot}, compute source "
            f"{summary['sources'].get('compute')}")
    except Exception:  # noqa: BLE001 - telemetry must never kill a run
        pass
    return summary


def last_summary_rows(limit=None):
    """Top-N ``(scope, row)`` pairs of the last profile (monitor
    convenience); ``[]`` before the first profiled run."""
    summ = last_profile()
    if not summ:
        return []
    rows = summ["scopes"]
    order = summ.get("top") or sorted(
        rows, key=lambda s: -(rows[s]["compute_ms"] + rows[s]["comms_ms"]))
    extra = [s for s in rows if s not in order]
    ranked = list(order) + sorted(
        extra, key=lambda s: -(rows[s]["compute_ms"] + rows[s]["comms_ms"]))
    return [(s, rows[s]) for s in ranked[:limit or topk()]]


def last_profile():
    """The most recent finalized per-layer profile in this process."""
    return _last_profile


def set_last_profile(summary):
    global _last_profile
    _last_profile = summary


def reset():
    """Test harness hook."""
    set_last_profile(None)
