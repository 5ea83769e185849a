"""Transform report: one HTML page showing what the transform did.

Counterpart of ``autodist_tpu/report.py``. The chief renders one
self-contained page (``DEFAULT_GRAPH_DUMP_DIR/report_<strategy id>.html``,
with ``report.html`` mirroring the latest) at each of the port's compiles,
a Runner's first eager dispatch and each graph capture
(``Runner._auto_report``):

  capture (variables, sizes, sparse detection)
  -> strategy (per-variable synchronizer / partitioner / compressor)
  -> placements (mesh layout + each variable's stored layout on a rank)
  -> compiled step (the collective table and the op text of one whole
     transformed step, ``Runner._step_text``, once ``write_report`` ran)

then the resilience events, telemetry (attribution, per-layer profile,
skew, phases, metrics, flight log), pipeline, serving, goodput and memory
sections, each read from the port's ledgers as the JAX page reads the JAX
ones, and each fail-open: a report never kills a run. Pages and the alias
are written atomically (a temporary file in the same directory, then
``os.replace``), so a reader never sees half a page.

The JAX page's Tuner (its ``_render_tuner`` / ``_render_automap``),
Re-tuning and Self-heal sections render ``""`` until their producers run,
and those producers come with ROADMAP A12: this page leaves them out.
Open the logged path in any browser — no server, no framework needed.
"""
import glob
import html
import os
import re
import tempfile

from autodist_tpu_torch import const
# A variable's dtype under the JAX package's name ("float32").
from autodist_tpu_torch.graph_item import _dtype_name
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

_CSS = """
body { font-family: -apple-system, system-ui, sans-serif; margin: 2em auto;
       max-width: 1100px; color: #1a1a2e; }
h1 { font-size: 1.5em; } h2 { font-size: 1.15em; margin-top: 1.6em;
     border-bottom: 2px solid #e0e0ef; padding-bottom: .2em; }
table { border-collapse: collapse; width: 100%; font-size: .85em; }
th, td { text-align: left; padding: .3em .6em; border-bottom: 1px solid #eee; }
th { background: #f4f4fb; }
code, pre { font-family: ui-monospace, Menlo, monospace; font-size: .85em; }
pre { background: #f7f7fc; padding: .8em; overflow-x: auto; max-height: 28em; }
.badge { background: #e8ecff; border-radius: .6em; padding: .05em .55em;
         font-size: .8em; }
summary { cursor: pointer; color: #3b4890; margin: .4em 0; }
.meta { color: #667; font-size: .9em; }
.warn { color: #a02020; font-weight: 600; }
.wf { position: relative; height: 1.1em; background: #f4f4fb;
      margin: 2px 0; }
.wf > span { position: absolute; top: 0; height: 100%;
             background: #7c8ae0; min-width: 2px; }
.wflabel { font-size: .8em; color: #445; }
"""

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def _esc(x):
    return html.escape(str(x))


def _sync_summary(nc):
    """One-line description of a NodeConfig's synchronizer choice."""
    which = nc.WhichOneof("synchronizer")
    if which == "ps_synchronizer":
        ps = nc.ps_synchronizer
        bits = [f"PS dest={ps.reduction_destination or 'auto'}",
                "sync" if ps.sync else "async"]
        if ps.staleness:
            bits.append(f"staleness={ps.staleness}")
        return ", ".join(bits)
    if which == "all_reduce_synchronizer":
        ar = nc.all_reduce_synchronizer
        spec = ar.Spec.Name(ar.spec) if hasattr(ar, "Spec") else ar.spec
        comp = ar.Compressor.Name(ar.compressor) \
            if hasattr(ar, "Compressor") else ar.compressor
        return f"AllReduce spec={spec}, compressor={comp}, group={ar.group}"
    return which or "(none)"


def collective_summary(hlo_text, ops=None, keep_zeros=False):
    """{op: count} over a step text (``Runner._step_text``, whose
    collective lines take XLA's names and syntax) or an HLO text.

    The JAX package's pattern, async ``-start`` forms and ``.N`` suffixes
    included, so one text counts alike in both packages.
    """
    out = {}
    for op in (ops or _COLLECTIVES):
        n = len(re.findall(rf"\b{op}(?:-start)?(?:\.\d+)?\(", hlo_text))
        if n or keep_zeros:
            out[op] = n
    return out


def replica_group_sizes(hlo_text):
    """Set of collective replica-group sizes in a step text or an HLO
    text.  A collective spanning mesh axis X has group size == axis size —
    the signature used to prove an exchange really crosses that axis.
    The step text writes every group in the iota form.

    Both replica-group syntaxes XLA emits are parsed: the iota form
    ``replica_groups=[G,S]<=[...]`` (S = group size) and the explicit
    brace form ``replica_groups={{0,1},{2,3}}`` (group size = ids per
    inner brace group) — a pass/version that switches form must not
    silently empty the set and flip a verified flag to a false negative."""
    sizes = {int(m.group(2)) for m in re.finditer(
        r"replica_groups=\[(\d+),(\d+)\]", hlo_text)}
    for m in re.finditer(r"replica_groups=\{(\{[^}]*\}(?:,\{[^}]*\})*)\}",
                         hlo_text):
        for g in re.finditer(r"\{([^}]*)\}", m.group(1)):
            sizes.add(len([t for t in g.group(1).split(",") if t.strip()]))
    return sizes


def einsum_result_lead_dims(hlo_text, labels):
    """Leading result dims of ops whose op_name carries one of the given
    einsum ``labels`` (e.g. ``("ecd,edh->ech",)``).

    In the step text an einsum run through ``utils/scope.einsum`` names
    its scope after its spec, so every op it dispatches carries the label
    (as the JAX package's op metadata does), and the result's leading dim
    is the per-RANK extent: the E/ep signature of the MoE layer's expert
    products under expert parallelism.  Only rank-3 results are matched
    (the ``[e, c, d]``-shaped einsum products)."""
    pat = (r"= \w+\[(\d+),\d+,\d+\][^\n]*op_name=\"[^\"]*(?:"
           + "|".join(re.escape(l) for l in labels) + ")")
    return [int(m.group(1)) for m in re.finditer(pat, hlo_text)]


def _fmt_ms(v):
    return f"{v:.2f}" if isinstance(v, (int, float)) else ""


_ATTR_COLORS = {"data_wait_ms": "#e0a040", "host_dispatch_ms": "#b0b8c8",
                "device_compute_ms": "#7c8ae0", "exposed_comms_ms": "#d06868",
                "residual_ms": "#c8c0e8"}
_ATTR_LABELS = {"data_wait_ms": "data wait", "host_dispatch_ms": "host",
                "device_compute_ms": "compute", "exposed_comms_ms": "comms",
                "residual_ms": "residual"}


def _render_attribution(agg):
    """"Where the step goes": one stacked bar + component row per host,
    from the attribution summaries the snapshots carried."""
    from autodist_tpu_torch.observability.attribution import COMPONENTS
    with_attr = [(host, info["attribution"])
                 for host, info in sorted(agg["hosts"].items())
                 if info.get("attribution")]
    if not with_attr:
        return ""
    legend = " ".join(
        f"<span class=badge style=\"background:{_ATTR_COLORS[c]}\">"
        f"{_ATTR_LABELS[c]}</span>" for c in COMPONENTS)
    rows, bars = [], []
    for host, a in with_attr:
        wall = a.get("wall_ms") or 0.0
        spans, left = [], 0.0
        for c in COMPONENTS:
            v = a.get(c) or 0.0
            width = max(0.0, 100.0 * v / wall) if wall > 0 else 0.0
            width = min(width, max(0.0, 100.0 - left))
            if width > 0:
                spans.append(
                    f"<span style=\"left:{left:.2f}%;width:{width:.2f}%;"
                    f"background:{_ATTR_COLORS[c]}\" "
                    f"title=\"{_ATTR_LABELS[c]} {v:.3f}ms\"></span>")
                left += width
        bars.append(f"<div class=wflabel>host {host} &middot; "
                    f"{wall:.2f} ms/step"
                    + (f" &middot; unroll={a['unroll']}"
                       if a.get("unroll", 1) > 1 else "")
                    + f"</div><div class=wf>{''.join(spans)}</div>")
        resid = a.get("residual_ms") or 0.0
        resid_cls = " class=warn" if wall > 0 and \
            abs(resid) > 0.25 * wall else ""
        rows.append(
            f"<tr><td>{host}</td><td>{_fmt_ms(wall)}</td>"
            + "".join(f"<td>{_fmt_ms(a.get(c))}</td>"
                      for c in COMPONENTS[:-1])
            + f"<td{resid_cls}>{_fmt_ms(resid)}</td>"
            f"<td>{a.get('steps', '')}</td></tr>")
    table = ("<table><tr><th>host</th><th>wall</th>"
             + "".join(f"<th>{_ATTR_LABELS[c]}</th>" for c in COMPONENTS)
             + "<th>steps</th></tr>" + "".join(rows) + "</table>")
    return ("<h3>Where the step goes (per-step attribution, ms)</h3>"
            f"<p class=meta>{legend} &middot; components + residual sum to "
            "the measured wall time; a large residual (flagged) means the "
            "model misses real work (docs/observability.md)</p>"
            + "".join(bars) + table)


def _render_profile():
    """"Per-layer profile": stacked compute/comms bars per scope, the
    top-N scope table with wire bytes, and the worst measured-vs-
    predicted offenders — the per-scope split of the attribution
    ledger's device terms (observability/profile.py).  Returns "" before
    the first profiled run; fail-open like every section."""
    from autodist_tpu_torch.observability import profile
    summ = profile.last_profile()
    if not summ or not (summ["scopes"] or
                        any(summ["unattributed"].values())):
        return ""
    rows = dict(summ["scopes"])
    unatt = summ["unattributed"]
    if unatt.get("compute_ms") or unatt.get("comms_ms"):
        rows[profile.UNATTRIBUTED] = dict(
            unatt, predicted_compute_ms=0.0, predicted_comms_ms=0.0)
    ranked = sorted(rows, key=lambda s: -(rows[s]["compute_ms"] +
                                          rows[s]["comms_ms"]))
    full = max((rows[s]["compute_ms"] + rows[s]["comms_ms"])
               for s in ranked) or 1.0
    bars, trows = [], []
    for scope in ranked[:20]:
        r = rows[scope]
        c, m = r["compute_ms"], r["comms_ms"]
        cw = 100.0 * c / full
        mw = min(100.0 * m / full, 100.0 - cw)
        bars.append(
            f"<div class=wflabel><code>{_esc(scope)}</code> &middot; "
            f"compute {_fmt_ms(c)} ms &middot; comms {_fmt_ms(m)} ms"
            f"</div><div class=wf>"
            f"<span style=\"left:0;width:{cw:.2f}%;background:"
            f"{_ATTR_COLORS['device_compute_ms']}\"></span>"
            f"<span style=\"left:{cw:.2f}%;width:{mw:.2f}%;background:"
            f"{_ATTR_COLORS['exposed_comms_ms']}\"></span></div>")
        dc = c - r.get("predicted_compute_ms", 0.0)
        dm = m - r.get("predicted_comms_ms", 0.0)
        trows.append(
            f"<tr><td><code>{_esc(scope)}</code></td>"
            f"<td>{_fmt_ms(c)}</td><td>{_fmt_ms(m)}</td>"
            f"<td>{r.get('wire_bytes', 0) / 1e6:.3f}</td>"
            f"<td>{r.get('ops', '')}</td>"
            f"<td>{dc:+.3f} / {dm:+.3f}</td></tr>")
    offenders = sorted(
        summ["scopes"],
        key=lambda s: -max(
            abs(summ["scopes"][s]["compute_ms"] -
                summ["scopes"][s]["predicted_compute_ms"]),
            abs(summ["scopes"][s]["comms_ms"] -
                summ["scopes"][s]["predicted_comms_ms"])))[:3]
    src = summ.get("sources") or {}
    meta = (f"compute from <span class=badge>{_esc(src.get('compute'))}"
            f"</span> &middot; comms from <span class=badge>"
            f"{_esc(src.get('comms'))}</span> &middot; "
            f"{summ['coverage_pct']:.0f}% of device time attributed to "
            f"named scopes &middot; per-scope sums reconcile to the "
            f"ledger's compute/comms terms"
            + (f" &middot; worst offenders: "
               + ", ".join(f"<code>{_esc(s)}</code>" for s in offenders)
               if offenders else ""))
    table = ("<table><tr><th>scope</th><th>compute ms</th><th>comms ms"
             "</th><th>wire MB</th><th>ops</th>"
             "<th>&Delta; vs predicted (c / m)</th></tr>"
             + "".join(trows) + "</table>")
    return ("<h3>Per-layer profile (per-step ms)</h3>"
            f"<p class=meta>{meta}</p>" + "".join(bars) + table)


def _render_skew():
    """"Cluster timeline": the per-host step waterfall on the chief-
    aligned clock plus the straggler forensics table — the skew
    decomposition's split of exposed comms into wire vs barrier wait
    (observability/skew.py).  Returns "" before the first decomposition;
    fail-open like every section."""
    from autodist_tpu_torch.observability import skew
    summ = skew.last_summary()
    if not summ or not summ.get("hosts"):
        return ""
    hosts = summ["hosts"]

    # Per-host step waterfall: each host's last dispatch windows on one
    # shared (offset-corrected) time axis, the skew-wait tail of each
    # window tinted red — a straggling host reads as the row whose bars
    # end latest with no red tail.
    starts = [w["s"] for row in hosts.values()
              for w in (row.get("windows") or ())]
    ends = [w["e"] for row in hosts.values()
            for w in (row.get("windows") or ())]
    bars = ""
    if starts and ends and max(ends) > min(starts):
        t0, t1 = min(starts), max(ends)
        span = t1 - t0
        host_bars = []
        for host, row in sorted(hosts.items()):
            spans = []
            for w in row.get("windows") or ():
                left = 100.0 * (w["s"] - t0) / span
                width = max(0.3, 100.0 * (w["e"] - w["s"]) / span)
                k = max(1, int(w.get("k", 1)))
                wait_s = w.get("skew_wait_ms", 0.0) * k / 1e3
                exposed_s = w.get("exposed_comms_ms", 0.0) * k / 1e3
                spans.append(
                    f"<span style=\"left:{left:.2f}%;"
                    f"width:{min(width, 100 - left):.2f}%\" "
                    f"title=\"step {w.get('i')}: wire "
                    f"{w.get('wire_ms', 0):.3f}ms + skew-wait "
                    f"{w.get('skew_wait_ms', 0):.3f}ms /step\"></span>")
                if wait_s > 0:
                    ready = w["e"] - exposed_s
                    wleft = 100.0 * (ready - t0) / span
                    wwidth = max(0.3, 100.0 * wait_s / span)
                    spans.append(
                        f"<span style=\"left:{wleft:.2f}%;"
                        f"width:{min(wwidth, 100 - wleft):.2f}%;"
                        f"background:#d06868\" title=\"skew-wait "
                        f"{w.get('skew_wait_ms', 0):.3f}ms/step\"></span>")
            host_bars.append(
                f"<div class=wflabel>host {host} &middot; wire "
                f"{row.get('wire_ms', 0):.3f} + skew-wait "
                f"{row.get('skew_wait_ms', 0):.3f} ms/step</div>"
                f"<div class=wf>{''.join(spans)}</div>")
        bars = ("<p class=meta>per-host dispatch windows on the chief's "
                "clock (<span class=badge style=\"background:#d06868\">"
                "skew-wait</span> = barrier time blamed on the "
                "straggler)</p>" + "".join(host_bars))

    rows = []
    for host, row in sorted(hosts.items()):
        unc = row.get("uncertainty_ms") or 0.0
        drift = row.get("drift_ppm")
        rows.append(
            f"<tr><td>{host}</td>"
            f"<td>{_fmt_ms(row.get('offset_ms'))} &plusmn; "
            f"{_fmt_ms(unc)}</td>"
            f"<td>{_esc(drift) if drift is not None else ''}</td>"
            f"<td>{_fmt_ms(row.get('exposed_comms_ms'))}</td>"
            f"<td>{_fmt_ms(row.get('wire_ms'))}</td>"
            f"<td>{_fmt_ms(row.get('skew_wait_ms'))}</td>"
            f"<td>{row.get('straggler_windows', 0)}/"
            f"{summ.get('windows', 0)}</td></tr>")
    table = ("<table><tr><th>host</th><th>clock offset (ms)</th>"
             "<th>drift (ppm)</th><th>exposed comms</th><th>wire</th>"
             "<th>skew-wait</th><th>straggler windows</th></tr>"
             + "".join(rows) + "</table>")

    verdict = ""
    straggler = summ.get("straggler")
    if straggler:
        cls = " class=warn" if summ.get("significant") else " class=meta"
        verdict = f"<p{cls}>&#9888; {_esc(straggler['detail'])}</p>"
    return ("<h3>Cluster timeline &amp; straggler forensics</h3>"
            + verdict + bars + table
            + "<p class=meta>wire + skew-wait = exposed comms, exactly, "
              "per step; offsets are NTP-style KV-ping estimates vs the "
              "chief (uncertainty = RTT/2).  Merge every host's trace "
              "into one Perfetto file with <code>python -m "
              "autodist_tpu_torch.tools.timeline &lt;logdir&gt;</code> "
              "(docs/observability.md)</p>")


_GOODPUT_COLORS = {
    "goodput_ms": "#4f9d69", "startup_ms": "#b0b8c8",
    "compile_ms": "#7c8ae0", "restore_ms": "#8ec7d2",
    "reshard_ms": "#5a7bd0", "checkpoint_save_ms": "#c9a25e",
    "emergency_save_ms": "#d07c3a", "rollback_ms": "#c05050",
    "retune_switch_ms": "#9a5bd0", "reexec_gap_ms": "#a02020",
    "selfheal_ms": "#b03a6a",
    "data_wait_ms": "#e0a040", "other_ms": "#d8d4e8",
}
_GOODPUT_LABELS = {
    "goodput_ms": "goodput", "startup_ms": "startup",
    "compile_ms": "compile", "restore_ms": "restore",
    "reshard_ms": "reshard", "checkpoint_save_ms": "ckpt save",
    "emergency_save_ms": "emergency save", "rollback_ms": "rollback",
    "retune_switch_ms": "retune switch", "reexec_gap_ms": "re-exec gap",
    "selfheal_ms": "self-heal",
    "data_wait_ms": "data wait", "other_ms": "other",
}


def _render_goodput():
    """"Run goodput": the run-level wall-clock classification
    (observability/goodput.py) as one stacked bar per generation plus the
    class-total table, with the MFU headline: the JAX renderer over the
    port's ledger, whose summaries carry the same keys. When segments from
    more than one elastic re-exec generation exist, the STITCHED run
    renders: the re-exec gap shows up as a priced badput bar, not as a
    fresh run. Returns "" before the first finalized loop; fail-open like
    every section."""
    from autodist_tpu_torch.observability import goodput
    stitched = None
    try:
        segs = goodput.segments_for()
        if len(segs) > 1:
            stitched = goodput.stitch_run()
    except Exception as e:  # noqa: BLE001 - stitching is best-effort
        logging.debug("report: goodput stitch unavailable: %s", e)
    summ = stitched or goodput.last_summary()
    if not summ or not summ.get("wall_ms"):
        return ""
    order = ("goodput_ms",) + goodput.BADPUT_CLASSES
    values = dict(summ.get("classes") or {})
    values["goodput_ms"] = summ.get("goodput_ms", 0.0)
    wall = summ["wall_ms"] or 1.0

    def bar(vals, label):
        spans, left = [], 0.0
        for c in order:
            v = max(0.0, float(vals.get(c) or 0.0))
            width = min(100.0 * v / wall, max(0.0, 100.0 - left))
            if width > 0:
                spans.append(
                    f"<span style=\"left:{left:.2f}%;width:{width:.2f}%;"
                    f"background:{_GOODPUT_COLORS[c]}\" "
                    f"title=\"{_GOODPUT_LABELS[c]} {v:.1f}ms\"></span>")
                left += width
        return (f"<div class=wflabel>{label}</div>"
                f"<div class=wf>{''.join(spans)}</div>")

    bars = [bar(values, f"run &middot; {wall:.0f} ms wall")]
    if stitched:
        for seg in stitched["segments"]:
            sv = dict(seg.get("classes") or {})
            sv["goodput_ms"] = seg.get("goodput_ms", 0.0)
            bars.append(bar(sv, f"generation {seg.get('generation')} "
                                f"&middot; {seg.get('wall_ms', 0):.0f} ms "
                                f"&middot; {seg.get('steps', 0)} steps"))
    legend = " ".join(
        f"<span class=badge style=\"background:{_GOODPUT_COLORS[c]}\">"
        f"{_GOODPUT_LABELS[c]}</span>" for c in order)
    rows = "".join(
        f"<tr><td>{_GOODPUT_LABELS[c]}</td>"
        f"<td>{_fmt_ms(values.get(c) or 0.0)}</td>"
        f"<td>{100.0 * (values.get(c) or 0.0) / wall:.1f}%</td></tr>"
        for c in order)
    mfu = summ.get("mfu")
    hfu = summ.get("hfu") if not stitched else None
    headline_bits = [
        f"goodput <b>{summ.get('goodput_pct') or 0:.1f}%</b> of "
        f"{wall:.0f} ms wall",
        f"{summ.get('steps', 0)} steps",
    ]
    if mfu is not None:
        headline_bits.append(f"MFU <b>{100.0 * mfu:.3f}%</b>")
    if hfu is not None:
        headline_bits.append(f"HFU {100.0 * hfu:.3f}%")
    if stitched:
        headline_bits.append(
            f"stitched across generations {stitched['generations']} "
            f"(re-exec gaps {stitched['reexec_gaps_ms']} ms)")
        if stitched.get("selfheal_episodes"):
            eps = stitched["selfheal_episodes"]
            headline_bits.append(
                f"{len(eps)} self-heal episode{'s' if len(eps) > 1 else ''} "
                f"({sum(e['total_ms'] for e in eps):.0f} ms "
                f"drain + re-exec, billed as self-heal)")
    return ("<h2>9 &middot; Run goodput</h2>"
            f"<p class=meta>{' · '.join(headline_bits)}</p>"
            f"<p class=meta>{legend}</p>" + "".join(bars)
            + "<table><tr><th>class</th><th>ms</th><th>share</th></tr>"
            + rows + "</table>"
            + "<p class=meta>classes sum to the measured wall-clock "
              "exactly; MFU = model flops / (peak &times; wall) — see "
              "docs/goodput.md for the taxonomy and the peak-flops "
              "table</p>")


_MEM_COLORS = {"params_bytes": "#7c8ae0", "optimizer_bytes": "#b07cd0",
               "gradients_bytes": "#d06868", "sync_state_bytes": "#d0a040",
               "activations_bytes": "#68b068", "staging_bytes": "#b0b8c8",
               "kv_cache_bytes": "#50b8b0"}
_MEM_LABELS = {"params_bytes": "params", "optimizer_bytes": "optimizer",
               "gradients_bytes": "gradients", "sync_state_bytes":
               "sync state", "activations_bytes": "activations",
               "staging_bytes": "staging", "kv_cache_bytes": "kv cache"}


def _render_memory():
    """"Where the HBM goes": the predicted per-device peak split into
    ledger classes as one stacked bar, the class table, the
    measured-vs-predicted reconciliation line, and the last OOM report
    if one was written (observability/memory.py, docs/memory.md).
    Returns "" before the first finalized ledger; fail-open like every
    section."""
    from autodist_tpu_torch.observability import memory as memory_mod
    summ = memory_mod.last_summary()
    if not summ or not summ.get("predicted"):
        return ""
    classes = summ["predicted"]
    peak = summ.get("predicted_peak_bytes") or sum(classes.values()) or 1.0
    gb = 1 << 30
    spans, left = [], 0.0
    for c in memory_mod.CLASSES:
        v = max(0.0, float(classes.get(c) or 0.0))
        width = min(100.0 * v / peak, max(0.0, 100.0 - left))
        if width > 0:
            spans.append(
                f"<span style=\"left:{left:.2f}%;width:{width:.2f}%;"
                f"background:{_MEM_COLORS[c]}\" "
                f"title=\"{_MEM_LABELS[c]} {v / gb:.4f}GiB\"></span>")
            left += width
    legend = " ".join(
        f"<span class=badge style=\"background:{_MEM_COLORS[c]}\">"
        f"{_MEM_LABELS[c]}</span>" for c in memory_mod.CLASSES)
    rows = "".join(
        f"<tr><td>{_MEM_LABELS[c]}</td>"
        f"<td>{(classes.get(c) or 0.0) / gb:.4f}</td>"
        f"<td>{100.0 * (classes.get(c) or 0.0) / peak:.1f}%</td></tr>"
        for c in memory_mod.CLASSES)
    headline = [f"predicted peak <b>{summ.get('predicted_peak_gb', 0):.3f}"
                f" GiB</b>/device (dominant "
                f"{_MEM_LABELS.get(summ.get('dominant_class'), '?')})"]
    if summ.get("capacity_gb"):
        feas = ("fits" if summ.get("feasible")
                else "<b>EXCEEDS headroom</b>")
        headline.append(f"capacity {summ['capacity_gb']:.1f} GiB "
                        f"&times; {summ.get('headroom', 0.9):.0%} "
                        f"headroom — {feas}")
    if summ.get("measured_peak_gb") is not None:
        headline.append(
            f"measured {summ['measured_peak_gb']:.3f} GiB "
            f"({summ.get('measured_source', '?')}, "
            f"{summ.get('samples', 0)} samples)")
    if summ.get("prediction_error_pct") is not None:
        headline.append(f"resident-state prediction error "
                        f"{summ['prediction_error_pct']:+.1f}%")
    oom_html = ""
    oom = memory_mod.last_oom_report()
    if oom:
        sug = oom.get("suggestion") or {}
        oom_html = (
            "<p class=meta><b>OOM forensics:</b> "
            f"<code>{_esc(str(oom.get('error', ''))[:160])}</code> "
            f"(context: {_esc(oom.get('context', ''))}) &middot; dominant "
            f"{_MEM_LABELS.get(oom.get('dominant_class'), '?')} &middot; "
            f"try <code>{_esc(sug.get('knob', ''))}="
            f"{_esc(str(sug.get('value', '')))}</code> — "
            f"{_esc(sug.get('why', ''))}</p>")
    return ("<h2>10 &middot; Where the HBM goes</h2>"
            f"<p class=meta>{' · '.join(headline)}</p>"
            f"<p class=meta>{legend}</p>"
            f"<div class=wf>{''.join(spans)}</div>"
            + "<table><tr><th>class</th><th>GiB</th><th>share</th></tr>"
            + rows + "</table>" + oom_html
            + "<p class=meta>classes sum to the predicted peak exactly; "
              "the measured boundary samples see only resident state "
              "(params/optimizer/sync-state) — see docs/memory.md</p>")


def _render_pipeline(program):
    """Pipeline section (docs/pipelining.md): stages x microbatches, the
    schedule's bubble model vs the measured gauge, and the stage cutter's
    balance table.  Returns "" for unpipelined strategies."""
    from autodist_tpu_torch import observability
    from autodist_tpu_torch.pipeline import cutter, observe
    stages, micro = observe.pipeline_shape(program)
    if stages <= 1:
        return ""
    bubble = observe.predicted_bubble(stages, micro)
    bits = [f"stages <b>{stages}</b>", f"microbatches <b>{micro}</b>",
            f"schedule bubble (S-1)/(S+M-1) &asymp; <b>{bubble:.3f}</b>"]
    if observability.enabled():
        g = observability.registry().gauge("pipeline.bubble_ms_per_step")
        if g.value is not None:
            bits.append(f"priced bubble <b>{g.value:.3f} ms/step</b>")
    cut_html = ""
    cut = cutter.last_cut()
    if cut is not None and cut.stages:
        bits.append(f"stage-cut imbalance <b>{cut.imbalance:.3f}</b> "
                    f"({_esc(cut.source)})")
        total = cut.total_flops or 1.0
        rows = "".join(
            f"<tr><td>{i}</td>"
            f"<td><code>{_esc(', '.join(s['scopes'][:6]))}"
            f"{'…' if len(s['scopes']) > 6 else ''}</code></td>"
            f"<td>{s['flops']:.3e}</td>"
            f"<td>{100.0 * s['flops'] / total:.1f}%</td></tr>"
            for i, s in enumerate(cut.stages))
        cut_html = (
            "<table><tr><th>stage</th><th>scopes</th>"
            "<th>predicted flops</th><th>share</th></tr>" + rows +
            "</table><p class=meta>per-scope predicted FLOPs from "
            "GraphItem.scope_costs(); scope-less equations charged to "
            "their nearest enclosing stage so shares sum to the program "
            "total exactly</p>")
    return (f"<h2>10 &middot; Pipeline</h2>"
            f"<p>{' &middot; '.join(bits)}</p>{cut_html}")


def _render_telemetry():
    """Cluster-wide telemetry section: per-host step-time histograms, the
    phase waterfall, straggler/heartbeat warnings, and this process's
    metric readout.  Covers whatever hosts the last telemetry sync
    gathered (single-process: just this one); returns "" when telemetry
    is off or empty.  Fail-open like every report section."""
    from autodist_tpu_torch import observability
    if not observability.enabled():
        return ""
    snaps = observability.cluster.gathered() or [observability.snapshot()]
    agg = observability.cluster.aggregate(snaps)

    warnings = list(agg["warnings"])
    try:
        # Active monitor anomalies (latency spikes, input-bound flips,
        # heartbeat gaps) join the aggregate's warnings.
        warnings += [f"{a['kind']}: {a['detail']}"
                     for a in observability.monitor.detector().anomalies()]
    except Exception:  # noqa: BLE001 - cosmetic rows only
        pass
    try:
        # Explicit-path anchor guard (ROADMAP 2d): op-sharding anchors
        # the strategy carries but the compiled path could not inject are
        # surfaced, never silently dropped (flight event anchors-skipped).
        skipped = [e for e in observability.recorder.events()
                   if e.get("kind") == "anchors-skipped"]
        if skipped:
            warnings.append(
                f"anchors-skipped: {skipped[-1].get('detail', '')}")
    except Exception:  # noqa: BLE001 - cosmetic rows only
        pass
    warn_html = "".join(f"<p class=warn>&#9888; {_esc(w)}</p>"
                        for w in warnings)

    # Fused multi-step dispatch badge: with unroll=K one dispatch covers
    # K steps and step.latency_ms is per-dispatch/K — flag it so the
    # histogram columns below are read correctly.
    unroll = (snaps[0].get("gauges") or {}).get("step.unroll")
    if unroll and unroll > 1:
        warn_html += (
            f"<p><span class=badge>unroll={_esc(unroll)}</span> fused "
            f"multi-step dispatch: step latencies are per-dispatch/"
            f"{_esc(unroll)}; guard/checkpoint cadence at megastep "
            f"boundaries.</p>")

    # Overlap-efficiency row: the comms no compute hid, measured off the
    # profiler's collective windows (Runner._record_exposed_comms), read
    # against the measured step time. The gauge lands after the loop's
    # cluster sync when the loop was profiled, so the live local registry
    # overlays the gathered snapshot.
    gauges0 = dict(snaps[0].get("gauges") or {})
    try:
        gauges0.update(observability.registry().snapshot().get("gauges")
                       or {})
    except Exception:  # noqa: BLE001 - cosmetic row only
        pass
    exposed = gauges0.get("comms.exposed_ms_per_step")
    if exposed is not None:
        mode = "on" if gauges0.get("step.overlap") else "off"
        p50s = [info["step_ms"].get("p50")
                for info in agg["hosts"].values() if info.get("step_ms")]
        p50s = [p for p in p50s if p]
        eff_html = ""
        if p50s:
            eff = max(0.0, 1.0 - float(exposed) / min(p50s))
            eff_html = (f" &middot; overlap efficiency "
                        f"~{100.0 * eff:.0f}% of step time hidden")
        warn_html += (
            f"<p><span class=badge>overlap={mode}</span> "
            f"comms exposed {_fmt_ms(exposed)} ms/step (measured: the "
            f"collective kernels' time no compute covered, from the "
            f"profiler trace"
            f"{', serialized schedule' if mode == 'off' else ''})"
            f"{eff_html}.</p>")

    host_rows = []
    for host, info in sorted(agg["hosts"].items()):
        h = info["step_ms"]
        dw = info.get("data_wait_ms") or {}
        bound = info.get("bound")
        bound_html = ""
        if bound:
            bound_html = (f"<span class=badge>{_esc(bound)}-bound</span>")
        host_rows.append(
            f"<tr><td>{host}</td><td>{_esc(info.get('pid', ''))}</td>"
            f"<td>{info.get('steps', 0)}</td>"
            f"<td>{_esc(info.get('examples_per_sec') or '')}</td>"
            f"<td>{_fmt_ms(h.get('mean'))}</td>"
            f"<td>{_fmt_ms(h.get('p50'))}</td>"
            f"<td>{_fmt_ms(h.get('p90'))}</td>"
            f"<td>{_fmt_ms(h.get('max'))}</td>"
            f"<td>{_fmt_ms(dw.get('p50'))}</td>"
            f"<td>{bound_html}</td>"
            f"<td>{info.get('age_s', '')}</td></tr>")
    host_table = ""
    if host_rows:
        host_table = (
            "<h3>Per-host step time (windowed, ms)</h3>"
            "<table><tr><th>host</th><th>pid</th><th>steps</th>"
            "<th>examples/s</th><th>mean</th><th>p50</th><th>p90</th>"
            "<th>max</th><th>data-wait p50</th><th>bound</th>"
            "<th>snapshot age (s)</th></tr>"
            + "".join(host_rows) + "</table>")

    # "Where the step goes": stacked per-host attribution bars — the
    # ledger's reconciliation of wall step time into named causes
    # (observability/attribution.py).  Residual renders too: a model
    # gap is information the reader must see, never absorbed.
    attr_html = _render_attribution(agg)

    # Per-layer profile: the per-scope split of the attribution terms.
    try:
        attr_html += _render_profile()
    except Exception as e:  # noqa: BLE001 - cosmetic section only
        logging.debug("report: per-layer profile unavailable: %s", e)

    # Cluster timeline: the cross-host half — per-host step waterfall on
    # the chief-aligned clock + straggler forensics (skew decomposition).
    try:
        attr_html += _render_skew()
    except Exception as e:  # noqa: BLE001 - cosmetic section only
        logging.debug("report: cluster timeline unavailable: %s", e)

    # Phase waterfall from this process's span accumulator: offset =
    # first start, width = cumulative time in that phase.
    phases = (snaps[0].get("phases") or {})
    wf_html = ""
    if phases:
        span_end = max((p["start_ms"] + p["total_ms"])
                       for p in phases.values()) or 1.0
        bars = []
        for name, p in sorted(phases.items(),
                              key=lambda kv: kv[1]["start_ms"]):
            left = 100.0 * p["start_ms"] / span_end
            width = max(0.3, 100.0 * p["total_ms"] / span_end)
            bars.append(
                f"<div class=wflabel>{_esc(name)} &middot; "
                f"{p['total_ms']:.1f}ms &times;{p['count']}</div>"
                f"<div class=wf><span style=\"left:{left:.2f}%;"
                f"width:{min(width, 100 - left):.2f}%\"></span></div>")
        wf_html = ("<h3>Phase waterfall (this process)</h3>"
                   + "".join(bars))

    snap0 = snaps[0]
    metric_rows = []
    for kind in ("counters", "gauges"):
        for name, val in sorted((snap0.get(kind) or {}).items()):
            metric_rows.append(f"<tr><td><code>{_esc(name)}</code></td>"
                               f"<td>{_esc(val)}</td></tr>")
    metric_table = ""
    if metric_rows:
        metric_table = ("<h3>Metrics (this process)</h3>"
                        "<table><tr><th>metric</th><th>value</th></tr>"
                        + "".join(metric_rows) + "</table>")

    flight = snap0.get("events") or []
    flight_html = ""
    if flight:
        import time as _time
        rows = "".join(
            f"<tr><td>{_esc(_time.strftime('%H:%M:%S', _time.localtime(e.get('t', 0))))}"
            f"</td><td><span class=badge>{_esc(e.get('kind'))}</span></td>"
            f"<td>{_esc(e.get('detail'))}</td></tr>"
            for e in flight[-50:])
        flight_html = (
            "<details><summary>flight recorder (last "
            f"{min(len(flight), 50)} events)</summary>"
            "<table><tr><th>time</th><th>kind</th><th>detail</th></tr>"
            + rows + "</table></details>")

    body = warn_html + host_table + attr_html + wf_html + metric_table + \
        flight_html
    if not body:
        return ""
    n_hosts = len(agg["hosts"]) or 1
    return (f"<h2>6 &middot; Telemetry ({n_hosts} host"
            f"{'s' if n_hosts != 1 else ''})</h2>" + body)


def _render_serving():
    """Serving section: request-latency distribution (p50/p99), queue
    depth, padding overhead, and per-replica dispatch/utilization — fed
    by the ``serve.*`` metrics the :mod:`autodist_tpu_torch.serve` runtime
    records.  Returns "" when this process served nothing; fail-open
    like every section."""
    import re as _re
    from autodist_tpu_torch import observability
    if not observability.enabled():
        return ""
    snap = observability.registry().snapshot()
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    hists = snap.get("histograms") or {}
    lat = hists.get("serve.latency_ms") or {}
    if not counters.get("serve.requests") and not lat.get("count"):
        return ""
    bits = [f"{counters.get('serve.requests', 0)} requests over "
            f"{counters.get('serve.batches', 0)} batches",
            f"queue depth {_esc(gauges.get('serve.queue_depth', 0))}",
            f"{counters.get('serve.padded_rows', 0)} padded rows"]
    lat_table = ""
    if lat.get("count"):
        lat_table = (
            "<h3>Request latency (windowed, ms)</h3>"
            "<table><tr><th>count</th><th>mean</th><th>p50</th>"
            "<th>p90</th><th>p99</th><th>max</th></tr>"
            f"<tr><td>{lat.get('count', 0)}</td>"
            f"<td>{_fmt_ms(lat.get('mean'))}</td>"
            f"<td>{_fmt_ms(lat.get('p50'))}</td>"
            f"<td>{_fmt_ms(lat.get('p90'))}</td>"
            f"<td>{_fmt_ms(lat.get('p99'))}</td>"
            f"<td>{_fmt_ms(lat.get('max'))}</td></tr></table>")
    replica_ids = sorted({
        int(m.group(1))
        for source in (counters, gauges)
        for name in source
        if (m := _re.match(r"serve\.replica(\d+)\.", name))})
    rep_table = ""
    if replica_ids:
        rows = "".join(
            f"<tr><td>{i}</td>"
            f"<td>{counters.get(f'serve.replica{i}.dispatches', 0)}</td>"
            f"<td>{_esc(gauges.get(f'serve.replica{i}.outstanding', 0))}</td>"
            f"<td>{_esc(gauges.get(f'serve.replica{i}.utilization', ''))}"
            f"</td></tr>"
            for i in replica_ids)
        rep_table = (
            "<h3>Replicas (least-loaded dispatch)</h3>"
            "<table><tr><th>replica</th><th>dispatches</th>"
            "<th>outstanding</th><th>utilization</th></tr>"
            + rows + "</table>")
    return (f"<h2>8 &middot; Serving</h2>"
            f"<p class=meta>{' · '.join(bits)}</p>" + lat_table + rep_table)


def _prior_report_links(directory, current_name, limit=10):
    """Footer links to earlier per-strategy reports in the dump dir."""
    try:
        pages = [p for p in glob.glob(os.path.join(directory,
                                                   "report_*.html"))
                 if os.path.basename(p) != current_name]
        pages.sort(key=os.path.getmtime, reverse=True)
    except OSError:
        return ""
    if not pages:
        return ""
    links = " &middot; ".join(
        f'<a href="{_esc(os.path.basename(p))}">'
        f"{_esc(os.path.basename(p))}</a>" for p in pages[:limit])
    return f"<p class=meta>prior reports: {links}</p>"


def write_atomic(path, text):
    """Write ``text`` to ``path`` through a temporary file in the same
    directory and ``os.replace``: a reader sees the old file or the new
    one, never a partial write."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _storage_layouts(program):
    """{variable: its stored layout on this rank}, the page's storage
    column: the lowering kind (``ar``, ``zero1``, ``fsdp``, ``tp``,
    ``stale``; ``DistributedProgram.var_kinds``) and what its
    :class:`~autodist_tpu_torch.kernel.graph_transformer.Placement` cuts
    (the piece of each split dim, padding). The JAX page prints each
    variable's ``PartitionSpec`` here."""
    kinds = program.var_kinds()
    out = {}
    for path, pl in flatten_with_path(program.param_placements())[0]:
        name = path_to_name(path)
        kind, dim = kinds.get(name, ("ar", None))
        bits = [kind]
        if kind == "zero1":
            bits.append(f"update dim {dim} / {program.data_axis_size}")
        if pl.dim is not None and pl.shards > 1:
            bits.append(f"dim {pl.dim}: piece {pl.index} of {pl.shards}")
        bits += [f"dim {d}: piece {i} of {n}" for d, i, n in pl.pieces]
        if pl.padding is not None:
            d, logical, padded = pl.padding
            bits.append(f"dim {d} padded {logical}&rarr;{padded}")
        out[name] = ", ".join(bits)
    return out


def render_report(program, step_text=None, execution=None, out_path=None,
                  windows=None):
    """Render the transform report; returns the file path.

    Args:
        program: the DistributedProgram (graph_item + strategy + mesh), a
            Runner's or a server's (``ServeEngine.program``).
        step_text: optional op text of one transformed step
            (``Runner._step_text``) for the compiled-step section.
        execution: what ran the step, for the execution badge:
            ``"eager"`` or ``"CUDA graph"`` (None: not said).
        windows: optional measured collective windows of a profiled loop,
            ``(records, steps)`` (``kernel/overlap.collective_windows``),
            for the compiled-step section's async-pair row.
        out_path: override the default graphs/report_<id>.html location
            (no ``report.html`` alias is written then).
    """
    item = program.graph_item
    strategy = program.strategy
    mesh = program.mesh

    storage = {}
    try:
        storage = _storage_layouts(program)
    except Exception as e:  # noqa: BLE001 - cosmetic column only
        logging.debug("report: storage column unavailable: %s", e)

    node_by_var = {nc.var_name: nc for nc in strategy.proto.node_config}

    rows = []
    for v in item.variables:
        nc = node_by_var.get(v.name)
        rows.append(
            f"<tr><td><code>{_esc(v.name)}</code></td>"
            f"<td>{_esc(tuple(v.shape))}</td>"
            f"<td>{_esc(_dtype_name(v.dtype))}</td>"
            f"<td>{v.size_bytes:,}</td>"
            f"<td>{'sparse' if v.sparse_access else ''}"
            f"{'' if v.trainable else ' frozen'}</td>"
            f"<td>{_esc(_sync_summary(nc)) if nc else '(pruned)'}</td>"
            f"<td><code>{_esc(nc.partitioner) if nc and nc.partitioner else ''}</code></td>"
            f"<td><code>{storage.get(v.name, '')}</code></td></tr>")

    gc = strategy.proto.graph_config
    gc_bits = [f"replicas={len(gc.replicas)}"]
    if getattr(gc, "mesh_axes", None):
        gc_bits.append("mesh_axes=" + _esc(dict(gc.mesh_axes)))
    if getattr(gc, "seq_attn", ""):
        gc_bits.append(f"seq_attn={_esc(gc.seq_attn)}")
    if getattr(gc, "pipeline_microbatches", 0):
        gc_bits.append(f"pipeline_microbatches={gc.pipeline_microbatches}")

    if step_text:
        counts = collective_summary(step_text)
        count_rows = "".join(f"<tr><td>{op}</td><td>{n}</td></tr>"
                             for op, n in sorted(counts.items())) or \
            "<tr><td colspan=2>(no collectives — single device?)</td></tr>"
        kernels = re.findall(r'custom_call_target="([^"]+)"', step_text)
        kernel_html = ""
        if kernels:
            kernel_html = ("<p class=meta>hand-written kernel calls: "
                           + ", ".join(f"<code>{_esc(k)}</code> &times;"
                                       f"{kernels.count(k)}"
                                       for k in sorted(set(kernels)))
                           + "</p>")
        async_html = ""
        if windows:
            try:
                from autodist_tpu_torch.kernel import overlap as _overlap
                records, steps = windows
                hidden = sum(1 for w in records if w["window_ops"])
                async_html = (
                    f"<p class=meta>{len(records)} collective window"
                    f"{'s' if len(records) != 1 else ''} over {steps} "
                    f"step{'s' if steps != 1 else ''} ({hidden} with "
                    f"compute on another stream inside) &middot; comms "
                    f"exposed {_overlap.exposed_collective_ms(records, steps):.3f}"
                    f" ms/step (measured from the profiler trace)</p>")
            except Exception as e:  # noqa: BLE001 - cosmetic row only
                logging.debug("report: collective windows unavailable: %s",
                              e)
        excerpt = step_text[:200_000]
        step_section = f"""
<h2>4 · Compiled step (op text)</h2>
<table><tr><th>collective</th><th>count</th></tr>{count_rows}</table>
{kernel_html}
{async_html}
<details><summary>step text ({len(step_text):,} chars, {step_text.count(chr(10)):,} ops{', truncated'
    if len(excerpt) < len(step_text) else ''})</summary>
<pre>{_esc(excerpt)}</pre></details>"""
    else:
        step_section = ("<h2>4 · Compiled step (op text)</h2><p class=meta>"
                        "Not captured this run — call "
                        "<code>runner.write_report(batch)</code> after a "
                        "step for the step's collective summary and op "
                        "text.</p>")

    trace_section = ""
    # Only include the op trace when capture already traced it (the
    # property traces the loss on first access — too costly for an
    # always-on report).
    traced = getattr(item, "_trace", None)
    if traced is not None and not traced[2]:
        jx = item.jaxpr_text
        trace_section = (f"<details><summary>captured op trace "
                         f"({len(jx):,} chars)</summary>"
                         f"<pre>{_esc(jx[:100_000])}</pre></details>")

    # Resilience events (rollbacks, retries, preemption saves, chaos
    # injections): the post-mortem trail for this process, rendered
    # whenever anything happened.
    resilience_section = ""
    try:
        from autodist_tpu_torch import resilience
        events = resilience.events()
    except Exception:  # noqa: BLE001 - reporting must never kill a run
        events = []
    if events:
        import time as _time
        ev_rows = "".join(
            f"<tr><td>{_esc(_time.strftime('%H:%M:%S', _time.localtime(t)))}"
            f"</td><td><span class=badge>{_esc(kind)}</span></td>"
            f"<td>{_esc(detail)}</td></tr>"
            for t, kind, detail in events[-200:])
        resilience_section = f"""
<h2>5 · Resilience events</h2>
<table><tr><th>time</th><th>kind</th><th>detail</th></tr>{ev_rows}</table>"""

    sections = []
    for render in (_render_telemetry, lambda: _render_pipeline(program),
                   _render_serving, _render_goodput, _render_memory):
        try:
            sections.append(render())
        except Exception as e:  # noqa: BLE001 - reporting must never kill a run
            logging.debug("report: a section is unavailable: %s", e)

    # Run identity: a re-exec generation must be tellable from a fresh
    # run at a glance.
    run_bits = ""
    try:
        from autodist_tpu_torch.observability import goodput as goodput_mod
        gens = {s.get("generation")
                for s in goodput_mod.segments_for()} or {0}
        run_bits = (f" · run <code>{_esc(goodput_mod.run_id())}</code> · "
                    f"generation {goodput_mod.generation()}"
                    + (f" of {len(gens)} observed" if len(gens) > 1 else ""))
    except Exception as e:  # noqa: BLE001 - cosmetic header only
        logging.debug("report: run identity unavailable: %s", e)

    badge = "explicit path" if program.use_explicit_path else "gspmd path"
    if execution:
        badge += f" · {execution}"

    const.ensure_working_dirs()
    directory = (os.path.dirname(os.path.abspath(out_path)) if out_path
                 else const.DEFAULT_GRAPH_DUMP_DIR)
    sid = re.sub(r"[^A-Za-z0-9._-]", "_", str(strategy.id)) or "unknown"
    name = (os.path.basename(out_path) if out_path
            else f"report_{sid}.html")
    footer = _prior_report_links(directory, name)

    doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>autodist_tpu_torch transform report</title><style>{_CSS}</style></head><body>
<h1>autodist_tpu_torch — transform report</h1>
<p class=meta>strategy <code>{_esc(strategy.id)}</code> ·
pid {os.getpid()} ·
execution path <span class=badge>{_esc(badge)}</span>{run_bits}
· this page lives at <code>{_esc(name)}</code>; <code>report.html</code>
always mirrors the latest compile</p>

<h2>1 · Capture</h2>
<p>{len(item.variables)} variables ·
{sum(v.size_bytes for v in item.variables):,} bytes ·
{sum(1 for v in item.variables if v.sparse_access)} sparse-access ·
optimizer <code>{_esc(item.optimizer_name or '(none)')}</code></p>
{trace_section}

<h2>2 · Strategy &amp; 3 · Shardings</h2>
<p class=meta>mesh <code>{_esc(dict(mesh.shape))}</code> over
{mesh.devices.size} devices · graph config: {' · '.join(gc_bits)}</p>
<table>
<tr><th>variable</th><th>shape</th><th>dtype</th><th>bytes</th><th>flags</th>
<th>synchronizer</th><th>partitioner</th><th>storage (this rank)</th></tr>
{''.join(rows)}
</table>
{step_section}
{resilience_section}
{''.join(sections)}
{footer}
</body></html>"""

    path = out_path or os.path.join(directory, name)
    write_atomic(path, doc)
    if out_path is None:
        # Stable alias: report.html always shows the LATEST compile while
        # the per-strategy-id files above keep the history browsable.
        try:
            write_atomic(os.path.join(directory, "report.html"), doc)
        except OSError as e:
            logging.debug("report: could not refresh stable alias: %s", e)
    return path
