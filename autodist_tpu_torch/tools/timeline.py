"""Merged cluster timeline: every host's trace + flight log, one file.

``python -m autodist_tpu_torch.tools.timeline <logdir>`` walks a working
directory (or any directory holding per-host artifacts), collects

* ``autodist_trace_*.json`` — each host's Chrome-trace phase spans,
  carrying ``metadata.epoch_anchor_us`` (wall-clock epoch of trace ts 0)
  and the host's KV-estimated ``clock_offset_ms`` vs the chief;
* ``flight_*.jsonl`` — each host's flight-recorder trail (read with the
  torn-final-line-tolerant reader, so a crashed host's log still
  merges);
* ``skew_summary.json`` — the chief's skew decomposition, rendered as
  per-host ``skew-wait`` spans (the barrier time a host spent waiting
  for the straggler);

and emits ONE offset-corrected Chrome-trace JSON: every event timestamp
is rebased onto the chief's clock (``ts_global = epoch_anchor + ts -
clock_offset``), hosts become separate Perfetto track groups
(``process_name`` metadata = "host N"), and flight events land as
instant markers on each host's track — so "host 2 stalled at 12:03:07"
lines up against what every other host was doing at that instant.
Drag the output into https://ui.perfetto.dev.

Counterpart of ``autodist_tpu/tools/timeline.py``: the port's traces
(``observability/tracing.py``), flight logs (``recorder.py``) and skew
summary (``skew.py``) carry the same names and fields, so the merge gives
the same document as the JAX tool on the same directory. A host is a
rank of the ``torch.distributed`` world.

Stdlib-only (torch is not required) so it runs on any box against a
copied-out log directory; the flight logs are read with the port's
torn-line-tolerant reader when the package imports, else with a copy of
it.
"""
import argparse
import glob
import json
import os
import re
import sys


def _find(root, pattern):
    hits = glob.glob(os.path.join(root, pattern))
    hits += glob.glob(os.path.join(root, "**", pattern), recursive=True)
    return sorted(set(hits))


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_traces(root):
    """Per-host trace files -> list of {host, pid, anchor_us, offset_ms,
    events}; files without an epoch anchor still merge (anchor 0) but are
    flagged unaligned."""
    out = []
    for path in _find(root, "autodist_trace_*.json"):
        doc = _read_json(path)
        if not isinstance(doc, dict):
            continue
        meta = doc.get("metadata") or {}
        out.append({
            "path": path,
            "host": int(meta.get("host", 0)),
            "pid": meta.get("pid"),
            "anchor_us": float(meta.get("epoch_anchor_us") or 0.0),
            "offset_ms": float(meta.get("clock_offset_ms") or 0.0),
            "aligned": "epoch_anchor_us" in meta,
            "events": doc.get("traceEvents") or [],
        })
    return out


def merge(root):
    """Merge every per-host artifact under ``root`` into one
    Chrome-trace document (pure function; the CLI writes it out).

    Timestamp discipline: every source timestamp is first mapped to
    wall-clock epoch microseconds on the CHIEF's clock (trace ts via the
    file's epoch anchor, flight ``t`` fields directly — both minus the
    host's estimated clock offset), then the whole merged set is rebased
    to its earliest event so Perfetto renders from t=0.
    """
    traces = _load_traces(root)
    skew_doc = None
    for path in _find(root, "skew_summary*.json"):
        skew_doc = _read_json(path) or skew_doc
    pid_to_host = {t["pid"]: t["host"] for t in traces
                   if t["pid"] is not None}
    offset_by_host = {t["host"]: t["offset_ms"] for t in traces}
    for h, row in ((skew_doc or {}).get("hosts") or {}).items():
        offset_by_host.setdefault(int(h), row.get("offset_ms") or 0.0)

    staged = []  # (global_us, event dict sans ts)
    hosts = set()

    for t in traces:
        hosts.add(t["host"])
        shift_us = t["anchor_us"] - t["offset_ms"] * 1e3
        for ev in t["events"]:
            ev = dict(ev)
            ts = float(ev.get("ts", 0.0))
            ev["pid"] = t["host"]
            staged.append((ts + shift_us, ev))

    truncated = []
    flight_counts = {}
    try:
        from autodist_tpu_torch.observability import recorder
        read_jsonl = recorder.read_jsonl
    except Exception:  # noqa: BLE001 - tool must run without the package's deps
        def read_jsonl(path):
            events, torn = [], False
            with open(path) as f:
                raw = f.read()
            lines = raw.split("\n")
            if raw and not raw.endswith("\n"):
                lines, torn = lines[:-1], True
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    torn = True
                    continue
                if isinstance(entry, dict):
                    events.append(entry)
                else:
                    torn = True
            return events, torn

    for path in _find(root, "flight_*.jsonl"):
        try:
            events, torn = read_jsonl(path)
        except OSError:
            continue
        if torn:
            truncated.append(path)
        base = os.path.basename(path)
        m = re.match(r"flight_(\d+)(?:_\d+)?\.jsonl$", base)
        pid = int(m.group(1)) if m else None
        host = pid_to_host.get(pid, 0)
        hosts.add(host)
        off_us = offset_by_host.get(host, 0.0) * 1e3
        flight_counts[path] = len(events)
        for entry in events:
            staged.append((float(entry.get("t", 0.0)) * 1e6 - off_us, {
                "name": str(entry.get("kind", "event")),
                "cat": "flight", "ph": "i", "s": "p",
                "pid": host, "tid": 99,
                "args": {"detail": str(entry.get("detail", ""))[:200]},
            }))

    # Skew-wait spans: the window each host spent blocked on the
    # straggler, placed at its collective-ready time (already on the
    # chief's clock — the decomposition aligned them).
    for h, row in ((skew_doc or {}).get("hosts") or {}).items():
        host = int(h)
        hosts.add(host)
        for w in row.get("windows") or ():
            k = max(1, int(w.get("k", 1)))
            wait_us = float(w.get("skew_wait_ms", 0.0)) * k * 1e3
            if wait_us <= 0:
                continue
            exposed_us = float(w.get("exposed_comms_ms", 0.0)) * k * 1e3
            ready_us = float(w.get("e", 0.0)) * 1e6 - exposed_us
            staged.append((ready_us, {
                "name": "skew-wait", "cat": "skew", "ph": "X",
                "dur": round(wait_us, 1), "pid": host, "tid": 98,
                "args": {"step": str(w.get("i")),
                         "straggler": str(w.get("straggler"))},
            }))

    if not staged:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "metadata": {"hosts": [], "sources": 0}}

    base_us = min(g for g, _ in staged)
    events = []
    for g, ev in staged:
        ev["ts"] = round(g - base_us, 1)
        events.append(ev)
    events.sort(key=lambda e: (e.get("pid", 0), e["ts"]))
    # Per-host track groups: name + stable ordering in the Perfetto UI.
    for host in sorted(hosts):
        events.insert(0, {"name": "process_sort_index", "ph": "M",
                          "pid": host, "args": {"sort_index": host}})
        events.insert(0, {"name": "process_name", "ph": "M", "pid": host,
                          "args": {"name": f"host {host}"}})
    meta = {
        "hosts": sorted(hosts),
        "sources": len(traces) + len(flight_counts),
        "base_epoch_us": round(base_us, 1),
        "unaligned_traces": [t["path"] for t in traces
                             if not t["aligned"]],
    }
    if truncated:
        # Torn final lines (crash mid-write) were skipped, not fatal.
        meta["truncated"] = True
        meta["truncated_flight_logs"] = truncated
    if skew_doc and skew_doc.get("straggler"):
        meta["straggler"] = skew_doc["straggler"]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.tools.timeline",
        description="Merge per-host traces + flight logs into one "
                    "offset-corrected Perfetto timeline")
    ap.add_argument("logdir", help="directory holding autodist_trace_*."
                                   "json / flight_*.jsonl / "
                                   "skew_summary.json (searched "
                                   "recursively, e.g. the "
                                   "AUTODIST_WORKING_DIR)")
    ap.add_argument("--out", default=None,
                    help="output path (default <logdir>/timeline.json)")
    args = ap.parse_args(argv)
    doc = merge(args.logdir)
    n = len([e for e in doc["traceEvents"] if e.get("ph") != "M"])
    if not n:
        sys.stderr.write(f"timeline: nothing to merge under "
                         f"{args.logdir}\n")
        return 1
    out = args.out or os.path.join(args.logdir, "timeline.json")
    with open(out, "w") as f:
        json.dump(doc, f)
    meta = doc["metadata"]
    sys.stdout.write(
        f"timeline: merged {n} events from {meta['sources']} files "
        f"across hosts {meta['hosts']} -> {out}\n")
    if meta.get("truncated"):
        sys.stdout.write(
            "timeline: note: truncated (torn final line) flight logs "
            f"were tolerated: {meta['truncated_flight_logs']}\n")
    if meta.get("straggler"):
        s = meta["straggler"]
        sys.stdout.write(f"timeline: straggler verdict: {s['detail']}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
