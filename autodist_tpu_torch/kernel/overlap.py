"""The overlap scheduler's plan and its measured exposed-comms time.

Counterpart of ``autodist_tpu/kernel/overlap.py``. Two pieces, shared by
the Runner (issue order), the tuner's cost model (pricing) and the report:

* **Bucket plan.** Gradient reductions are bucketed by their fusion key
  (strategy group, compressor, DCN codec, dtype) and split at
  ``AUTODIST_AR_BUCKET_MB``; buckets are issued in the order their last
  gradient is produced by the backward (reverse-layer order), which
  :func:`grad_production_order` reads off one backward on ``meta``
  tensors. The plan is a pure function of the captured program, so every
  rank derives the same issue order with no coordination.

* **Exposed comms, measured.** The JAX package prices the async
  ``-start``/``-done`` pairs of a scheduled HLO text; PyTorch schedules
  nothing ahead of time, so here the windows come from a rank's
  ``torch.profiler`` trace (:func:`trace_events`, :func:`collective_windows`):
  each collective kernel's interval on the card (NCCL's), the compute
  kernels running inside it on other streams, and what is left over, the
  collective time no compute covered. Under gloo (on the CPU, or staging
  CUDA tensors through the host) gloo's work ranges on its worker threads
  stand in for the kernels: the card's kernels (on the CPU, the caller's
  ops) running meanwhile hide them.

The JAX package's XLA-flag functions (``overlap_xla_flags`` /
``apply_overlap_flags``) have no counterpart: the port's overlap is its
own issue order (``runner.py``: each bucket issued ``async_op`` from the
backward as its last gradient arrives, waited on before the update; under
a megastep the zero1 weight all-gather moved into the next step's
forward).
"""
import hashlib
import json
from collections import namedtuple

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

# -- grad-production order ---------------------------------------------------


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def grad_production_order(graph_item):
    """{var_name: the aten position at which the backward produces its
    gradient}: one forward and backward of the captured loss on ``meta``
    tensors (nothing is computed), counting the aten ops dispatched and
    reading the count when each trainable leaf's gradient arrives. The
    backward produces gradients in reverse layer order, and the count is
    the same on every process tracing the same program. Only the order
    agrees with the JAX package's jaxpr positions, not the numbers.
    Returns ``{}`` when the program cannot run on ``meta`` tensors or the
    trace gives no signal (every gradient at one position): callers then
    fall back to the params' flatten order, equally deterministic."""
    from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
    if graph_item.loss_fn is None or graph_item.batch_struct is None:
        return {}
    trainable = {v.name for v in graph_item.trainable_variables}
    try:
        meta_params, params, batch = graph_item._meta_inputs()
        names = [path_to_name(p) for p, _ in
                 flatten_with_path(graph_item.params)[0]]
        counter = _OpCounter()
        order = {}
        leaves = []
        for name, t in zip(names, meta_params):
            if name not in trainable or not t.is_floating_point():
                continue
            t.requires_grad_(True)
            leaves.append((name, t))

            def hook(g, name=name):
                order.setdefault(name, counter.count)
            t.register_hook(hook)
        if not leaves:
            return {}
        with counter:
            out = graph_item.loss_fn(params, batch)
            loss = out[0] if graph_item.aux_output else out
            torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
    except Exception as e:  # noqa: BLE001 - best-effort, order falls back
        logging.debug("grad production order unavailable: %s", e)
        return {}
    end = counter.count
    order = {name: order.get(name, end) for name, _ in leaves}
    if len(set(order.values())) <= 1 and len(order) > 1:
        return {}  # no signal
    return order


# -- bucket plan -------------------------------------------------------------

#: One fused reduction: ``key`` is the fusion key (strategy group,
#: compressor, DCN codec, dtype), ``names`` the member variables in
#: grad-production order, ``bytes`` the wire payload.
Bucket = namedtuple("Bucket", ["key", "names", "bytes"])


def bucket_bytes_cap(bucket_mb=None):
    """Effective fusion-bucket cap in bytes (0 => unbounded: one bucket per
    fusion key)."""
    if bucket_mb is None:
        bucket_mb = const.ENV.AUTODIST_AR_BUCKET_MB.val
    mb = max(0, int(bucket_mb))
    return mb * (1 << 20)


def bucket_plan(members, order=None, cap_bytes=0):
    """Deterministic fused-reduction plan.

    Args:
        members: ``[(name, fusion_key, nbytes)]``: the fusable variables
            with their fusion key and wire payload bytes.
        order: ``{name: production_index}`` from
            :func:`grad_production_order` (missing names sort after known
            ones, by name).
        cap_bytes: split a fusion key's bucket when its payload would
            exceed this (0 = never split).

    Returns the buckets sorted by completion order (the production index of
    each bucket's last gradient), so issuing them in list order matches "as
    gradients become available". Ties break on the key and the names,
    never on dict or hash order.
    """
    order = order or {}
    big = len(order) + len(members) + 1

    def rank(name):
        return (order.get(name, big), name)

    by_key = {}
    for name, key, nbytes in members:
        by_key.setdefault(tuple(key), []).append((name, float(nbytes)))
    buckets = []
    for key in sorted(by_key, key=str):
        entries = sorted(by_key[key], key=lambda e: rank(e[0]))
        cur_names, cur_bytes = [], 0.0
        for name, nbytes in entries:
            if cur_names and cap_bytes and cur_bytes + nbytes > cap_bytes:
                buckets.append(Bucket(key, tuple(cur_names), cur_bytes))
                cur_names, cur_bytes = [], 0.0
            cur_names.append(name)
            cur_bytes += nbytes
        if cur_names:
            buckets.append(Bucket(key, tuple(cur_names), cur_bytes))
    buckets.sort(key=lambda b: (rank(b.names[-1]), str(b.key)))
    return buckets


def plan_fingerprint(buckets):
    """Stable digest of a bucket plan (rank agreement checks)."""
    text = ";".join(f"{b.key}:{','.join(b.names)}:{int(b.bytes)}"
                    for b in buckets)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# -- measured exposed comms --------------------------------------------------

# NCCL kernel name fragment -> the JAX package's collective names.
_NCCL_OPS = (("AllReduce", "all-reduce"), ("AllGather", "all-gather"),
             ("ReduceScatter", "reduce-scatter"), ("SendRecv", "all-to-all"),
             ("AllToAll", "all-to-all"), ("Broadcast", "broadcast"),
             ("Reduce", "reduce"))
# gloo's work range name fragment -> collective name.
_GLOO_OPS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("broadcast", "broadcast"))


def _nccl_op(name):
    for frag, op in _NCCL_OPS:
        if frag in name:
            return op
    return "collective"


def _gloo_op(name):
    """The collective a ``gloo:<op>`` work range is (``None``: not one)."""
    low = name.lower()
    if not low.startswith("gloo:"):
        return None
    for frag, op in _GLOO_OPS:
        if frag in low:
            return op
    return "collective"


def trace_events(trace):
    """``(collectives, compute)`` of a ``torch.profiler`` Chrome trace (a
    path or the loaded document): lists of ``(name, op, lane, start_us,
    dur_us)``.

    * The collectives are the NCCL kernels, each on its stream, where
      there are any; else gloo's work, its ``gloo:<op>`` ranges on its
      worker threads (the transfer, while the caller goes on or waits).
    * The compute is every other kernel on the card, each on its stream;
      with no kernel at all (the CPU), every CPU op but the ``c10d::``
      ones that enqueue the collectives, on its thread.

    A collective is hidden where compute on another lane runs inside its
    interval (:func:`collective_windows`): under gloo on the card, the
    card's kernels that run while the host transfers."""
    if isinstance(trace, dict):
        evs = trace.get("traceEvents") or []
    else:
        with open(trace) as f:
            evs = json.load(f).get("traceEvents") or []
    evs = [e for e in evs if e.get("ph") == "X"]

    def rec(e, op, lane):
        return (e.get("name", ""), op, lane, float(e.get("ts", 0.0)),
                float(e.get("dur", 0.0)))
    kernels = [e for e in evs if e.get("cat") == "kernel"]
    coll, comp = [], []
    for e in kernels:
        lane = (e.get("args") or {}).get("stream", e.get("tid"))
        if e.get("name", "").startswith("nccl"):
            coll.append(rec(e, _nccl_op(e["name"]), lane))
        else:
            comp.append(rec(e, None, lane))
    if not kernels:
        comp = [rec(e, None, ("host", e.get("tid"))) for e in evs
                if e.get("cat") == "cpu_op" and
                not e.get("name", "").startswith("c10d::")]
    if not coll:
        coll = [rec(e, _gloo_op(e["name"]), ("host", e.get("tid")))
                for e in evs if _gloo_op(e.get("name", ""))]
    return coll, comp


def _union_len(intervals):
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def collective_windows(collectives, compute):
    """One record per collective: ``{op, name, lane, ts_us, dur_ms,
    hidden_ms, exposed_ms, window_ops}``, where ``hidden_ms`` is the part of
    its interval covered by compute on another lane (the union of those
    intervals, clipped to it), ``exposed_ms`` the rest and ``window_ops``
    how many compute kernels ran inside it."""
    out = []
    for name, op, lane, ts, dur in collectives:
        end = ts + dur
        inside = [(max(ts, s), min(end, s + d)) for _, _, ln, s, d in compute
                  if ln != lane and s < end and s + d > ts]
        hidden = _union_len(inside)
        out.append({"op": op, "name": name, "lane": lane, "ts_us": ts,
                    "dur_ms": dur / 1e3, "hidden_ms": hidden / 1e3,
                    "exposed_ms": max(0.0, dur - hidden) / 1e3,
                    "window_ops": len(inside)})
    return out


def exposed_collective_ms(windows, steps=1):
    """``comms.exposed_ms_per_step``: the windows' exposed time over
    ``steps`` steps (a megastep's K steps included)."""
    return sum(w["exposed_ms"] for w in windows) / max(1, int(steps))


def overlap_share(windows):
    """The share of the collectives' time that compute hid (0 when there
    were none): the ``step.overlap`` gauge."""
    total = sum(w["dur_ms"] for w in windows)
    return sum(w["hidden_ms"] for w in windows) / total if total > 0 else 0.0
