"""Continuously-batched inference server.

Counterpart of ``autodist_tpu/serve/server.py``. Request lifecycle::

    submit(batch) -> Future          # any leading-dim size that fits a bucket
      -> coalescer (FIFO queue): requests group into the smallest
         admissible bucket under a max-wait deadline (the OLDEST request
         in a group bounds its wait — a lone request is never starved)
      -> least-loaded replica: the group's rows are packed FIFO into a
         zero-padded bucket batch and enqueued on the replica with the
         fewest outstanding dispatches
      -> replica executor: the depth-N prefetch window copies the batch to
         the replica's device (the copy overlaps the current forward), the
         forward runs on the resident params, outputs come back to host
      -> de-padding: each request's exact rows are sliced back out, in
         submission order, and resolve its Future.

Answers are CPU tensors. Telemetry (off under ``AUTODIST_TELEMETRY=0``):
``serve.requests``, ``serve.batches``, ``serve.padded_rows`` (counters),
``serve.queue_depth``, ``serve.replicas``, ``serve.slo_burn`` (the
windowed p99 over ``AUTODIST_SERVE_SLO_MS``; above 1 the p99 misses the
target) and ``serve.replica{i}.outstanding`` / ``.utilization``
(gauges), ``serve.replica{i}.dispatches`` and the ``serve.latency_ms``
histogram (submit to answer). Tuner feedback and replica removal are not
ported yet (ROADMAP.md).
"""
import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.observability.metrics import _quantile
from autodist_tpu_torch.serve.buckets import buckets_from_env, pick_bucket
from autodist_tpu_torch.serve.engine import ServeEngine
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import flatten, leaves, tree_map, unflatten

_STOP = object()
_LATENCY_WINDOW = 4096  # latencies kept for stats()' percentiles


class _Request:
    __slots__ = ("seq", "batch", "rows", "seq_len", "future", "t_submit")

    def __init__(self, seq, batch, rows, seq_len=None):
        self.seq = seq
        self.batch = batch
        self.rows = rows
        self.seq_len = seq_len   # dim-1 length under (rows, seq) buckets
        self.future = Future()
        self.t_submit = time.perf_counter()


class Server:
    """Continuously-batched serving front-end over a :class:`ServeEngine`.

    Args:
        apply_fn: ``(params, batch) -> outputs`` forward function over
            tensors; outputs must be batch-major (leading dim = batch rows)
            and row-independent (padding rows are zeros and are sliced
            off, they must not perturb real rows).
        params: nested dict of tensors (placed once per replica, never
            written).
        example_batch: example request tree (numpy arrays or tensors); dim
            0 is the batch dimension, trailing dims/dtypes are the contract
            every request must match.
        buckets: padded batch sizes to warm up (default:
            ``AUTODIST_SERVE_BUCKETS``, else ``(8, 32, 128)``). Each must
            be a multiple of the per-replica device count.
        max_wait_ms: continuous-batching coalesce deadline (default
            ``AUTODIST_SERVE_MAX_WAIT_MS``): how long the oldest queued
            request may wait for companions before its bucket dispatches.
        replicas: independent model replicas to carve the devices into
            (least-loaded dispatch; data-only strategies).
        device: ``"cuda"`` (default), ``"cuda:i"`` or ``"cpu"``; see
            :class:`ServeEngine`.
    """

    def __init__(self, apply_fn, params, example_batch, buckets=None,
                 max_wait_ms=None, replicas=1, strategy_builder=None,
                 resource_spec=None, prefetch_depth=None, device="cuda"):
        bucket_list = buckets_from_env() if buckets is None else buckets
        self._engine = ServeEngine(apply_fn, params, example_batch,
                                   bucket_list,
                                   resource_spec=resource_spec,
                                   strategy_builder=strategy_builder,
                                   replicas=replicas, device=device)
        self._obs = observability if observability.enabled() else None
        self._buckets = self._engine.buckets
        self._bucket_rank = self._engine.bucket_rank
        self._max_rows = self._engine.max_rows
        if max_wait_ms is None:
            max_wait_ms = const.ENV.AUTODIST_SERVE_MAX_WAIT_MS.val
        self._max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._seq = itertools.count()
        self._rq = queue.Queue()
        self._closed = False
        self._requests = 0
        self._batches = 0
        self._padded_rows = 0
        self._completed = 0
        self._latencies_ms = collections.deque(maxlen=_LATENCY_WINDOW)
        self._stats_lock = threading.Lock()
        self.last_dispatch = None  # {"bucket", "replica", "assignments"}
        self._struct = [(tuple(s.shape), s.dtype) for s in
                        leaves(self._engine.item.batch_struct)]
        self._treedef = flatten(example_batch)[1]
        if self._obs is not None:
            self._obs.registry().gauge("serve.replicas").set(
                len(self._engine.replicas))
        self._engine.start(self._complete, depth=prefetch_depth)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="autodist-serve-dispatcher")
        self._dispatcher.start()
        logging.info("serve: server up — %d replica(s), buckets %s, "
                     "max_wait %.1fms", len(self._engine.replicas),
                     [b[0] for b in self._buckets], self._max_wait_s * 1e3)

    # -- public API ----------------------------------------------------------

    @property
    def engine(self):
        return self._engine

    def submit(self, batch):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the de-padded outputs for exactly these rows.
        Raises immediately (not on the future) for malformed or oversize
        requests — admission control, not queue poison."""
        if self._closed:
            raise RuntimeError("serve.Server is closed")
        flat, treedef = flatten(batch)
        if treedef != self._treedef:
            raise ValueError(
                f"request structure {treedef} != example_batch structure "
                f"{self._treedef}")
        rank = self._bucket_rank
        rows = seq_len = None
        for leaf, (shape, _dtype) in zip(flat, self._struct):
            got = tuple(int(d) for d in np.shape(leaf))
            # Under (rows, seq) buckets the first TWO dims are padded, so
            # only dims beyond the bucket rank are a fixed contract;
            # ragged prompts vary dim 1 request to request.
            if len(got) != len(shape) or got[rank:] != shape[rank:]:
                raise ValueError(
                    f"request leaf shape {got} incompatible with compiled "
                    f"trailing dims {shape[rank:]} (rank {len(shape)})")
            if rows is None:
                rows = got[0]
                seq_len = got[1] if rank == 2 else None
            elif got[0] != rows or (rank == 2 and got[1] != seq_len):
                raise ValueError(
                    f"request leaves disagree on padded leading dims: "
                    f"{got[:rank]} vs {(rows, seq_len)[:rank]}")
        if not rows:
            raise ValueError("empty request (0 rows)")
        dims = (rows,) if rank == 1 else (rows, seq_len)
        pick_bucket(dims, self._buckets)  # oversize -> loud ValueError
        req = _Request(next(self._seq), batch, rows, seq_len=seq_len)
        with self._stats_lock:
            self._requests += 1
        self._rq.put(req)
        if self._obs is not None:
            reg = self._obs.registry()
            reg.counter("serve.requests").inc()
            reg.gauge("serve.queue_depth").set(self._rq.qsize())
        return req.future

    def infer(self, batch, timeout=None):
        """Synchronous convenience wrapper: ``submit(batch).result()``."""
        return self.submit(batch).result(timeout=timeout)

    def stats(self):
        """Counters, per-replica dispatch accounting, and the p50/p99 of
        the last ``_LATENCY_WINDOW`` request latencies (submit to answer,
        ms; nearest rank, as the registry's histograms read theirs)."""
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            out = {
                "requests": self._requests,
                "completed": self._completed,
                "batches": self._batches,
                "padded_rows": self._padded_rows,
            }
        out.update({
            "queue_depth": self._rq.qsize(),
            "buckets": [b[0] for b in self._buckets],
            "latency_ms": {"p50": _quantile(lat, 0.50),
                           "p99": _quantile(lat, 0.99)},
            "replicas": [{
                "index": r.index,
                "dispatches": r.dispatches,
                "outstanding": r.outstanding,
                "utilization": round(r.utilization, 4),
            } for r in self._engine.replicas],
        })
        return out

    def close(self):
        """Drain queued requests, stop the dispatcher and replicas."""
        if self._closed:
            return
        self._closed = True
        self._rq.put(_STOP)
        self._dispatcher.join(timeout=60)
        self._engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- continuous batching -------------------------------------------------

    def _dispatch_loop(self):
        carry = None
        while True:
            req = carry if carry is not None else self._rq.get()
            carry = None
            if req is _STOP:
                break
            group, rows = [req], req.rows
            # The OLDEST request bounds the group's wait: coalescing may
            # only ever delay a request by max_wait, never starve it.
            deadline = req.t_submit + self._max_wait_s
            while rows < self._max_rows:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._rq.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    carry = _STOP
                    break
                if rows + nxt.rows > self._max_rows:
                    carry = nxt  # doesn't fit: next group starts with it
                    break
                group.append(nxt)
                rows += nxt.rows
            try:
                self._dispatch(group, rows)
            except Exception as e:  # noqa: BLE001 - fail the group's futures
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
            if carry is _STOP:
                break
        # Drain anything still queued after close(): fail fast, don't hang
        # callers on futures that will never resolve.
        while True:
            try:
                item = self._rq.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP and not item.future.done():
                item.future.set_exception(
                    RuntimeError("serve.Server closed before dispatch"))

    def _group_bucket(self, group, rows):
        """The (deterministic) bucket a group dispatches at: total rows,
        and under (rows, seq) buckets the group's max sequence length."""
        if self._bucket_rank == 1:
            return pick_bucket((rows,), self._buckets)
        return pick_bucket((rows, max(r.seq_len for r in group)),
                           self._buckets)

    def _dispatch(self, group, rows):
        bucket = self._group_bucket(group, rows)
        rank = self._bucket_rank
        # Pack FIFO: request i occupies rows [lo_i, lo_i + rows_i); the
        # padding tail is zeros, sliced off before anyone sees it. Under
        # (rows, seq) buckets each request's dim 1 pads to the bucket seq
        # the same way — zero columns on the right.
        flats = [flatten(r.batch)[0] for r in group]
        out = []
        for j, (shape, dtype) in enumerate(self._struct):
            buf = np.zeros(bucket + shape[rank:], dtype)
            lo = 0
            for r, flat in zip(group, flats):
                if rank == 2:
                    buf[lo:lo + r.rows, :r.seq_len] = np.asarray(flat[j])
                else:
                    buf[lo:lo + r.rows] = np.asarray(flat[j])
                lo += r.rows
            out.append(buf)
        batch = unflatten(self._treedef, out)
        replica = self._engine.least_loaded()
        assignments, lo = [], 0
        for r in group:
            assignments.append((r.seq, lo, lo + r.rows))
            lo += r.rows
        self.last_dispatch = {
            "bucket": bucket[0] if rank == 1 else bucket,
            "replica": replica.index, "assignments": assignments}
        with self._stats_lock:
            self._batches += 1
            self._padded_rows += bucket[0] - rows
        replica.enqueue(batch, group, rows)
        if self._obs is not None:
            reg = self._obs.registry()
            reg.counter("serve.batches").inc()
            reg.counter("serve.padded_rows").inc(bucket[0] - rows)
            reg.gauge("serve.queue_depth").set(self._rq.qsize())
            reg.gauge(f"serve.replica{replica.index}.outstanding").set(
                replica.outstanding)

    # -- completion (called on replica executor threads) ---------------------

    def _complete(self, replica, group, host_out, rows):
        bseq = self._group_bucket(group, rows)[1] \
            if self._bucket_rank == 2 else None
        now = time.perf_counter()
        # Count before resolving: a caller that reads stats() right after
        # its answer arrives sees it counted.
        lat_ms = [(now - r.t_submit) * 1e3 for r in group]
        with self._stats_lock:
            self._completed += len(group)
            self._latencies_ms.extend(lat_ms)
        if self._obs is not None:
            reg = self._obs.registry()
            hist = reg.histogram("serve.latency_ms")
            hist.observe_many(lat_ms)
            # SLO burn: the windowed p99 over the target; above 1 the p99
            # misses it (the pager gauge the autoscaler reads).
            p99 = hist.summary().get("p99")
            if p99 is not None:
                slo = max(1, const.ENV.AUTODIST_SERVE_SLO_MS.val)
                reg.gauge("serve.slo_burn").set(round(p99 / slo, 4))
            i = replica.index
            reg.counter(f"serve.replica{i}.dispatches").inc()
            reg.gauge(f"serve.replica{i}.outstanding").set(
                replica.outstanding)
            reg.gauge(f"serve.replica{i}.utilization").set(
                round(replica.utilization, 4))
        lo = 0
        for r in group:
            hi = lo + r.rows

            def depad(a, _lo=lo, _hi=hi, _seq=r.seq_len):
                # Under (rows, seq) buckets, outputs that kept the padded
                # seq dim at axis 1 are sliced back to this request's
                # length; other outputs (pooled heads etc.) pass through.
                if bseq is not None and a.dim() >= 2 and a.shape[1] == bseq:
                    return a[_lo:_hi, :_seq]
                return a[_lo:_hi]
            r.future.set_result(tree_map(depad, host_out))
            lo = hi
