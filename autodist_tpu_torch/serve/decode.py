"""Autoregressive decode engine: KV-cache continuous batching.

Counterpart of ``autodist_tpu/serve/decode.py``: token-level continuous
batching over a preallocated KV cache, where requests join and leave the
in-flight batch at every decode step.

* **Slots, not batches.** Each replica holds one *lane* per
  ``(slots, cache_len)`` bucket: the decode step, a device-resident KV
  cache and a host-side slot table. A request occupies one slot from
  admission to completion; a freed slot refills from the FIFO queue at the
  next step.
* **One CUDA graph per lane.** The JAX package compiles each lane's step
  ahead of time; here the lane captures its step once as a CUDA graph over
  static ``tokens`` / ``pos`` buffers, the cache and the placed params, and
  replays it every step. The graph ends in the greedy argmax, so only the
  (slots,) token ids come back to the host, into pinned memory. On the CPU
  the lane calls the step eagerly.
* **Prefill through the decode path.** Prompts feed token by token through
  the same step (logits ignored until the last prompt token), so one step
  mixes prefilling and decoding slots.
* **The cache is a pure optimization.** Rows past a slot's position are
  masked to exactly zero probability (``layers.mha_decode``), so a freed
  slot's stale rows change nothing, bitwise.
* **Zero-drop scaling.** All request state (prompt + generated tokens) is
  host-side: :meth:`DecodeEngine.scale_to` drains every in-flight request,
  re-carves the devices, and re-queues the drained requests at the front
  in submission order. Greedy continuation re-prefills prompt + generated,
  so a scale event drops no request and changes no token.

* **A bucket that cannot fit is refused by name.** Before any parameter
  placement, cache allocation or capture, each (slots, cache_len)
  bucket's predicted peak — the forward's footprint at
  ``batch_rows=slots`` plus its KV cache as the ledger's own
  ``kv_cache_bytes`` class — is held to the card's capacity x
  ``AUTODIST_MEM_HEADROOM`` (``InfeasibleMemoryError``); a capture or a
  step that dies of memory writes the OOM forensics first.

Telemetry (off under ``AUTODIST_TELEMETRY=0``): the ``capture`` /
``strategy-build`` spans (``kind="decode"``), one ``serve-aot-compile``
span and ``serve.aot_compile.ms`` gauge per lane capture, the
``serve-start`` / ``serve-scale`` / ``serve-stop`` events, the
``decode.*`` counters (``requests``, ``steps``, ``tokens``,
``scale_events``), gauges (``queue_depth``, ``active_slots``,
``replicas``, ``tokens_per_sec``) and ``decode.latency_ms`` histogram,
and the ``serve.slo_burn`` gauge the one-shot server also keeps.

Not ported yet (ROADMAP.md): the autoscaler.
"""
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.cluster import local_devices
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.serve.buckets import normalize_buckets
from autodist_tpu_torch.serve.engine import (ReplicaRuntime,
                                             _oom_forensics,
                                             _resolve_serve_builder,
                                             bucket_memory_model,
                                             build_replica_programs,
                                             refuse_infeasible, serve_spec)
from autodist_tpu_torch.utils import cuda_graph, logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import leaves


def decode_buckets_from_env():
    """Default decode bucket list: one ``(slots, cache_len)`` bucket from
    ``AUTODIST_DECODE_SLOTS`` x ``AUTODIST_DECODE_CACHE_LEN``."""
    return ((max(1, const.ENV.AUTODIST_DECODE_SLOTS.val),
             max(1, const.ENV.AUTODIST_DECODE_CACHE_LEN.val)),)


class DecodeRequest:
    """One in-flight generation. All its state is host-side (prompt +
    tokens generated so far), so a scale event can evict it from its slot
    and re-dispatch it: the continuation re-prefills ``prompt +
    generated``."""

    __slots__ = ("seq", "prompt", "max_new_tokens", "eos", "generated",
                 "future", "t_submit", "redispatches")

    def __init__(self, seq, prompt, max_new_tokens, eos=None):
        self.seq = seq
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos = None if eos is None else int(eos)
        self.generated = []
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.redispatches = 0

    @property
    def tokens(self):
        """The input stream: prompt, then everything generated so far."""
        return self.prompt + self.generated

    @property
    def need(self):
        """Cache rows this request can ever touch: admission fits it only
        into lanes with ``cache_len >= need``."""
        return len(self.prompt) + self.max_new_tokens


class _Slot:
    __slots__ = ("req", "pos")

    def __init__(self, req):
        self.req = req
        self.pos = 0   # next cache position to write (tokens fed so far)


class _Lane:
    """One (slots, cache_len) bucket on one replica: the step, its KV
    cache, static input buffers and the slot table.

    On a CUDA device the step (``decode_fn``, then the greedy argmax) is
    captured once as a CUDA graph (``utils/cuda_graph.py``); ``logits`` and
    ``ids`` are its static outputs, and only ``ids`` is copied to the host.
    On the CPU ``_run`` calls the step eagerly."""

    def __init__(self, replica, slots, cache_len, decode_fn, cache):
        self.replica = replica
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.fn = decode_fn
        self.cache = cache
        self.device = replica.remapper.device
        self.table = [None] * self.slots
        self.steps = 0
        cuda = self.device.type == "cuda"
        self.tokens = torch.zeros(self.slots, dtype=torch.long,
                                  device=self.device)
        self.pos = torch.zeros_like(self.tokens)
        self._host = [torch.zeros(self.slots, dtype=torch.long,
                                  pin_memory=cuda) for _ in range(3)]
        self._step_graph = cuda_graph.Graph(
            cuda_graph.weak_call(self, type(self)._compute), self.device)
        self.graph = None
        self.logits = self.ids = None
        if cuda:
            # The warm-up, then the capture (utils/cuda_graph.py); the
            # warm-up's cache write is zeroed.
            self._step_graph()
            for t in leaves(self.cache):
                t.zero_()
            torch.cuda.synchronize(self.device)
            self.graph = self._step_graph.graph

    def _compute(self):
        """The step on the static buffers: (logits (slots, vocab) f32,
        greedy ids (slots,) int64, the first maximum on ties as
        ``np.argmax`` takes it). Writes the cache in place; never the
        params."""
        with torch.inference_mode():
            logits, _ = self.fn(self.replica.params, self.cache, self.tokens,
                                self.pos)
            return logits, logits.argmax(-1)

    def _run(self, tok, pos):
        """One step at host ``tok`` / ``pos`` (slots,); returns the greedy
        ids as a host numpy array."""
        tok_h, pos_h, ids_h = self._host
        tok_h.numpy()[:] = tok
        pos_h.numpy()[:] = pos
        if self.graph is None:
            self.tokens.copy_(tok_h)
            self.pos.copy_(pos_h)
            self.logits, self.ids = self._step_graph()
            return self.ids.numpy()
        with torch.cuda.device(self.device):
            # Pinned buffers, reused only after the synchronize below.
            self.tokens.copy_(tok_h, non_blocking=True)
            self.pos.copy_(pos_h, non_blocking=True)
            self.logits, self.ids = self._step_graph()
            ids_h.copy_(self.ids, non_blocking=True)
            torch.cuda.current_stream().synchronize()
        return ids_h.numpy()

    @property
    def active(self):
        return sum(1 for s in self.table if s is not None)

    def free_slot(self):
        for i, s in enumerate(self.table):
            if s is None:
                return i
        return None

    def place(self, req):
        i = self.free_slot()
        self.table[i] = _Slot(req)
        return i

    def evict_all(self):
        """Pull every in-flight request out (scale drain, close). Slot
        positions are dropped: a continuation re-prefills from the
        request's host-side tokens."""
        reqs = [s.req for s in self.table if s is not None]
        self.table = [None] * self.slots
        return reqs

    def release(self):
        """Drop the graph (and its memory pool), the outputs and the
        cache."""
        self._step_graph.release()
        self.graph = None
        self.logits = self.ids = None
        self.cache = None

    def step(self):
        """One decode step over every active slot; returns
        ``(completed_requests, tokens_generated)``. Inactive slots feed
        token 0 at position 0: a future occupant's prefill overwrites
        position 0 before the mask ever exposes it."""
        tok = np.zeros((self.slots,), np.int64)
        pos = np.zeros((self.slots,), np.int64)
        emit = []
        for i, s in enumerate(self.table):
            if s is None:
                continue
            toks = s.req.tokens
            tok[i] = toks[s.pos]
            pos[i] = s.pos
            if s.pos == len(toks) - 1:
                emit.append(i)   # last known token: its logits pick the next
        ids = self._run(tok, pos)
        self.steps += 1
        completed = []
        for s in self.table:
            if s is not None:
                s.pos += 1
        for i in emit:
            req = self.table[i].req
            nxt = int(ids[i])
            req.generated.append(nxt)
            if len(req.generated) >= req.max_new_tokens or \
                    (req.eos is not None and nxt == req.eos):
                completed.append(req)
                self.table[i] = None      # slot freed: refilled next step
        return completed, len(emit)


class DecodeReplica(ReplicaRuntime):
    """A :class:`ReplicaRuntime` (device, placed never-written params)
    whose programs are decode lanes. The base class's dispatch queue is
    unused: lanes step synchronously on the engine's replica thread."""

    def __init__(self, index, program, decode_fn, obs=None):
        super().__init__(index, program, decode_fn, obs=obs)
        self.lanes = []

    def compile_decode(self, bucket, init_cache_fn, decode_fn):
        """Allocate one (slots, cache_len) bucket's KV cache on this
        replica's device and build its lane (on a CUDA device: the step
        captured as a CUDA graph). ``slots`` must divide by the replica's
        data-axis size, as a request batch must."""
        slots, cache_len = int(bucket[0]), int(bucket[1])
        obs = self._obs
        t0 = time.perf_counter()
        with (obs.span("serve-aot-compile", bucket=f"{slots}x{cache_len}",
                       replica=self.index) if obs is not None
              else observability.tracing.NULL_SPAN):
            cache = init_cache_fn(slots, cache_len,
                                  device=self.remapper.device)
            lane = _Lane(self, slots, cache_len, decode_fn, cache)
        dt_ms = (time.perf_counter() - t0) * 1e3
        logging.info("decode: replica %d built bucket %dx%d (%s, %.0fms)",
                     self.index, slots, cache_len,
                     "CUDA graph" if lane.graph is not None else "eager",
                     dt_ms)
        if obs is not None:
            obs.registry().gauge("serve.aot_compile.ms").set(round(dt_ms, 3))
            obs.record_event("serve-compile",
                             f"decode replica {self.index} bucket "
                             f"{slots}x{cache_len} ({dt_ms:.0f}ms)")
        self.lanes.append(lane)
        return lane

    def best_lane_for(self, req):
        """The smallest-cache lane with a free slot that fits ``req``
        (deterministic; ``None`` when nothing here fits right now)."""
        fits = [ln for ln in self.lanes
                if ln.cache_len >= req.need and ln.free_slot() is not None]
        return min(fits, key=lambda ln: (ln.cache_len, ln.slots)) \
            if fits else None

    @property
    def active(self):
        return sum(ln.active for ln in self.lanes)

    def release(self):
        """Drop this replica's graphs, caches and params after a scale
        event replaced it."""
        for lane in self.lanes:
            lane.release()
        self.lanes = []
        self.params = None


class DecodeEngine:
    """capture -> strategy -> per-replica decode lanes, plus the
    continuous-batching step loops (one thread per replica) and the
    zero-drop :meth:`scale_to`. :class:`DecodeServer` owns request
    admission in front of this. ``init_cache_fn(slots, cache_len, device=)``
    allocates one lane's cache on its replica's device; ``device`` is as
    :class:`~autodist_tpu_torch.serve.engine.ServeEngine`'s."""

    def __init__(self, apply_fn, decode_fn, init_cache_fn, params,
                 example_batch, buckets=None, resource_spec=None,
                 strategy_builder=None, replicas=1, device="cuda"):
        device = resolve_device(device)
        bucket_list = decode_buckets_from_env() if buckets is None \
            else buckets
        self.buckets = normalize_buckets(bucket_list)
        if any(len(b) != 2 for b in self.buckets):
            raise ValueError(
                f"decode buckets are (slots, cache_len) pairs; got "
                f"{self.buckets}")
        self._decode = decode_fn
        self._init_cache = init_cache_fn
        # The strategy machinery carves the FORWARD program; decode reuses
        # its placement and device carving.
        with observability.span("capture", kind="decode"):
            self.item = GraphItem.capture(apply_fn, params, None,
                                          example_batch=example_batch)
        self._spec = serve_spec(resource_spec, device)
        builder = _resolve_serve_builder(strategy_builder)
        with observability.span("strategy-build", kind="decode"):
            self.strategy = builder.build(self.item, self._spec)
        logging.info("decode: strategy %s via %s", self.strategy.id,
                     type(builder).__name__)
        self._validate_bucket_memory(self._spec)
        self._obs = observability if observability.enabled() else None
        self._queue = deque()
        self._cv = threading.Condition()
        self._pause = False
        self._closed = False
        self._threads = []
        self._on_complete = None
        self.scale_events = 0
        self.replicas = []
        self._build_fleet(int(replicas))
        observability.record_event(
            "serve-start", f"decode engine: {len(self.replicas)} "
            f"replica(s), buckets "
            f"{['x'.join(map(str, b)) for b in self.buckets]}, "
            f"strategy {self.strategy.id}")

    def bucket_memory(self, spec, bucket):
        """The predicted ``MemoryBreakdown`` of one (slots, cache_len)
        bucket: the forward's footprint at ``batch_rows=slots`` and the
        lane's KV cache as its own class."""
        slots, cache_len = bucket
        return bucket_memory_model(spec).strategy_memory(
            self.strategy, self.item, batch_rows=slots,
            kv_cache_bytes=self.cache_bytes(slots, cache_len))

    def _validate_bucket_memory(self, spec):
        """Refuse over-capacity decode buckets before any placement,
        cache allocation or capture: the KV cache is priced as its own
        ledger class (``kv_cache_bytes``) on top of the forward's
        footprint at ``batch_rows=slots``. Fail-open: only a positive
        refusal propagates, and a check that cannot evaluate logs why."""
        for slots, cache_len in self.buckets:
            try:
                mem = self.bucket_memory(spec, (slots, cache_len))
            except Exception as e:  # noqa: BLE001 - advisory check only
                logging.warning("decode bucket %dx%d memory check failed: "
                                "%s", slots, cache_len, e)
                continue
            refuse_infeasible(
                f"decode bucket {slots}x{cache_len}", mem,
                "shrink AUTODIST_DECODE_SLOTS / AUTODIST_DECODE_CACHE_LEN "
                "or raise AUTODIST_HBM_GB")

    def cache_bytes(self, slots, cache_len):
        """Total KV-cache bytes of one (slots, cache_len) lane."""
        cache = self._init_cache(slots, cache_len, device="meta")
        return float(sum(t.numel() * t.element_size()
                         for t in leaves(cache)))

    # -- fleet build / scale -------------------------------------------------

    def _build_fleet(self, replicas):
        """``replicas`` one-device replicas, each the first device of its
        group of the spec's devices (``build_replica_programs(...,
        one_device=True)``). Every bucket's slots must divide the group's
        size, the data axis the JAX package shards them over, so a bucket
        list one package takes the other takes too. Checked before any
        placement."""
        programs = list(build_replica_programs(
            self.item, self.strategy, self._spec, replicas, one_device=True))
        n = len(local_devices(self._spec)) // replicas
        for slots, _ in self.buckets:
            if slots % n:
                raise ValueError(
                    f"decode bucket slots={slots} not divisible by this "
                    f"replica's data-axis size {n}; pick "
                    f"AUTODIST_DECODE_SLOTS as a multiple of the "
                    f"per-replica device count")
        self.replicas = []
        for i, program in enumerate(programs):
            rep = DecodeReplica(i, program, self._decode, obs=self._obs)
            for b in self.buckets:
                try:
                    rep.compile_decode(b, self._init_cache, self._decode)
                except Exception as e:  # noqa: BLE001 - forensics, re-raise
                    _oom_forensics(
                        e, f"decode aot-compile bucket {b} replica {i}")
                    raise
            self.replicas.append(rep)

    @property
    def max_cache_len(self):
        return max(b[1] for b in self.buckets)

    def start(self, on_complete):
        self._on_complete = on_complete
        self._start_threads()

    def _start_threads(self):
        self._pause = False
        self._threads = []
        for rep in self.replicas:
            t = threading.Thread(
                target=self._run_replica, args=(rep,), daemon=True,
                name=f"autodist-decode-replica-{rep.index}")
            self._threads.append(t)
            t.start()

    def _stop_threads(self):
        with self._cv:
            self._pause = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=60)
        self._threads = []

    def scale_to(self, replicas):
        """Re-carve the fleet to ``replicas`` with zero dropped requests:
        the step loops stop, every in-flight request is evicted (its
        host-side tokens intact), every lane's graph and cache is
        released, the devices re-carve, and the evicted requests rejoin at
        the FRONT of the queue in submission order. Returns the number
        re-dispatched."""
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if replicas == len(self.replicas):
            return 0
        t0 = time.perf_counter()
        old = len(self.replicas)
        self._stop_threads()
        inflight = []
        for rep in self.replicas:
            for lane in rep.lanes:
                inflight.extend(lane.evict_all())
        inflight.sort(key=lambda r: r.seq)
        for r in inflight:
            r.redispatches += 1
        with self._cv:
            self._queue.extendleft(reversed(inflight))
        for rep in self.replicas:
            rep.release()
        self._build_fleet(replicas)
        self._start_threads()
        self.scale_events += 1
        dt_ms = (time.perf_counter() - t0) * 1e3
        observability.record_event(
            "serve-scale", f"decode fleet {old} -> {replicas} replica(s): "
            f"{len(inflight)} in-flight re-dispatched, 0 dropped "
            f"({dt_ms:.0f}ms)")
        if self._obs is not None:
            reg = self._obs.registry()
            reg.gauge("decode.replicas").set(replicas)
            reg.counter("decode.scale_events").inc()
        logging.info("decode: scaled %d -> %d replicas (%d in-flight "
                     "re-dispatched, %.0fms)", old, replicas, len(inflight),
                     dt_ms)
        return len(inflight)

    # -- admission + step loop -----------------------------------------------

    def enqueue(self, req):
        with self._cv:
            self._queue.append(req)
            self._cv.notify_all()

    def queue_depth(self):
        return len(self._queue)

    @property
    def in_flight(self):
        return sum(rep.active for rep in self.replicas)

    def _admit_locked(self, rep):
        """Fill ``rep``'s free slots from the queue head, strictly FIFO:
        when the head request only fits a lane that is full (here or on
        another replica), nothing behind it jumps the line. Called with the
        condition lock held."""
        admitted = 0
        while self._queue:
            lane = rep.best_lane_for(self._queue[0])
            if lane is None:
                break
            lane.place(self._queue.popleft())
            admitted += 1
        return admitted

    def _run_replica(self, rep):
        while True:
            with self._cv:
                if self._pause:
                    break
                self._admit_locked(rep)
                if rep.active == 0:
                    self._cv.wait(timeout=0.02)
                    if self._pause:
                        break
                    self._admit_locked(rep)
                    if rep.active == 0:
                        continue
            for lane in rep.lanes:
                if lane.active == 0:
                    continue
                try:
                    completed, generated = lane.step()
                except Exception as e:  # noqa: BLE001 - fail lane occupants
                    logging.error("decode: step failed on replica %d: %s",
                                  rep.index, e)
                    _oom_forensics(e, f"decode step replica {rep.index}")
                    for req in lane.evict_all():
                        if not req.future.done():
                            req.future.set_exception(e)
                    continue
                if self._obs is not None:
                    reg = self._obs.registry()
                    reg.counter("decode.steps").inc()
                    if generated:
                        reg.counter("decode.tokens").inc(generated)
                    reg.gauge("decode.active_slots").set(self.in_flight)
                for req in completed:
                    if self._on_complete is not None:
                        self._on_complete(req)

    def close(self):
        self._stop_threads()
        self._closed = True
        # Fail whatever never ran: a deliberate close, not a drop.
        leftovers = list(self._queue)
        self._queue.clear()
        for rep in self.replicas:
            for lane in rep.lanes:
                leftovers.extend(lane.evict_all())
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("decode engine closed before completion"))


class DecodeServer:
    """Request front end over a :class:`DecodeEngine`:
    ``submit(prompt) -> Future`` resolving to the generated token ids, and
    the zero-drop ``scale_to``.

    Args:
        apply_fn: forward ``(params, batch) -> logits``, captured for the
            strategy machinery only.
        decode_fn: ``(params, cache, tokens, pos) -> (logits, cache)``
            single-token step (e.g. ``models.lm.make_decode_fn(cfg)``).
        init_cache_fn: ``(slots, cache_len, device=) -> cache`` (e.g.
            ``functools.partial(models.lm.init_decode_cache, cfg)``).
        params: parameter tree (placed per replica, never written).
        example_batch: forward example for capture (dim 0 = batch).
        buckets: (slots, cache_len) pairs, one lane each (default: one
            bucket from ``AUTODIST_DECODE_SLOTS`` x
            ``AUTODIST_DECODE_CACHE_LEN``).
        replicas / strategy_builder / resource_spec / device: as
            ``serve.Server``.
    """

    def __init__(self, apply_fn, decode_fn, init_cache_fn, params,
                 example_batch, buckets=None, replicas=1,
                 strategy_builder=None, resource_spec=None, device="cuda"):
        self._engine = DecodeEngine(
            apply_fn, decode_fn, init_cache_fn, params, example_batch,
            buckets=buckets, resource_spec=resource_spec,
            strategy_builder=strategy_builder, replicas=replicas,
            device=device)
        self._obs = observability if observability.enabled() else None
        self._seq = itertools.count()
        self._closed = False
        self._lock = threading.Lock()
        self._requests = 0
        self._completed = 0
        self._tokens = 0
        self._t0 = time.perf_counter()
        if self._obs is not None:
            self._obs.registry().gauge("decode.replicas").set(
                len(self._engine.replicas))
        self._engine.start(self._finished)
        logging.info(
            "decode: server up, %d replica(s), buckets %s",
            len(self._engine.replicas),
            ["x".join(map(str, b)) for b in self._engine.buckets])

    @property
    def engine(self):
        return self._engine

    def submit(self, prompt, max_new_tokens=16, eos=None):
        """Enqueue one generation; returns a Future resolving to the
        np.int32 array of generated token ids. A request that fits no lane
        (prompt + budget beyond every cache) fails here, at admission."""
        if self._closed:
            raise RuntimeError("serve.DecodeServer is closed")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        need = len(prompt) + int(max_new_tokens)
        if need > self._engine.max_cache_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) = {need} exceeds the largest decode "
                f"cache_len {self._engine.max_cache_len}; raise "
                f"AUTODIST_DECODE_CACHE_LEN or shorten the request")
        req = DecodeRequest(next(self._seq), prompt, max_new_tokens,
                            eos=eos)
        with self._lock:
            self._requests += 1
        self._engine.enqueue(req)
        if self._obs is not None:
            reg = self._obs.registry()
            reg.counter("decode.requests").inc()
            reg.gauge("decode.queue_depth").set(self._engine.queue_depth())
        return req.future

    def generate(self, prompt, max_new_tokens=16, eos=None, timeout=None):
        """Synchronous convenience wrapper."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos=eos).result(timeout=timeout)

    def scale_to(self, replicas):
        """Grow or shrink the replica fleet; no request is dropped."""
        return self._engine.scale_to(replicas)

    def stats(self):
        return {
            "requests": self._requests,
            "completed": self._completed,
            "tokens": self._tokens,
            "queue_depth": self._engine.queue_depth(),
            "in_flight": self._engine.in_flight,
            "replicas": len(self._engine.replicas),
            "scale_events": self._engine.scale_events,
            "buckets": [tuple(b) for b in self._engine.buckets],
        }

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._engine.close()
        observability.record_event(
            "serve-stop", f"decode: {self._completed}/{self._requests} "
            f"requests, {self._tokens} tokens")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _finished(self, req):
        """Completion, on a replica thread: counted once, then the future
        resolves (a drain race never resolves it twice)."""
        now = time.perf_counter()
        with self._lock:
            if req.future.done():
                return
            self._completed += 1
            self._tokens += len(req.generated)
            tokens = self._tokens
            req.future.set_result(np.asarray(req.generated, np.int32))
        if self._obs is not None:
            reg = self._obs.registry()
            hist = reg.histogram("decode.latency_ms")
            hist.observe((now - req.t_submit) * 1e3)
            reg.gauge("decode.tokens_per_sec").set(
                round(tokens / max(1e-9, now - self._t0), 2))
            reg.gauge("decode.queue_depth").set(self._engine.queue_depth())
            # The same pager gauge the one-shot server keeps.
            p99 = hist.summary().get("p99")
            if p99 is not None:
                slo = max(1, const.ENV.AUTODIST_SERVE_SLO_MS.val)
                reg.gauge("serve.slo_burn").set(round(p99 / slo, 4))
