"""Bucket warm-up + per-replica inference runtimes.

Counterpart of ``autodist_tpu/serve/engine.py``. The serving engine reuses
the training stack's front half: capture (:meth:`GraphItem.capture` on the
forward-only ``apply_fn``), strategy (an explicit builder, else
:class:`AllReduce`), compile (:class:`StrategyCompiler`) and transform
(:class:`GraphTransformer` -> :class:`DistributedProgram`), then

* places the parameters ONCE per replica (``Remapper.place_params``) and
  never writes them: every dispatch reads the same tensors, so two
  identical requests get bitwise-identical answers;
* captures the forward at every padded batch *bucket*
  (``serve/buckets.py``) as one CUDA graph when the engine is built, the
  counterpart of the JAX package's AOT ``compile_bucket``
  (``utils/cuda_graph.py``: one eager warm-up forward, then the capture,
  over a static input buffer per bucket). A dispatch copies its placed
  batch into its bucket's buffer, replays the graph and fetches the static
  output into pinned host memory (``Remapper.fetch``): each answer is the
  caller's own, whatever later dispatches write. On the CPU the same
  static-buffer code calls the forward directly;
* feeds each replica's executor thread through the depth-N
  :class:`DevicePrefetcher` (lazy top-up), so the host->device copy of the
  next bucket overlaps the current forward.

Multi-replica: ``replicas=R`` carves the spec's devices into R contiguous
data-only groups, each with its own mesh, program and placed params. A
replica spans one device: the engine is one process, and the port places
one process on one device (training spans devices with one process per
device, ``cluster.py``).

Telemetry (``observability/``, off under ``AUTODIST_TELEMETRY=0``): the
``capture`` / ``strategy-build`` spans (``kind="serve"``), one
``serve-aot-compile`` span, ``serve.aot_compile.ms`` gauge and
``serve-compile`` event per bucket capture, and the ``serve-start``
event. Before any parameter placement or capture, every bucket's
predicted peak (``CostModel.strategy_memory(batch_rows=)``) is held to
the card's capacity x ``AUTODIST_MEM_HEADROOM``: a bucket that cannot fit
raises :class:`~autodist_tpu_torch.observability.memory.
InfeasibleMemoryError` naming it. The prediction traces the attention's
plain version, so it counts the (b, h, s, s) scores the flash kernel
never writes: it over-predicts a flash bucket (ROADMAP.md, Queue C). A
capture or dispatch that dies of memory writes the OOM forensics first.
The tuner and replica removal are not ported yet (ROADMAP.md).
"""
import queue
import threading
import time
import types

import numpy as np
import torch

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.cluster import Cluster, Mesh, local_devices
from autodist_tpu_torch.data.loader import DevicePrefetcher
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve.buckets import normalize_buckets
from autodist_tpu_torch.strategy.base import StrategyCompiler
from autodist_tpu_torch.utils import cuda_graph, logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import flatten
from autodist_tpu_torch.utils.tree import leaves as tree_leaves
from autodist_tpu_torch.utils.tree import tree_map, unflatten


def _oom_forensics(exc, context):
    """Serve-side OOM hook: when a bucket capture or a dispatch dies with
    a device allocation failure, write the forensics report
    (``logs/oom_report.json`` + the ``oom`` flight event) before the
    caller re-raises or fails the request futures. Fail-open, and no
    call at all with telemetry off."""
    if not observability.enabled():
        return
    try:
        from autodist_tpu_torch.observability import memory as memory_mod
        if memory_mod.is_oom(exc):
            memory_mod.oom_report(exc, context=context)
    except Exception as e:  # noqa: BLE001 - diagnostics only
        logging.debug("serve oom forensics failed: %s", e)


def bucket_memory_model(spec):
    """The cost model a serving engine prices its buckets with: the
    spec's devices, the card's capacity (``Topology.hbm_capacity_bytes``),
    and the default calibration file."""
    from autodist_tpu_torch.tuner.calibration import Calibration
    from autodist_tpu_torch.tuner.cost_model import CostModel, Topology
    cal = Calibration.load()
    return CostModel(Topology(max(1, len(local_devices(spec)))), cal)


def refuse_infeasible(label, mem, advice):
    """Raise the named refusal for one bucket when ``mem`` (a
    ``MemoryBreakdown``) does not fit; the ``oom`` flight event first."""
    from autodist_tpu_torch.observability import memory as memory_mod
    reason = memory_mod.check_feasible(mem)
    if not reason:
        return
    observability.record_event(
        "oom", f"{label} refused at engine build: {reason}")
    raise memory_mod.InfeasibleMemoryError(
        f"{label} refused: {reason}; dominant class "
        f"{mem.dominant_class()} — {advice}")


def build_replica_programs(item, strategy, spec, replicas, one_device=False):
    """One DistributedProgram per replica. R=1 uses the full mesh; R>1
    carves the spec's devices into R contiguous data-only groups, which is
    only legal when the strategy keeps params whole per device group. With
    ``one_device`` (decode) every replica, R=1 included, gets the first
    device of its group alone: one process drives one device, and a scale
    event may leave devices idle."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")

    def transform(mesh):
        compiled = StrategyCompiler(item, mesh).compile(strategy)
        holder = types.SimpleNamespace(mesh=mesh, resource_spec=spec)
        return GraphTransformer(compiled, holder, item).transform()

    axes = dict(strategy.graph_config.mesh_axes)
    if replicas == 1 and not one_device:
        yield transform(Cluster(spec).build_mesh(axes or None))
        return
    nondata = {a: k for a, k in axes.items()
               if a != const.MESH_AXIS_DATA and k > 1}
    if nondata:
        raise ValueError(
            f"multi-replica dispatch needs a data-only strategy "
            f"(params whole per replica); this one carves mesh axes "
            f"{nondata} — serve it with replicas=1")
    devices = local_devices(spec)
    if len(devices) % replicas:
        raise ValueError(
            f"{len(devices)} devices do not split into {replicas} "
            f"equal replicas")
    per = len(devices) // replicas
    for i in range(replicas):
        group = np.empty(1 if one_device else per, dtype=object)
        group[:] = devices[i * per:i * per + len(group)]
        yield transform(Mesh(group, (const.MESH_AXIS_DATA,)))


def _resolve_serve_builder(builder):
    """Serving strategy policy: an explicit builder wins; else the builder
    ``AUTODIST_STRATEGY`` names (the names ``AutoDist`` takes; ``auto``,
    the tuner, is not ported); else AllReduce (fully replicated params,
    the canonical serving layout). A replica spans one device, so every
    builder's parameters are whole there."""
    if builder is not None:
        return builder
    name = const.ENV.AUTODIST_STRATEGY.val
    if name:
        from autodist_tpu_torch.strategy.registry import builder_from_name
        return builder_from_name(name)
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    return AllReduce()


def serve_spec(resource_spec, device):
    """The ResourceSpec a serving engine carves: the one given (an object
    or its YAML), else every local CUDA device for a bare ``"cuda"``, else
    ``device`` alone."""
    if isinstance(resource_spec, ResourceSpec):
        return resource_spec
    if resource_spec is not None:
        return ResourceSpec(resource_spec)
    if device.type == "cuda" and device.index is None:
        return ResourceSpec()
    return ResourceSpec.local(device)


def _check_bucket_rows(bucket, program):
    n = program.data_axis_size
    if bucket[0] % n:
        raise ValueError(
            f"serve bucket {bucket[0]} not divisible by this replica's "
            f"data-axis size {n}; pick bucket sizes that are "
            f"multiples of the per-replica device count")


class _WorkQueue:
    """Replica work source: a queue that speaks both the blocking
    iterator protocol (the DevicePrefetcher's pop) and ``next_nowait``
    (its lazy top-up)."""

    _STOP = object()

    def __init__(self):
        self._q = queue.Queue()

    def put(self, item):
        self._q.put(item)

    def close(self):
        self._q.put(self._STOP)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._STOP:
            raise StopIteration
        return item

    def next_nowait(self):
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            return None
        if item is self._STOP:
            raise StopIteration
        return item


class ReplicaRuntime:
    """One model replica: a mesh slice, resident (never-written) params,
    and the buckets it has warmed up (one captured forward each)."""

    def __init__(self, index, program, apply_fn, obs=None):
        if program.paddings():
            raise NotImplementedError(
                "uneven parameter shards (padded storage) are not ported "
                "to autodist_tpu_torch yet (ROADMAP.md)")
        self.index = index
        self.program = program
        self.remapper = Remapper(program)
        self._apply = apply_fn
        self._obs = obs
        self._graphs = {}   # bucket -> (static input leaves, Graph)
        self._bucket_rank = None
        self._source = None
        self._prefetch = None
        self._thread = None
        self._on_complete = None
        self._lock = threading.Lock()
        self.outstanding = 0       # dispatched, not yet completed
        self.dispatches = 0
        self._busy_s = 0.0
        self._started_at = time.perf_counter()
        self.params = self.remapper.place_params(program.graph_item.params)

    def _forward(self, batch):
        with torch.inference_mode():
            return self._apply(self.params, batch)

    def compile_bucket(self, bucket, batch_struct):
        """Capture the forward at one padded bucket and return its
        :class:`~autodist_tpu_torch.utils.cuda_graph.Graph` (the JAX
        package's AOT ``compile_bucket`` returns its executable): a static
        input buffer of the bucket's shape (zeros) on the replica's device,
        and the forward over it as a CUDA graph, after one eager warm-up
        forward (on the CPU: the forward, called per dispatch). ``bucket``
        is an int (batch rows) or a tuple of leading dims — ``(rows, seq)``
        buckets pad both the batch and the sequence dimension of every
        leaf. A bucket already compiled returns its graph."""
        bucket = (int(bucket),) if not isinstance(bucket, (tuple, list)) \
            else tuple(int(x) for x in bucket)
        if bucket in self._graphs:
            return self._graphs[bucket][1]
        _check_bucket_rows(bucket, self.program)
        rank = len(bucket)
        for s in tree_leaves(batch_struct):
            if len(s.shape) < rank:
                raise ValueError(
                    f"bucket {bucket} pads {rank} leading dims but a "
                    f"batch leaf has shape {tuple(s.shape)} (rank "
                    f"{len(s.shape)}); use batch-only buckets for this "
                    f"model")
        zeros = tree_map(lambda s: np.zeros(bucket + tuple(s.shape)[rank:],
                                            s.dtype), batch_struct)
        static, treedef = flatten(self.remapper.shard_batch(zeros))
        graph = cuda_graph.Graph(cuda_graph.weak_call(
            self, lambda r: r._forward(unflatten(treedef, static))),
            self.remapper.device)
        obs = self._obs
        t0 = time.perf_counter()
        with (obs.span("serve-aot-compile", bucket=str(bucket),
                       replica=self.index) if obs is not None
              else observability.tracing.NULL_SPAN):
            self.remapper.fetch(graph())
        dt_ms = (time.perf_counter() - t0) * 1e3
        logging.info("serve: replica %d warmed bucket %s (%s, %.0fms)",
                     self.index, bucket,
                     "CUDA graph" if graph.captured else "eager", dt_ms)
        if obs is not None:
            obs.registry().gauge("serve.aot_compile.ms").set(round(dt_ms, 3))
            obs.record_event("serve-compile",
                             f"replica {self.index} bucket {bucket} "
                             f"({dt_ms:.0f}ms)")
        self._bucket_rank = rank
        self._graphs[bucket] = (static, graph)
        return graph

    @property
    def buckets_compiled(self):
        """Compiled buckets, sorted: ints for batch-only buckets, tuples
        for ``(rows, seq)`` ones (:meth:`compile_bucket` returns each
        one's graph)."""
        return sorted(b[0] if len(b) == 1 else b for b in self._graphs)

    def run_bucket(self, batch):
        """One dispatch of a placed, bucket-shaped batch: copied into its
        bucket's static input, the bucket's graph replayed (or, on the CPU,
        the forward called), and the output fetched to pinned host
        memory."""
        flat, _ = flatten(batch)
        bucket = tuple(flat[0].shape[:self._bucket_rank])
        if bucket not in self._graphs:
            raise ValueError(f"batch of leading dims {bucket} matches no "
                             f"warmed bucket {sorted(self._graphs)}")
        static, graph = self._graphs[bucket]
        for buf, leaf in zip(static, flat):
            buf.copy_(leaf, non_blocking=True)
        return self.remapper.fetch(graph())

    # -- dispatch loop -------------------------------------------------------

    def _shard_item(self, item, non_blocking=False):
        batch, group, rows = item
        try:
            db = self.remapper.shard_batch(batch, non_blocking=non_blocking)
        except Exception as e:
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
            with self._lock:
                self.outstanding -= 1
            raise
        return db, group, rows

    def start(self, on_complete, depth=None):
        """Spin up the executor thread behind a depth-N prefetch window."""
        self._on_complete = on_complete
        self._source = _WorkQueue()
        self._prefetch = DevicePrefetcher(
            self._source, self.remapper, depth=depth,
            shard_fn=self._shard_item, pull_in_background=False)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"autodist-serve-replica-{self.index}")
        self._thread.start()

    def enqueue(self, batch, group, rows):
        with self._lock:
            self.outstanding += 1
        self._source.put((batch, group, rows))

    def _loop(self):
        while True:
            try:
                db, group, rows = next(self._prefetch)
            except StopIteration:
                break
            except Exception as e:  # noqa: BLE001 - surface on the futures
                self._fail_all(e)
                continue
            t0 = time.perf_counter()
            try:
                host = self.run_bucket(db)
            except Exception as e:  # noqa: BLE001 - per-batch failure
                _oom_forensics(e, f"serve dispatch replica {self.index}")
                for r in group:
                    if not r.future.done():
                        r.future.set_exception(e)
                with self._lock:
                    self.outstanding -= 1
                continue
            self._busy_s += time.perf_counter() - t0
            with self._lock:
                self.outstanding -= 1
                self.dispatches += 1
            self._on_complete(self, group, host, rows)

    def _fail_all(self, exc):
        """A placement fault poisons whatever is queued; drain it."""
        while True:
            item = self._source.next_nowait()
            if item is None:
                break
            for r in item[1]:
                if not r.future.done():
                    r.future.set_exception(exc)
            with self._lock:
                self.outstanding -= 1

    @property
    def utilization(self):
        """Fraction of wall time this replica spent executing."""
        dt = time.perf_counter() - self._started_at
        return self._busy_s / dt if dt > 0 else 0.0

    def close(self):
        """Stop the replica's thread and release its bucket graphs (their
        memory pools go back at once, whoever still holds the replica)."""
        if self._source is not None:
            self._source.close()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        for _, graph in self._graphs.values():
            graph.release()
        self._graphs = {}


class ServeEngine:
    """capture -> strategy -> per-replica (mesh, program, params, warmed
    buckets). The :class:`~autodist_tpu_torch.serve.server.Server` owns
    the request queue in front of this.

    ``device`` picks the replicas' devices when no ``resource_spec`` is
    given: ``"cuda"`` (the default) every local CUDA device, ``"cuda:i"``
    that one, ``"cpu"`` the host. With no CUDA device present a CUDA
    request raises ``RuntimeError``.
    """

    def __init__(self, apply_fn, params, example_batch, buckets,
                 resource_spec=None, strategy_builder=None, replicas=1,
                 device="cuda"):
        if example_batch is None:
            raise ValueError("serve needs an example_batch: bucket "
                             "warm-up specializes on its structure "
                             "(trailing dims + dtypes)")
        device = resolve_device(device)
        self.buckets = normalize_buckets(buckets)
        self.bucket_rank = len(self.buckets[0])
        if self.bucket_rank > 2:
            raise ValueError(
                f"serve buckets pad at most (rows, seq); got rank-"
                f"{self.bucket_rank} buckets {self.buckets}")
        self._apply = apply_fn
        with observability.span("capture", kind="serve"):
            self.item = GraphItem.capture(apply_fn, params, None,
                                          example_batch=example_batch)
        spec = serve_spec(resource_spec, device)
        builder = _resolve_serve_builder(strategy_builder)
        with observability.span("strategy-build", kind="serve"):
            self.strategy = builder.build(self.item, spec)
        logging.info("serve: strategy %s via %s", self.strategy.id,
                     type(builder).__name__)
        programs = list(build_replica_programs(
            self.item, self.strategy, spec, int(replicas)))
        for program in programs:  # before any placement
            for b in self.buckets:
                _check_bucket_rows(b, program)
        self._validate_bucket_memory(spec)
        self._obs = observability if observability.enabled() else None
        self.replicas = [ReplicaRuntime(i, program, apply_fn, obs=self._obs)
                         for i, program in enumerate(programs)]
        for rep in self.replicas:
            for b in self.buckets:
                try:
                    rep.compile_bucket(b, self.item.batch_struct)
                except Exception as e:  # noqa: BLE001 - forensics, re-raise
                    _oom_forensics(e, f"serve aot-compile bucket {b} "
                                      f"replica {rep.index}")
                    raise
        observability.record_event(
            "serve-start", f"{len(self.replicas)} replica(s), buckets "
            f"{[(b[0] if len(b) == 1 else b) for b in self.buckets]}, "
            f"strategy {self.strategy.id}")

    def bucket_memory(self, spec, bucket):
        """The predicted ``MemoryBreakdown`` of one bucket: the captured
        forward's footprint at ``batch_rows=bucket[0]``."""
        return bucket_memory_model(spec).strategy_memory(
            self.strategy, self.item, batch_rows=bucket[0])

    def _validate_bucket_memory(self, spec):
        """Refuse over-capacity buckets at engine build, BEFORE any
        parameter placement or capture: a bucket whose predicted peak
        exceeds capacity x ``AUTODIST_MEM_HEADROOM`` raises
        :class:`~autodist_tpu_torch.observability.memory.
        InfeasibleMemoryError` naming it, instead of dying of memory
        inside its CUDA graph capture. The check itself is fail-open:
        only a positive refusal propagates, and a check that cannot
        evaluate logs why."""
        for b in self.buckets:
            label = b[0] if len(b) == 1 else b
            try:
                mem = self.bucket_memory(spec, b)
            except Exception as e:  # noqa: BLE001 - advisory check only
                logging.warning("serve bucket %s memory check failed: %s",
                                label, e)
                continue
            refuse_infeasible(
                f"serve bucket {label}", mem,
                "drop the bucket from AUTODIST_SERVE_BUCKETS or raise "
                "AUTODIST_HBM_GB if this card really has more memory")

    @property
    def program(self):
        """Replica 0's DistributedProgram."""
        return self.replicas[0].program

    @property
    def max_rows(self):
        return max(b[0] for b in self.buckets)

    def least_loaded(self):
        """The replica with the fewest outstanding dispatches (ties go to
        the lowest index — deterministic)."""
        return min(self.replicas, key=lambda r: (r.outstanding, r.index))

    def start(self, on_complete, depth=None):
        for rep in self.replicas:
            rep.start(on_complete, depth=depth)

    def close(self):
        for rep in self.replicas:
            rep.close()
