"""Bucket warm-up + per-replica inference runtimes.

Counterpart of ``autodist_tpu/serve/engine.py``. The serving engine reuses
the training stack's front half: capture (:meth:`GraphItem.capture` on the
forward-only ``apply_fn``), strategy (an explicit builder, else
:class:`AllReduce`), compile (:class:`StrategyCompiler`) and transform
(:class:`GraphTransformer` -> :class:`DistributedProgram`), then

* places the parameters ONCE per replica (``Remapper.place_params``) and
  never writes them: every dispatch reads the same tensors, so two
  identical requests get bitwise-identical answers;
* runs one warm-up forward at every padded batch *bucket*
  (``serve/buckets.py``) when the engine is built, in place of the JAX
  package's AOT ``compile_bucket``: the CUDA kernels are built and loaded,
  and PyTorch's allocator has seen every bucket's shapes, before the first
  request;
* feeds each replica's executor thread through the depth-N
  :class:`DevicePrefetcher` (lazy top-up), so the host->device copy of the
  next bucket overlaps the current forward.

Multi-replica: ``replicas=R`` carves the spec's devices into R contiguous
data-only groups, each with its own mesh, program and placed params. A
replica spans one device: the engine is one process, and the port places
one process on one device (training spans devices with one process per
device, ``cluster.py``). Observability spans and
gauges, the bucket memory pre-check, OOM forensics, the tuner and
replica removal are not ported yet (ROADMAP.md).
"""
import queue
import threading
import time
import types

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.cluster import Cluster, Mesh, local_devices
from autodist_tpu_torch.data.loader import DevicePrefetcher
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.serve.buckets import normalize_buckets
from autodist_tpu_torch.strategy.base import StrategyCompiler
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import leaves as tree_leaves
from autodist_tpu_torch.utils.tree import tree_map


def build_replica_programs(item, strategy, spec, replicas):
    """One DistributedProgram per replica. R=1 uses the full mesh; R>1
    carves the spec's devices into R contiguous data-only groups, which is
    only legal when the strategy keeps params whole per device group."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")

    def transform(mesh):
        compiled = StrategyCompiler(item, mesh).compile(strategy)
        holder = types.SimpleNamespace(mesh=mesh, resource_spec=spec)
        return GraphTransformer(compiled, holder, item).transform()

    axes = dict(strategy.graph_config.mesh_axes)
    if replicas == 1:
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
        group = np.empty(per, dtype=object)
        group[:] = devices[i * per:(i + 1) * per]
        yield transform(Mesh(group, (const.MESH_AXIS_DATA,)))


def _resolve_serve_builder(builder):
    """Serving strategy policy: an explicit builder wins; else AllReduce
    (fully replicated params, the canonical serving layout), which is also
    what ``AUTODIST_STRATEGY=allreduce`` names. The tuner and the other
    builders are not ported yet."""
    if builder is not None:
        return builder
    name = str(const.ENV.AUTODIST_STRATEGY.val).strip().lower()
    if name and name != "allreduce":
        raise NotImplementedError(
            f"AUTODIST_STRATEGY={name!r}: the port serves with AllReduce "
            f"only; the other builders and the tuner are ported after "
            f"slice 2, data-parallel training (ROADMAP.md, Queue A)")
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    return AllReduce()


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
    and the buckets it has warmed up."""

    def __init__(self, index, program, apply_fn):
        if program.paddings():
            raise NotImplementedError(
                "uneven parameter shards (padded storage) are not ported "
                "to autodist_tpu_torch yet (ROADMAP.md)")
        self.index = index
        self.program = program
        self.remapper = Remapper(program)
        self._apply = apply_fn
        self._buckets = set()
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

    def warm_bucket(self, bucket, batch_struct):
        """One forward at a padded bucket on zeros, synchronised: the
        counterpart of the JAX package's AOT ``compile_bucket``. ``bucket``
        is an int (batch rows) or a tuple of leading dims — ``(rows, seq)``
        buckets pad both the batch and the sequence dimension of every
        leaf."""
        bucket = (int(bucket),) if not isinstance(bucket, (tuple, list)) \
            else tuple(int(x) for x in bucket)
        if bucket in self._buckets:
            return
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
        t0 = time.perf_counter()
        self.remapper.fetch(self._forward(self.remapper.shard_batch(zeros)))
        logging.info("serve: replica %d warmed bucket %s (%.0fms)",
                     self.index, bucket, (time.perf_counter() - t0) * 1e3)
        self._buckets.add(bucket)

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
                host = self.remapper.fetch(self._forward(db))
            except Exception as e:  # noqa: BLE001 - per-batch failure
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
        if self._source is not None:
            self._source.close()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None


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
        self.item = GraphItem.capture(apply_fn, params, None,
                                      example_batch=example_batch)
        if isinstance(resource_spec, ResourceSpec):
            spec = resource_spec
        elif resource_spec is not None:
            spec = ResourceSpec(resource_spec)
        elif device.type == "cuda" and device.index is None:
            spec = ResourceSpec()
        else:
            spec = ResourceSpec.local(device)
        builder = _resolve_serve_builder(strategy_builder)
        self.strategy = builder.build(self.item, spec)
        logging.info("serve: strategy %s via %s", self.strategy.id,
                     type(builder).__name__)
        programs = list(build_replica_programs(
            self.item, self.strategy, spec, int(replicas)))
        for program in programs:  # before any placement
            for b in self.buckets:
                _check_bucket_rows(b, program)
        self.replicas = [ReplicaRuntime(i, program, apply_fn)
                         for i, program in enumerate(programs)]
        for rep in self.replicas:
            for b in self.buckets:
                rep.warm_bucket(b, self.item.batch_struct)

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
