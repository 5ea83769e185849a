"""User-facing API: the ``AutoDist`` facade.

Counterpart of ``autodist_tpu/autodist.py``: capture the user's
single-device program, build the strategy, compile it against the mesh,
transform, and hand back a Runner::

    ad = AutoDist(strategy_builder=AllReduce(chunk_size=128))
    with ad.scope():
        params = init_params(...)                  # plain single-device code
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch)
    runner = ad.create_distributed_session(item)   # world -> strategy -> program
    state = runner.create_state()
    state, metrics = runner.step(state, batch)     # batch: this rank's rows

or the one-liner::

    @ad.function(optimizer=functools.partial(torch.optim.SGD, lr=0.1))
    def train_step(params, batch): ...
    metrics = train_step(params, batch)   # first call builds; state kept inside

The optimizer is a factory ``trainable_tensors -> torch.optim.Optimizer``
(optax, which the JAX package takes, has no PyTorch twin). The builder is
the one given, else the one ``AUTODIST_STRATEGY`` names, else ``PS()``, as
in the JAX package. ``build`` starts the ``torch.distributed`` world
(``Cluster.start``: torchrun's environment, the AutoDist launch contract,
else a one-rank world) on ``device`` (default ``"cuda"``, which raises
without CUDA). A ``launch: local|ssh`` spec of several processes starts it
at construction instead: the chief first launches the workers
(``Coordinator.launch_clients``), which re-run the same script. On a world of
several ranks the chief (rank 0) builds the strategy once and ships it to
the workers through the process group's c10d store
(:meth:`AutoDist._ship_or_fetch_strategy`), so every rank runs the chief's
program even when the builder is not deterministic.
"""
import contextlib
import datetime
import hashlib
import itertools

import torch
import torch.distributed as dist

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.cluster import Cluster
from autodist_tpu_torch.coordinator import Coordinator
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import Runner
from autodist_tpu_torch.proto import strategy_pb2
from autodist_tpu_torch.strategy.base import Strategy, StrategyCompiler
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device

_default_autodist = None
# Ship keys are numbered per process: the store outlives AutoDist instances
# (a world the caller started), and every rank runs the same sequence of
# builds.
_ship_counter = itertools.count()


def get_default_autodist():
    """This process's :class:`AutoDist`, or None before one is made."""
    return _default_autodist


def _store_flake(exc):
    """A store fault worth retrying: transient (``resilience.retry``), and
    not a wait that ran out its own timeout (``DistStoreError``)."""
    from autodist_tpu_torch.resilience import retry
    return retry.transient_runtime_error(exc) and not isinstance(
        exc, getattr(dist, "DistStoreError", ()))


def _reset_default(keep_world=False):
    """Clear the per-process singleton and destroy the process group its
    cluster started (test harness hook: one AutoDist after another). With
    ``keep_world`` the world stays for the next AutoDist to join (one
    world for many sessions: its communicators are made once)."""
    global _default_autodist
    if _default_autodist is not None:
        _default_autodist.cluster.terminate(keep_world=keep_world)
    _default_autodist = None


class AutoDist:
    """One instance per process."""

    def __init__(self, resource_spec_file=None, strategy_builder=None,
                 mesh_axes=None, device="cuda"):
        global _default_autodist
        if _default_autodist is not None:
            raise NotImplementedError(
                "Only one AutoDist instance per process is supported; call "
                "autodist_tpu_torch.autodist._reset_default() in tests")
        builder = self._resolve_builder(strategy_builder)
        _default_autodist = self
        self._resource_spec = ResourceSpec(resource_spec_file)
        self._strategy_builder = builder
        self._mesh_axes = mesh_axes
        self._device = device
        self._cluster = Cluster(self._resource_spec)
        self._coordinator = None
        self._runner = None
        self._fn_state = None
        # Multi-process launch (a "launch: local|ssh" spec): the chief
        # spawns the workers, which re-run this script, and every process
        # joins the world now (the JAX package joins before any user code
        # touches JAX). The strategy does not exist yet; once built, the
        # chief ships it over the world's store.
        spec = self._resource_spec
        if (spec.local_launch or spec.remote_launch) and \
                spec.num_processes > 1:
            if self.is_chief:
                self._coordinator = Coordinator(None, self._cluster)
                self._coordinator.launch_clients()
            self._cluster.start(resolve_device(device))

    @staticmethod
    def _resolve_builder(builder):
        """An explicit builder wins; else the ``AUTODIST_STRATEGY`` env knob
        names a ported builder (its default configuration); else ``PS()``,
        the JAX package's default. ``auto`` (the tuner) is not ported."""
        if builder is not None:
            return builder
        name = const.ENV.AUTODIST_STRATEGY.val
        if name:
            from autodist_tpu_torch.strategy.registry import \
                builder_from_name
            resolved = builder_from_name(name)
            logging.info("AUTODIST_STRATEGY=%s -> %s", name,
                         type(resolved).__name__)
            return resolved
        from autodist_tpu_torch.strategy.ps_strategy import PS
        return PS()

    @property
    def resource_spec(self):
        return self._cluster.resource_spec

    @property
    def cluster(self):
        return self._cluster

    @property
    def coordinator(self):
        """The chief's Coordinator (None on workers / before setup). Pass
        it to ``CheckpointManager.run(..., coordinator=...)`` so the step
        loop observes worker deaths (checkpoint-and-exit) and elastic
        re-form requests."""
        return self._coordinator

    @property
    def is_chief(self):
        return not const.ENV.AUTODIST_WORKER.val

    @contextlib.contextmanager
    def scope(self):
        """Capture scope: PyTorch programs need no capture hooks; the scope
        marks the region whose code must be identical on every rank."""
        yield self

    def capture(self, loss_fn, params, optimizer, example_batch=None,
                **kwargs):
        """Capture the single-device program into a GraphItem.
        ``optimizer``: trainable_tensors -> ``torch.optim.Optimizer``."""
        with observability.span("capture"):
            return GraphItem.capture(loss_fn, params, optimizer,
                                     example_batch=example_batch, **kwargs)

    # -- the strategy: built, loaded or shipped ------------------------------

    def _build_or_load_strategy(self, graph_item):
        """``AUTODIST_STRATEGY_ID`` loads a serialized artifact; on a world
        of several ranks the chief builds and ships; else build here."""
        sid = const.ENV.AUTODIST_STRATEGY_ID.val
        if sid:
            strategy = Strategy.deserialize(sid)
            logging.info("loaded strategy %s", sid)
            return strategy
        if dist.is_initialized() and dist.get_world_size() > 1:
            return self._ship_or_fetch_strategy(graph_item)
        return self._build_local(graph_item)

    def _build_local(self, graph_item):
        """Build with this process's builder and serialize the artifact (an
        inspection aid: a read-only working directory is tolerated)."""
        strategy = self._strategy_builder.build(graph_item,
                                                self._cluster.resource_spec)
        try:
            strategy.serialize()
        except OSError as e:
            logging.warning("could not serialize strategy %s: %s",
                            strategy.id, e)
        logging.info("built strategy %s with %s", strategy.id,
                     type(self._strategy_builder).__name__)
        return strategy

    def _ship_fingerprint(self, graph_item):
        """Fingerprint of (graph item, resource spec): what the shipped
        strategy was built for. Ranks whose build sequences diverged wait
        under different keys, which turns a silent divergence of the SPMD
        programs into a timeout."""
        h = hashlib.sha256()
        for v in graph_item.variables:
            h.update(f"{v.name}|{tuple(v.shape)}|{v.dtype}|"
                     f"{v.trainable}\n".encode())
        spec = self._cluster.resource_spec
        h.update(f"np={spec.num_processes}|"
                 f"mesh={sorted(spec.mesh_hints.items())}|"
                 f"builder={type(self._strategy_builder).__name__}\n"
                 .encode())
        return h.hexdigest()[:16]

    def _ship_or_fetch_strategy(self, graph_item):
        """The chief (rank 0) builds once and sets the serialized proto
        under ``autodist/strategy/<seq>/<fingerprint>`` in the c10d store of
        the world ``Cluster.start`` joined, and its id under ``.../id``;
        every worker waits for both (``AUTODIST_STRATEGY_SHIP_TIMEOUT_MS``),
        parses the proto and checks the id echo. The counterpart of the
        JAX package's coordination-service shipping
        (``autodist_tpu/autodist.py:198-297``): transient store faults
        retry with backoff (``resilience.retry``), and ``AUTODIST_CHAOS``'s
        ``kv_delay_ms`` delays the fetch. A wait that runs out its timeout
        is the answer, not a flake, and is not retried: the timeout bounds
        the whole wait."""
        from autodist_tpu_torch.resilience import chaos, retry
        try:
            store = dist.distributed_c10d._get_default_store()
        except (AttributeError, RuntimeError, ValueError) as e:
            logging.warning("no c10d store to ship the strategy through "
                            "(%s); every rank builds it (determinism "
                            "required)", e)
            return self._build_local(graph_item)
        key = (f"autodist/strategy/{next(_ship_counter)}/"
               f"{self._ship_fingerprint(graph_item)}")
        if dist.get_rank() == 0:
            strategy = self._build_local(graph_item)
            blob = strategy.proto.SerializeToString()
            with observability.span("strategy-ship", bytes=len(blob)):
                retry.retry_call(store.set, key, blob,
                                 describe="strategy KV publish")
                retry.retry_call(store.set, key + "/id", strategy.id,
                                 describe="strategy id publish")
            if observability.enabled():
                observability.registry().gauge(
                    "strategy.ship_bytes").set(len(blob))
                observability.record_event(
                    "strategy-ship", f"published {strategy.id} "
                    f"({len(blob)} bytes)")
            logging.info("shipped strategy %s (%d bytes) as %s",
                         strategy.id, len(blob), key)
            return strategy
        chaos.maybe_delay_kv_fetch()
        timeout_ms = const.strategy_ship_timeout_ms()
        try:
            with observability.span("strategy-ship", side="fetch"):
                retry.retry_call(store.wait, [key, key + "/id"],
                                 datetime.timedelta(milliseconds=timeout_ms),
                                 is_retryable=_store_flake,
                                 describe="strategy KV fetch")
        except RuntimeError as e:
            raise RuntimeError(
                f"autodist_tpu_torch: no strategy was shipped under {key} "
                f"within {timeout_ms} ms (AUTODIST_STRATEGY_SHIP_TIMEOUT_MS)"
                f": the chief built none for this rank's program (another "
                f"capture or build sequence: the fingerprint differs), or "
                f"it is slower than the timeout") from e
        proto = strategy_pb2.Strategy()
        blob = retry.retry_call(store.get, key, describe="strategy KV fetch")
        proto.ParseFromString(blob)
        strategy = Strategy(proto)
        want_id = retry.retry_call(
            store.get, key + "/id", describe="strategy id fetch").decode(
                "utf-8", "replace")
        if strategy.id != want_id:
            raise RuntimeError(
                f"autodist_tpu_torch: strategy ship mismatch under {key}: "
                f"fetched proto id {strategy.id!r} != published id "
                f"{want_id!r}")
        unknown = ({n.var_name for n in strategy.node_config} -
                   {v.name for v in graph_item.trainable_variables})
        if unknown:
            raise RuntimeError(
                f"autodist_tpu_torch: shipped strategy {strategy.id} "
                f"configures variables this rank never captured "
                f"({sorted(unknown)[:5]})")
        observability.record_event(
            "strategy-ship", f"fetched {strategy.id} ({len(blob)} bytes)")
        logging.info("fetched strategy %s (%s)", strategy.id, key)
        return strategy

    def _setup(self, strategy):
        """Create the chief's coordinator (one launched at construction
        stays)."""
        if self.is_chief and self._coordinator is None:
            self._coordinator = Coordinator(strategy, self._cluster)

    def build(self, graph_item):
        """World -> strategy -> compile -> transform -> Runner."""
        device = self._cluster.start(resolve_device(self._device))
        with observability.span("strategy-build"):
            strategy = self._build_or_load_strategy(graph_item)
        self._setup(strategy)
        logging.info("strategy %s on %s", strategy.id, device)
        mesh_axes = self._mesh_axes
        if mesh_axes is None and strategy.graph_config.mesh_axes:
            mesh_axes = dict(strategy.graph_config.mesh_axes)
        mesh = self._cluster.build_mesh(mesh_axes)
        with observability.span("transform"):
            compiled = StrategyCompiler(graph_item, mesh).compile(strategy)
            program = GraphTransformer(compiled, self._cluster,
                                       graph_item).transform()
        self._runner = Runner(program)
        return self._runner

    def create_distributed_session(self, graph_item):
        """Alias keeping the reference's entry-point name."""
        return self.build(graph_item)

    def build_strategy(self, graph_item):
        """The strategy this process's builder makes for ``graph_item`` on
        the resource spec, alone: no world, mesh or runner, nothing
        serialized or shipped."""
        return self._strategy_builder.build(graph_item,
                                            self._cluster.resource_spec)

    def function(self, optimizer, aux_output=False, **capture_kwargs):
        """Decorator turning a single-device loss fn into a distributed step.

        The first call captures, builds and creates the state from the
        params passed; later calls ignore the params argument and step the
        internal state (session semantics). Returns the step's metrics.
        """
        if not callable(optimizer) or \
                isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(
                "ad.function requires an optimizer factory: "
                "@ad.function(optimizer=functools.partial(torch.optim.SGD, "
                "lr=0.1))")

        def decorator(loss_fn):
            def run_fn(params, batch):
                if self._fn_state is None:
                    item = self.capture(loss_fn, params, optimizer,
                                        example_batch=batch,
                                        aux_output=aux_output,
                                        **capture_kwargs)
                    runner = self.build(item)
                    self._fn_state = (runner, runner.create_state())
                runner, state = self._fn_state
                state, metrics = runner.step(state, batch)
                self._fn_state = (runner, state)
                return metrics
            run_fn.autodist = self
            return run_fn
        return decorator
