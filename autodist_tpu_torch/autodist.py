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
(optax, which the JAX package takes, has no PyTorch twin). ``build`` starts
the ``torch.distributed`` world (``Cluster.start``: torchrun's environment,
else a one-rank world) on ``device`` (default ``"cuda"``, which raises
without CUDA). Every rank builds the same deterministic strategy locally;
shipping the chief's strategy to the workers is not ported yet, and neither
is the JAX package's default builder, ``PS()`` (ROADMAP.md).
"""
import contextlib

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.cluster import Cluster
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runner import Runner
from autodist_tpu_torch.strategy.base import StrategyCompiler
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device

_default_autodist = None


def _reset_default():
    """Clear the per-process singleton and destroy the process group its
    cluster started (test harness hook: one AutoDist after another)."""
    global _default_autodist
    if _default_autodist is not None:
        _default_autodist.cluster.terminate()
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
        self._runner = None
        self._fn_state = None

    @staticmethod
    def _resolve_builder(builder):
        """An explicit builder wins; else ``AUTODIST_STRATEGY=allreduce``.
        The JAX package's default (``PS()``), its other builder names and
        its tuner are not ported yet."""
        if builder is not None:
            return builder
        name = str(const.ENV.AUTODIST_STRATEGY.val).strip().lower()
        if name == "allreduce":
            from autodist_tpu_torch.strategy.all_reduce_strategy import \
                AllReduce
            logging.info("AUTODIST_STRATEGY=%s -> AllReduce", name)
            return AllReduce()
        if name:
            raise NotImplementedError(
                f"AUTODIST_STRATEGY={name!r}: autodist_tpu_torch builds "
                f"AllReduce only; the other builders and the tuner are not "
                f"ported yet (ROADMAP.md, Queue A)")
        raise NotImplementedError(
            "no strategy_builder: the JAX package's default, PS(), is not "
            "ported to autodist_tpu_torch yet (ROADMAP.md, Queue A); pass "
            "strategy_builder=AllReduce() or set AUTODIST_STRATEGY=allreduce")

    @property
    def resource_spec(self):
        return self._cluster.resource_spec

    @property
    def cluster(self):
        return self._cluster

    @contextlib.contextmanager
    def scope(self):
        """Capture scope: PyTorch programs need no capture hooks; the scope
        marks the region whose code must be identical on every rank."""
        yield self

    def capture(self, loss_fn, params, optimizer, example_batch=None,
                **kwargs):
        """Capture the single-device program into a GraphItem.
        ``optimizer``: trainable_tensors -> ``torch.optim.Optimizer``."""
        return GraphItem.capture(loss_fn, params, optimizer,
                                 example_batch=example_batch, **kwargs)

    def build(self, graph_item):
        """World -> strategy -> compile -> transform -> Runner."""
        device = self._cluster.start(resolve_device(self._device))
        strategy = self._strategy_builder.build(graph_item,
                                                self._cluster.resource_spec)
        logging.info("built strategy %s with %s on %s", strategy.id,
                     type(self._strategy_builder).__name__, device)
        mesh_axes = self._mesh_axes
        if mesh_axes is None and strategy.graph_config.mesh_axes:
            mesh_axes = dict(strategy.graph_config.mesh_axes)
        mesh = self._cluster.build_mesh(mesh_axes)
        compiled = StrategyCompiler(graph_item, mesh).compile(strategy)
        program = GraphTransformer(compiled, self._cluster,
                                   graph_item).transform()
        self._runner = Runner(program)
        return self._runner

    def create_distributed_session(self, graph_item):
        """Alias keeping the reference's entry-point name."""
        return self.build(graph_item)

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
