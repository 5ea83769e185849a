"""Runner: the distributed train step and the step loop.

Counterpart of ``autodist_tpu/runner.py``: ``TrainState``, ``create_state``,
``step``, ``make_callable`` and a plain ``run`` loop. One step, on every
rank:

1. the loss on this rank's local batch (PyTorch runs eagerly: nothing to
   compile);
2. gradients by ``torch.autograd.grad`` over the trainable leaves;
3. the reduction each variable's synchronizer prescribes over the data
   axis's process group: same-group fusable gradients as one flat bucket
   per (group, dtype) through ``torch.distributed.all_reduce``, then divided
   by the group's size (the strategy's groups decide the buckets, not
   ``DistributedDataParallel``);
4. the optimizer step;
5. the loss's mean over the data group.

Metrics are 0-dim tensors on the device (``loss``, ``notfinite``, and
``aux`` with ``aux_output``), read without a host sync per step.

Updates are in place: ``step`` writes the new parameters and optimizer
state into the tensors of the state it was given (the counterpart of the
JAX package's buffer donation), so each step makes that ``TrainState``
stale. Stepping a stale state raises ``RuntimeError``: its tensors already
hold the newer values.

The host-side fast paths replay CUDA graphs (``utils/cuda_graph.py``), the
counterpart of the JAX package's ahead-of-time executables:
``make_callable(batch, aot=True)`` replays one step, :meth:`megastep` K
steps over a K-stacked block (``lax.scan`` in one dispatch there), and
``run(unroll=K)`` dispatches megasteps. A graph is captured over static
batch buffers and the state's own tensors: each call copies its batch in
and replays; the step counter and the stale marking stay on the host. The
first call runs the real step (or K steps) eagerly on a side stream, as
the capture's warm-up, then captures: after N calls the state has taken
N steps. The optimizer must be capturable (``capturable=True`` is turned
on where it exists; SGD needs none; others are refused). On the CPU the
same static-buffer code runs directly.

Not ported yet (ROADMAP.md): ``step_guard`` (resilience), the native
loader's ``BlockStacker`` wiring (``_wire_loader``), the overlap
scheduler, ZeRO-1 / uneven-shard storage and the observability hooks.
"""
import contextlib
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer import \
    reduce_bucket
from autodist_tpu_torch.kernel.synchronization.compressor import \
    all_reduce_mean_
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.utils import cuda_graph, logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import (flatten, flatten_with_path, leaves,
                                           path_to_name, tree_map, unflatten)


class TrainState(NamedTuple):
    """Distributed training state; each step updates it in place and hands
    back a new handle."""
    step: Any        # 0-dim int64 tensor on the host
    params: Any      # nested dict of tensors on this rank's device
    opt_state: Any   # the torch.optim.Optimizer over the trainable leaves


class Runner:
    """Drives the distributed train step for one program."""

    def __init__(self, program):
        self._program = program
        self._item = program.graph_item
        self._mesh = program.mesh
        self._remapper = Remapper(program)
        if self._item.optimizer is None:
            raise ValueError(
                "GraphItem has no optimizer; capture with a factory "
                "trainable_tensors -> torch.optim.Optimizer, e.g. "
                "functools.partial(torch.optim.SGD, lr=0.1)")
        if program.paddings():
            raise NotImplementedError(
                "uneven parameter shards (padded storage) are not ported to "
                "autodist_tpu_torch yet (ROADMAP.md)")
        self._trainable = self._mask_non_trainable(self._item)
        self._buckets = self.bucket_plan()
        self._graphs = {}  # megastep graphs by block structure

    @staticmethod
    def _mask_non_trainable(item):
        """Names of the leaves the optimizer updates. The others are frozen:
        they take no gradient and the optimizer never sees them, so they get
        no update and no weight decay."""
        return {v.name for v in item.trainable_variables}

    @property
    def remapper(self):
        return self._remapper

    @property
    def program(self):
        return self._program

    def bucket_plan(self):
        """The gradient reductions of one step, in order: lists of variable
        names. Fusable synchronizers of one fusion group and dtype share a
        bucket (one collective); the others reduce alone."""
        buckets, keyed = [], {}
        for name, sync in self._program.synchronizers.items():
            if getattr(sync, "fusable", False):
                key = (sync.group, sync.var.dtype)
                if key not in keyed:
                    keyed[key] = []
                    buckets.append(keyed[key])
                keyed[key].append(name)
            else:
                buckets.append([name])
        return buckets

    def _trainable_leaves(self, params):
        pairs, _ = flatten_with_path(params)
        named = [(path_to_name(p), t) for p, t in pairs]
        return [(n, t) for n, t in named if n in self._trainable]

    # -- state ---------------------------------------------------------------

    def create_state(self):
        """Copy the captured params onto this rank's device and build the
        optimizer over the trainable ones. The captured tree is untouched."""
        resolve_device(self._remapper.device)
        params = self._remapper.place_params(self._item.params, copy=True)
        leaves = [t.requires_grad_(True)
                  for _, t in self._trainable_leaves(params)]
        opt = self._item.optimizer(leaves)
        return TrainState(torch.zeros((), dtype=torch.int64), params, opt)

    _STALE_STATE_HINT = (
        "The state argument is donated each step: always continue from "
        "the state returned by the previous step(), not a stale handle.")

    def _check_state_live(self, state):
        """O(1) guard: a step marks the step counter of the state it
        consumed; that state's tensors were updated in place since."""
        if getattr(state.step, "_autodist_stale", False):
            raise RuntimeError(
                "autodist_tpu_torch: the TrainState passed to step() is "
                "stale: a later step updated its tensors in place. " +
                self._STALE_STATE_HINT)

    # -- the step ------------------------------------------------------------

    def _sync_gradients(self, grads):
        """Reduce ``grads`` ({name: tensor}) in place, bucket by bucket. A
        one-device local mesh (no process group) has nothing to reduce."""
        group = self._mesh.group()
        if group is None:
            return
        syncs = self._program.synchronizers
        for bucket in self._buckets:
            if len(bucket) > 1:
                reduce_bucket([grads[n] for n in bucket], group)
            else:
                syncs[bucket[0]].sync_gradient(grads[bucket[0]], group)

    def _core(self, params, opt, batch):
        """The part of a step a CUDA graph can capture: the loss, the
        gradients, their reduction, the optimizer's in-place update and the
        metrics tensors. No host bookkeeping."""
        item = self._item
        out = item.loss_fn(params, batch)
        loss, aux = out if item.aux_output else (out, None)
        named = self._trainable_leaves(params)
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        # Unused leaves get zeros (as jax.grad gives); the reduction writes
        # in place, so expanded (stride-0) gradients become real tensors.
        grads = {n: (torch.zeros_like(t) if g is None else g.contiguous())
                 for (n, t), g in zip(named, grads)}
        self._sync_gradients(grads)
        for n, t in named:
            t.grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        loss = loss.detach().float().clone()
        if self._mesh.group() is not None:
            all_reduce_mean_(loss, self._mesh.group())
        metrics = {"loss": loss, "notfinite": torch.logical_not(
            torch.isfinite(loss))}
        if aux is not None:
            metrics["aux"] = tree_map(lambda t: t.detach() if isinstance(
                t, torch.Tensor) else t, aux)
        return metrics

    @staticmethod
    def _advance(state, k):
        """The host side of ``k`` steps: the step counter, and the stale
        mark on the consumed state."""
        state.step._autodist_stale = True
        return TrainState(state.step + k, state.params, state.opt_state)

    def _step(self, state, batch):
        metrics = self._core(state.params, state.opt_state, batch)
        return self._advance(state, 1), metrics

    def step(self, state, batch, shard_inputs=True):
        """Run one distributed training step; returns (state, metrics).
        ``state`` is stale afterwards (updated in place)."""
        self._check_state_live(state)
        if shard_inputs:
            batch = self._remapper.shard_batch(batch)
        return self._step(state, batch)

    def make_callable(self, example_batch, shard_inputs=False, aot=False):
        """The bare step for hot loops: ``new_state, metrics = fn(state,
        batch)``, without the per-step liveness check; the caller always
        passes the state the previous call returned. ``shard_inputs=True``
        places each batch through the remapper first. The example batch is
        checked against the data axis.

        ``aot=True`` is the counterpart of the JAX package's ahead-of-time
        compiled step: on CUDA each call copies its batch into static
        buffers shaped like ``example_batch`` and replays one CUDA graph of
        the step (captured at the first call, which runs the real step
        eagerly as its warm-up). A batch of another structure, shape or
        dtype raises ``ValueError``; so does a state other than the one the
        first call was given (the graph is bound to its tensors)."""
        self._remapper.shard_batch(example_batch)
        if aot:
            step = _GraphStep(self, example_batch)
        else:
            step = self._step
        if not shard_inputs:
            return step
        shard = self._remapper.shard_batch
        return lambda state, batch: step(state, shard(batch))

    # -- fused multi-step dispatch ("megastep") ------------------------------

    def megastep(self, state, block, shard_inputs=True):
        """Run K training steps from a K-stacked batch block (leaf shapes
        ``(K,) + batch``; step i reads ``block[i]``) as ONE dispatch: a
        CUDA graph of the K steps, the counterpart of the JAX package's
        ``lax.scan`` megastep. Returns ``(state, metrics)`` with per-step
        metrics stacked ``(K,)`` and ``notfinite`` aggregated over the
        block with ``any`` on the device. ``state`` is stale afterwards."""
        self._check_state_live(state)
        if shard_inputs:
            block = self._remapper.shard_block(block)
        k = int(_leaf_spec(leaves(block)[0])[0][0])
        return self._megastep_fn(state, block, k)(state, block)

    def _megastep_fn(self, state, block, k):
        """Get-or-build the K-step graph for this block's structure. A
        graph is bound to the state it was captured over, so a new state
        (``create_state()`` again) gets a new graph."""
        flat, treedef = flatten(block)
        key = (k, treedef, tuple(_leaf_spec(l) for l in flat))
        fn = self._graphs.get(key)
        if fn is None or not fn.bound_to(state):
            fn = self._graphs[key] = _GraphStep(self, block, k)
        return fn

    def _next_block(self, data_iter, k):
        """Assemble a K-stacked block by pulling K batches off a per-step
        iterator (tensors with ``torch.stack``, the rest with
        ``np.stack``)."""
        flat = [flatten(next(data_iter)) for _ in range(k)]
        treedef = flat[0][1]
        out = []
        for j in range(len(flat[0][0])):
            parts = [f[0][j] for f in flat]
            if isinstance(parts[0], torch.Tensor):
                out.append(torch.stack(parts))
            else:
                out.append(np.stack([np.asarray(p) for p in parts]))
        return unflatten(treedef, out)

    def run(self, state, data_iter, num_steps, trace_dir=None,
            step_guard=None, unroll=None):
        """Drive ``num_steps`` steps from ``data_iter``; returns (state,
        last metrics). ``trace_dir`` records the loop with
        ``torch.profiler`` and writes a Chrome trace per rank there.

        ``unroll=K`` (env ``AUTODIST_UNROLL``, default 1) dispatches
        ``num_steps // K`` megasteps, each one CUDA graph of K steps over a
        block of K batches from ``data_iter``; ``num_steps`` must be a
        multiple of K. ``unroll=1`` steps eagerly, one ``step`` a batch."""
        if step_guard is not None:
            raise NotImplementedError(
                "step_guard (resilience/) is not ported to autodist_tpu_torch "
                "yet (ROADMAP.md)")
        if unroll is None:
            unroll = const.ENV.AUTODIST_UNROLL.val
        unroll = max(1, int(unroll))
        if num_steps % unroll:
            raise ValueError(
                f"autodist_tpu_torch: num_steps={num_steps} is not a "
                f"multiple of unroll={unroll}; megasteps dispatch whole "
                f"K-step blocks")
        profiler = contextlib.nullcontext()
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self._remapper.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
        metrics = None
        with profiler as prof:
            if unroll == 1:
                for _ in range(num_steps):
                    state, metrics = self.step(state, next(data_iter))
            else:
                for _ in range(num_steps // unroll):
                    state, metrics = self.megastep(
                        state, self._next_block(data_iter, unroll))
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            rank = dist.get_rank() if dist.is_initialized() else 0
            path = os.path.join(trace_dir, f"trace-rank{rank}.json")
            prof.export_chrome_trace(path)
            logging.info("profiler trace: %s", path)
        return state, metrics


def _leaf_spec(leaf):
    """(shape, torch dtype) of a batch leaf (tensor or array-like)."""
    t = torch.as_tensor(leaf)
    return tuple(t.shape), t.dtype


def _make_capturable(opt, device):
    """Ready ``opt`` for capture in a CUDA graph, or refuse it. An
    optimizer with a ``capturable`` option gets it turned on (on CUDA), and
    any ``state["step"]`` it already holds moves onto its parameter's
    device (a state may have taken eager steps first). SGD keeps no host
    state and needs nothing. Any other optimizer raises ``ValueError``:
    its step would read or write host state that a replay does not
    repeat."""
    if all("capturable" in g for g in opt.param_groups):
        if device.type == "cuda":
            for group in opt.param_groups:
                group["capturable"] = True
            for p, st in opt.state.items():
                step = st.get("step")
                if isinstance(step, torch.Tensor) and step.device != p.device:
                    st["step"] = step.to(p.device)
        return
    if type(opt) is torch.optim.SGD:
        return
    raise ValueError(
        f"autodist_tpu_torch: {type(opt).__name__} cannot be captured in a "
        f"CUDA graph (it has no capturable option): use an optimizer that "
        f"has one (Adam, AdamW, ...) or SGD, or the eager step "
        f"(make_callable(batch), run(unroll=1))")


def _stack_metrics(steps):
    """Per-step metrics stacked ``(K,)``; ``notfinite`` aggregated over the
    steps with ``any``, on the device."""
    out = {"loss": torch.stack([m["loss"] for m in steps]),
           "notfinite": torch.stack([m["notfinite"] for m in steps]).any()}
    if "aux" in steps[0]:
        flat = [flatten(m["aux"]) for m in steps]
        out["aux"] = unflatten(flat[0][1], [
            torch.stack(parts) if isinstance(parts[0], torch.Tensor)
            else parts[-1] for parts in zip(*(f[0] for f in flat))])
    return out


class _GraphStep:
    """A training step (``k=None``) or K steps over a K-stacked block,
    captured as one CUDA graph over static batch buffers and the tensors of
    the state of the first call (:class:`~autodist_tpu_torch.utils.
    cuda_graph.Graph`; on the CPU it runs directly). Each call checks the
    state and the batch, copies the batch in, replays, and hands back
    copies of the metrics: the next replay overwrites the graph's own."""

    _NOT_BOUND_HINT = (
        "The graph is bound to the tensors of the state its first call was "
        "given: pass the state the previous call returned, or build a new "
        "callable (make_callable(batch, aot=True)) for a new state.")

    def __init__(self, runner, example, k=None):
        self._runner = runner
        self.k = k
        flat, self._treedef = flatten(example)
        self._specs = [_leaf_spec(l) for l in flat]
        self._device = runner.remapper.device
        self._static = [torch.empty(shape, dtype=dtype, device=self._device)
                        for shape, dtype in self._specs]
        self._params = self._opt = self._leaves = None
        self.graph = cuda_graph.Graph(self._compute, self._device)

    def bound_to(self, state):
        return self._opt is None or (
            state.opt_state is self._opt and
            all(a is b for a, b in zip(leaves(state.params), self._leaves)))

    def _bind(self, state):
        _make_capturable(state.opt_state, self._device)
        self._params, self._opt = state.params, state.opt_state
        self._leaves = leaves(state.params)

    def _compute(self):
        batch = unflatten(self._treedef, self._static)
        core = self._runner._core
        if self.k is None:
            return core(self._params, self._opt, batch)
        return _stack_metrics([
            core(self._params, self._opt, tree_map(lambda t: t[i], batch))
            for i in range(self.k)])

    def _copy_in(self, batch):
        flat, treedef = flatten(batch)
        if treedef != self._treedef:
            raise ValueError(
                f"autodist_tpu_torch: batch structure {treedef} != the "
                f"captured structure {self._treedef}")
        cuda = self._device.type == "cuda"
        for leaf, buf, spec in zip(flat, self._static, self._specs):
            t = torch.as_tensor(leaf)
            if (tuple(t.shape), t.dtype) != spec:
                raise ValueError(
                    f"autodist_tpu_torch: batch leaf {tuple(t.shape)} "
                    f"{t.dtype} != the captured {spec[0]} {spec[1]}: the "
                    f"graph is specialized on the example batch's shapes "
                    f"and dtypes")
            if cuda and t.device.type == "cpu":
                t = t.pin_memory()
            buf.copy_(t, non_blocking=cuda)

    def __call__(self, state, batch):
        if self._opt is None:
            self._bind(state)
        elif not self.bound_to(state):
            raise RuntimeError(
                "autodist_tpu_torch: this state's tensors are not the ones "
                "the step's CUDA graph was captured over. " +
                self._NOT_BOUND_HINT)
        self._copy_in(batch)
        metrics = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, self.graph())
        return self._runner._advance(state, self.k or 1), metrics
