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

Not ported yet (ROADMAP.md): ``step_guard`` (resilience), ``unroll > 1``
(the fused megastep), the overlap scheduler, ZeRO-1 / uneven-shard storage
and the observability hooks.
"""
import contextlib
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer import \
    reduce_bucket
from autodist_tpu_torch.kernel.synchronization.compressor import \
    all_reduce_mean_
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import (flatten_with_path, path_to_name,
                                           tree_map)


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

    def _step(self, state, batch):
        item = self._item
        out = item.loss_fn(state.params, batch)
        loss, aux = out if item.aux_output else (out, None)
        named = self._trainable_leaves(state.params)
        leaves = [t for _, t in named]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # Unused leaves get zeros (as jax.grad gives); the reduction writes
        # in place, so expanded (stride-0) gradients become real tensors.
        grads = {n: (torch.zeros_like(t) if g is None else g.contiguous())
                 for (n, t), g in zip(named, grads)}
        self._sync_gradients(grads)
        opt = state.opt_state
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
        state.step._autodist_stale = True
        return TrainState(state.step + 1, state.params, opt), metrics

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
        checked against the data axis. ``aot=True`` (the JAX package's
        ahead-of-time compiled step) raises ``NotImplementedError``: its
        counterpart, a captured CUDA graph of the step, is not ported yet."""
        if aot:
            raise NotImplementedError(
                "make_callable(aot=True): the ahead-of-time step (a CUDA "
                "graph of the step here) is not ported to autodist_tpu_torch "
                "yet (ROADMAP.md, Queue A); call make_callable(batch) for "
                "the eager step")
        self._remapper.shard_batch(example_batch)
        if not shard_inputs:
            return self._step
        shard = self._remapper.shard_batch
        return lambda state, batch: self._step(state, shard(batch))

    def run(self, state, data_iter, num_steps, trace_dir=None,
            step_guard=None, unroll=None):
        """Drive ``num_steps`` steps from ``data_iter``; returns (state,
        last metrics). ``trace_dir`` records the loop with
        ``torch.profiler`` and writes a Chrome trace per rank there."""
        if step_guard is not None:
            raise NotImplementedError(
                "step_guard (resilience/) is not ported to autodist_tpu_torch "
                "yet (ROADMAP.md)")
        if unroll is not None and int(unroll) > 1:
            raise NotImplementedError(
                "unroll > 1 (the fused megastep) is not ported to "
                "autodist_tpu_torch yet (ROADMAP.md)")
        profiler = contextlib.nullcontext()
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self._remapper.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
        metrics = None
        with profiler as prof:
            for _ in range(num_steps):
                state, metrics = self.step(state, next(data_iter))
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            rank = dist.get_rank() if dist.is_initialized() else 0
            path = os.path.join(trace_dir, f"trace-rank{rank}.json")
            prof.export_chrome_trace(path)
            logging.info("profiler trace: %s", path)
        return state, metrics
