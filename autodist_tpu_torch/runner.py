"""Runner: the distributed train step and the step loop.

Counterpart of ``autodist_tpu/runner.py``: ``TrainState``, ``create_state``,
``step``, ``make_callable``, ``megastep``, ``run`` and ``logical_params``.
One step, on every rank:

1. the loss on this rank's local batch, over each parameter's compute view
   (PyTorch runs eagerly: nothing to compile);
2. gradients by ``torch.autograd.grad`` over the stored trainable leaves;
3. the reduction each variable's kind prescribes (the program's
   ``var_kinds()``; the JAX Runner's explicit path,
   ``autodist_tpu/runner.py:700-1040``) over the data axis's process
   group:

   * ``ar``: same-group fusable gradients as one flat bucket per (group,
     dtype) through ``torch.distributed.all_reduce``, divided by the
     group's size (the strategy's groups decide the buckets, not
     ``DistributedDataParallel``);
   * ``zero1`` (a PS variable, its optimizer state split): the gradient
     ``reduce_scatter_tensor``-ed onto this rank's state shard, divided by
     the group's size; the optimizer holds the shard tensors;
   * ``fsdp`` (the parameter split): the rank stores only its (padded)
     piece; :class:`_GatherShards` all-gathers it for the forward and its
     backward reduce-scatters the gradient, as the VJP of JAX's tiled
     ``all_gather`` does;
   * ``stale``: no reduction; each rank updates its own copy;

4. the optimizer step (shard-local for ``zero1`` / ``fsdp``, which assumes
   an optimizer that works element by element, as the JAX Runner does;
   others are refused), then ``all_gather_into_tensor`` of each ``zero1``
   shard into the whole parameter, and after every step ``t`` with
   ``t % (s + 1) == s`` the mean of each stale parameter over the group;
5. the loss's mean over the data group.

Under sequence parallelism (a ``seq`` axis, ``SequenceParallel``) the
loss runs inside the program's parallel context (``parallel/context.py``),
so the model's attention takes the ring or Ulysses hook and each rank
computes its chunk of the sequence; the ``ar`` gradients and the loss
are then averaged over the data x seq group, and the other kinds take a
mean over the seq group before their data-axis lowering. The ranks of one
seq group must be fed one batch: an eager step compares their batches
(one all-gather over the seq group) and raises on a mismatch. The graph
paths refuse a seq axis (their capture of the ring is ROADMAP item A15).

Uneven dims are stored padded (``DistributedProgram.paddings``): the
compute view cuts the logical rows out and the padded rows take zero
gradients; :meth:`Runner.logical_params` gives the logical tree.

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
the capture's warm-up (it also issues every collective the step uses, so
the communicator exists before capture), then captures: after N calls the
state has taken N steps. A graph cannot branch on the host's step count,
so with stale variables there is one graph per phase of the staleness
period (the JAX step branches with ``lax.cond``). The optimizer must be
capturable (``capturable=True`` is turned on where it exists; SGD needs
none; others are refused). On the CPU the same static-buffer code runs
directly.

``to_logical`` / ``from_logical`` carry a state to and from its
checkpoint form (whole, unpadded params and optimizer state by variable
name); ``run(step_guard=)`` is the divergence-safe loop
(``resilience.StepGuard``): the device-side ``notfinite`` flag is read
every ``check_every`` steps (rounded up to a multiple of K under
``unroll=K``), a healthy check refreshes the guard's snapshot, a
diverged one copies the snapshot back into the state's own tensors (so a
graph bound to them stays bound) and skips the offending batches.

Not ported yet (ROADMAP.md): the native loader's ``BlockStacker`` wiring
(``_wire_loader``), the overlap scheduler and the observability hooks.
"""
import contextlib
import math
import os
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer import \
    reduce_bucket
from autodist_tpu_torch.kernel.synchronization.compressor import \
    all_reduce_mean_
from autodist_tpu_torch.parallel import context as parallel_context
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.utils import cuda_graph, logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import (flatten, flatten_with_path, leaves,
                                           path_to_name, tree_map,
                                           tree_map_with_path, unflatten)


class TrainState(NamedTuple):
    """Distributed training state; each step updates it in place and hands
    back a new handle. The checkpoint form (:meth:`Runner.to_logical`)
    holds logical tensors instead, and ``opt_state`` there is a tree
    congruent with ``params`` of each variable's optimizer state dict."""
    step: Any        # 0-dim int64 tensor on the host
    params: Any      # nested dict of tensors at their stored layout
    opt_state: Any   # the torch.optim.Optimizer over the update tensors


# Optimizers whose step treats every element of a parameter on its own
# (the shard-local update of zero1 / fsdp variables gives the same values
# as the whole update): torch's standard ones.
ELEMENTWISE_OPTIMIZERS = (
    torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW, torch.optim.Adamax,
    torch.optim.NAdam, torch.optim.RAdam, torch.optim.RMSprop,
    torch.optim.Adagrad, torch.optim.Adadelta, torch.optim.ASGD,
    torch.optim.Rprop)


class _GatherShards(torch.autograd.Function):
    """A split (``fsdp``) parameter's pieces all-gathered along ``dim``
    over ``group``; the backward reduce-scatters the gradient (the sum
    over the group lands on this rank's piece), as the VJP of JAX's tiled
    ``all_gather`` (``autodist_tpu/runner.py:839-846``)."""

    @staticmethod
    def forward(ctx, piece, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(piece, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


def _all_gather(piece, dim, group):
    """The group's pieces concatenated along ``dim`` (rank order), as a new
    tensor (``all_gather_into_tensor`` gathers along dim 0: a piece split
    along another dim is moved to the front, and the result moved back)."""
    moved = piece.detach().movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = moved.new_empty((moved.shape[0] * n,) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(whole, dim, group):
    """This rank's piece along ``dim`` of the sum of ``whole`` over the
    group (``reduce_scatter_tensor`` along dim 0, moved as in
    :func:`_all_gather`)."""
    moved = whole.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


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
        self._trainable = self._mask_non_trainable(self._item)
        self._kinds = program.var_kinds()
        placements = program.param_placements()
        self._placements = {path_to_name(p): pl for p, pl in
                            flatten_with_path(placements)[0]}
        self._buckets = self.bucket_plan()
        # Stale variables by period (s + 1); the step's phase is the step
        # count modulo their lcm.
        self._periods = {name: s.staleness + 1 for name, s in
                         program.synchronizers.items() if s.staleness > 0}
        self._period = math.lcm(*self._periods.values()) \
            if self._periods else 1
        self._shards = weakref.WeakKeyDictionary()  # optimizer -> zero1
        self._graphs = {}  # megastep graphs by block structure and phase
        # Under a seq axis the seq group shares batch rows: gradients and
        # the loss average over data x seq.
        self._seq_group = None
        self._grad_group = self._mesh.group()
        if program.seq_axis_size > 1:
            self._seq_group = self._mesh.group(const.MESH_AXIS_SEQ)
            self._grad_group = self._mesh.group_over(
                (const.MESH_AXIS_DATA, const.MESH_AXIS_SEQ))

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

    @property
    def var_kinds(self):
        """{var_name: (kind, dim)}: ``stale``, ``fsdp``, ``zero1`` or
        ``ar`` (``DistributedProgram.var_kinds``)."""
        return self._kinds

    def bucket_plan(self):
        """The all-reduces of one step's ``ar`` gradients, in order: lists
        of variable names. Fusable synchronizers of one fusion group and
        dtype share a bucket (one collective); the others reduce alone.
        ``zero1`` / ``fsdp`` / ``stale`` variables take no all-reduce."""
        buckets, keyed = [], {}
        for name, sync in self._program.synchronizers.items():
            if self._kinds[name][0] != "ar":
                continue
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

    def _kind(self, name):
        return self._kinds.get(name, ("ar", None))

    # -- state ---------------------------------------------------------------

    def create_state(self):
        """Place the captured params on this rank's device at their stored
        layout (padded; an ``fsdp`` variable's piece only) and build the
        optimizer over the update tensors: the stored trainable leaves,
        except that a ``zero1`` variable's is this rank's shard of it (a
        tensor of its own, ``1/n`` of the variable, so its optimizer state
        is too). The captured tree is untouched."""
        resolve_device(self._remapper.device)
        params = self._remapper.place_params(self._item.params, copy=True)
        update, shards = [], {}
        for name, t in self._trainable_leaves(params):
            t.requires_grad_(True)
            kind, dim = self._kind(name)
            if kind == "zero1":
                n = self._program.data_axis_size
                size = t.shape[dim] // n
                index = self._placements[name].index
                shards[name] = t.detach().narrow(
                    dim, index * size, size).clone()
                update.append(shards[name])
            else:
                update.append(t)
        opt = self._item.optimizer(update)
        if any(k in ("zero1", "fsdp") for k, _ in self._kinds.values()) and \
                not isinstance(opt, ELEMENTWISE_OPTIMIZERS):
            raise ValueError(
                f"autodist_tpu_torch: {type(opt).__name__} cannot update a "
                f"variable shard by shard: the PS / partitioned lowering "
                f"runs the optimizer on each rank's shard, which gives the "
                f"whole update only for an optimizer that treats each "
                f"element on its own "
                f"({', '.join(c.__name__ for c in ELEMENTWISE_OPTIMIZERS)}). "
                f"Build the strategy with gspmd_update=True (PS family), "
                f"or use AllReduce()")
        self._shards[opt] = shards
        return TrainState(torch.zeros((), dtype=torch.int64), params, opt)

    def logical_params(self, state):
        """The params at their logical shapes, detached: padding cut off,
        an ``fsdp`` variable's pieces all-gathered (a collective: every
        rank of the data group calls it), a stale variable this rank's
        copy (the JAX Runner's stored array holds every device's copy)."""
        group = self._mesh.group()

        def logical(path, t):
            name = path_to_name(path)
            kind, dim = self._kind(name)
            t = t.detach()
            if kind == "fsdp":
                t = _all_gather(t, dim, group)
            return self._cut_padding(name, t)
        return tree_map_with_path(logical, state.params)

    def _cut_padding(self, name, t):
        placement = self._placements.get(name)
        if placement is None or placement.padding is None:
            return t
        dim, logical, _ = placement.padding
        return t.narrow(dim, 0, logical)

    def _update_tensors(self, state):
        """[(name, tensor)] the optimizer updates, one per trainable
        leaf: the stored leaf, or a ``zero1`` variable's shard."""
        shards = self._shards.get(state.opt_state, {})
        return [(n, shards.get(n, t)) for n, t in
                self._trainable_leaves(state.params)]

    def to_logical(self, state):
        """The state at logical shapes, the checkpoint form: the params as
        :meth:`logical_params` gives them, and ``opt_state`` a tree
        congruent with them of each trainable variable's optimizer state
        (``{"exp_avg": ..., "step": ...}`` for Adam; ``{}`` for a frozen
        variable or before the optimizer's first step). A state tensor
        shaped like its variable's update tensor is gathered (``zero1``
        shards, ``fsdp`` pieces: a collective every rank of the data group
        calls) and cut to the logical shape; the others (``step``) are kept
        as they are. Tensors are detached views or gathered copies on the
        device."""
        group = self._mesh.group()
        per_var = {}
        for name, t in self._update_tensors(state):
            kind, dim = self._kind(name)
            out = {}
            for key, v in state.opt_state.state.get(t, {}).items():
                if not isinstance(v, torch.Tensor):
                    raise TypeError(
                        f"autodist_tpu_torch: optimizer state {name}/{key} "
                        f"is a {type(v).__name__}, not a tensor: only "
                        f"tensor state has a checkpoint form")
                v = v.detach()
                if v.dim() and v.shape == t.shape:
                    if kind in ("zero1", "fsdp") and group is not None:
                        v = _all_gather(v, dim, group)
                    v = self._cut_padding(name, v)
                out[key] = v
            per_var[name] = out
        opt_state = tree_map_with_path(
            lambda path, _: per_var.get(path_to_name(path), {}),
            state.params)
        return TrainState(state.step.clone(), self.logical_params(state),
                          opt_state)

    def initial_logical(self):
        """The checkpoint form of a fresh state: the captured params, step
        0, no optimizer state."""
        return TrainState(torch.zeros((), dtype=torch.int64),
                          self._item.params,
                          tree_map(lambda _: {}, self._item.params))

    def from_logical(self, logical, into=None):
        """A state from its checkpoint form (host or device tensors): each
        param and each optimizer state tensor shaped like its variable
        placed as ``Remapper.place_params`` places the param (padded, cut
        to this rank's ``fsdp`` piece), a ``zero1`` variable's shard taken
        from the whole; the other state tensors (``step``) as they are.

        ``into`` (a live state of this runner) receives the values in its
        own tensors (``copy_``, outside any capture), so a CUDA graph bound
        to them stays bound and a capturable optimizer's device ``step``
        stays on the device; ``into`` is stale afterwards. Without it a
        fresh state is created first. An optimizer with no state yet gets
        it made by one step over zero gradients before the values are
        copied in (each tensor then has the dtype and device the optimizer
        gives it); a variable whose saved state is empty has its state
        dropped, and the graph steps bound to the state capture anew at
        their next call."""
        state = self.create_state() if into is None else into
        logical_leaves = {path_to_name(p): torch.as_tensor(t) for p, t in
                          flatten_with_path(logical.params)[0]}
        live = [(path_to_name(p), t) for p, t in
                flatten_with_path(state.params)[0]]
        if set(logical_leaves) != {n for n, _ in live}:
            raise ValueError(
                f"autodist_tpu_torch: the logical params' leaves "
                f"{sorted(logical_leaves)[:5]} are not this program's "
                f"{sorted(n for n, _ in live)[:5]}")
        saved_opt = _state_dicts(logical.opt_state, logical_leaves)
        opt = state.opt_state
        update = self._update_tensors(state)
        if any(saved_opt.get(n) and not opt.state.get(t) for n, t in update):
            _prime_optimizer(opt, [t for _, t in update])
        dropped = False
        with torch.no_grad():
            for name, t in live:
                value = self._stored(name, logical_leaves[name], shard=False)
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(
                        f"autodist_tpu_torch: {name}: stored shape "
                        f"{tuple(value.shape)} != the live {tuple(t.shape)}")
                t.copy_(value)
            for name, t in update:
                shape = tuple(logical_leaves[name].shape)
                if self._kind(name)[0] == "zero1":
                    t.copy_(self._stored(name, logical_leaves[name]))
                saved = saved_opt.get(name) or {}
                if not saved:
                    dropped |= bool(opt.state.pop(t, None))
                    continue
                target = opt.state[t]
                if set(target) != set(saved):
                    raise ValueError(
                        f"autodist_tpu_torch: {name}: optimizer state keys "
                        f"{sorted(saved)} != the live optimizer's "
                        f"{sorted(target)} (another optimizer?)")
                for key, v in saved.items():
                    v = torch.as_tensor(v)
                    if v.dim() and tuple(v.shape) == shape:
                        v = self._stored(name, v)
                    target[key].copy_(v)
        if dropped:
            _bump_generation(opt)
        if into is not None:
            into.step._autodist_stale = True
        return TrainState(torch.tensor(int(logical.step), dtype=torch.int64),
                          state.params, opt)

    def _stored(self, name, value, shard=True):
        """A tensor at variable ``name``'s logical shape at its stored
        layout on this rank's device: padded, cut to the ``fsdp`` piece,
        and with ``shard`` a ``zero1`` variable's shard of the whole."""
        placement = self._placements[name]
        t = self._remapper.place_params(value, placements=placement,
                                        copy=True)
        kind, dim = self._kind(name)
        if shard and kind == "zero1":
            size = t.shape[dim] // self._program.data_axis_size
            t = t.narrow(dim, placement.index * size, size)
        return t

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

    def _compute_view(self, params):
        """The params the loss sees: ``fsdp`` pieces all-gathered (through
        :class:`_GatherShards`, so their gradients reduce-scatter), padding
        cut off."""
        group = self._mesh.group()

        def view(path, t):
            name = path_to_name(path)
            kind, dim = self._kind(name)
            if kind == "fsdp":
                t = _GatherShards.apply(t, dim, group)
            return self._cut_padding(name, t)
        return tree_map_with_path(view, params)

    def _sync_gradients(self, grads):
        """Reduce ``grads`` ({name: gradient of the stored leaf}) over the
        data group, by kind; a ``zero1`` gradient is replaced by this
        rank's shard of the mean. Under a seq axis the ``ar`` buckets
        reduce over the data x seq group and every other kind first takes
        its mean over the seq group. A one-device local mesh (no process
        group) has nothing to reduce."""
        group = self._mesh.group()
        if group is None:
            return
        syncs = self._program.synchronizers
        for bucket in self._buckets:
            if len(bucket) > 1:
                reduce_bucket([grads[n] for n in bucket], self._grad_group)
            else:
                syncs[bucket[0]].sync_gradient(grads[bucket[0]],
                                               self._grad_group)
        n = self._program.data_axis_size
        for name, (kind, dim) in self._kinds.items():
            if kind != "ar" and self._seq_group is not None:
                all_reduce_mean_(grads[name], self._seq_group)
            if kind == "zero1":
                grads[name] = _reduce_scatter(grads[name], dim, group).div_(n)
            elif kind == "fsdp":  # born reduce-scattered (the sum)
                grads[name].div_(n)

    def _check_seq_batch(self, batch):
        """Raise unless every rank of this rank's seq group holds this
        batch, shapes and bytes (two all-gathers over the seq group: the
        lengths, then the bytes). Attention over mismatched sequences
        would train on neither."""
        flat = [torch.as_tensor(l).detach() for l in leaves(batch)]
        device = flat[0].device if flat else self._remapper.device
        shapes = torch.tensor([d for t in flat for d in (t.dim(),) +
                               tuple(t.shape)], dtype=torch.int64)
        mine = torch.cat([shapes.to(device).view(torch.uint8)] + [
            t.contiguous().reshape(-1).view(torch.uint8) for t in flat])
        group, p = self._seq_group, self._program.seq_axis_size
        length = torch.tensor([mine.numel()], dtype=torch.int64,
                              device=device)
        lengths = length.new_empty(p)
        dist.all_gather_into_tensor(lengths, length, group=group)
        same = bool((lengths == length).all())
        if same:
            everyone = mine.new_empty(p * mine.numel())
            dist.all_gather_into_tensor(everyone, mine, group=group)
            same = bool((everyone.view(p, -1) == mine).all())
        if not same:
            raise ValueError(
                "autodist_tpu_torch: the ranks of a seq group were fed "
                "different batches; under sequence parallelism every rank "
                "of a seq group takes the same batch (each computes its "
                "chunk of the sequence)")

    def _finish_update(self, params, shards, step):
        """After the optimizer: each ``zero1`` shard all-gathered into its
        whole parameter, and the stale parameters whose period ends at
        ``step`` averaged over the group."""
        group = self._mesh.group()
        if group is None:
            return
        named = dict(self._trainable_leaves(params))
        with torch.no_grad():
            for name, shard in shards.items():
                dim = self._kinds[name][1]
                named[name].copy_(_all_gather(shard, dim, group))
            for name, period in self._periods.items():
                if step % period == period - 1:
                    all_reduce_mean_(named[name], group)

    def _core(self, params, opt, batch, step=0):
        """The part of a step a CUDA graph can capture: the loss, the
        gradients, their reduction, the optimizer's in-place update, the
        gathers and stale averages, and the metrics tensors. ``step`` is
        the step's count (only its phase in the staleness period
        matters). No host bookkeeping."""
        item = self._item
        with parallel_context.use(self._program.parallel_context()):
            out = item.loss_fn(self._compute_view(params), batch)
        loss, aux = out if item.aux_output else (out, None)
        named = self._trainable_leaves(params)
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        # Unused leaves get zeros (as jax.grad gives); the reduction writes
        # in place, so expanded (stride-0) gradients become real tensors.
        grads = {n: (torch.zeros_like(t) if g is None else g.contiguous())
                 for (n, t), g in zip(named, grads)}
        self._sync_gradients(grads)
        shards = self._shards.get(opt, {})
        for n, t in named:
            shards.get(n, t).grad = grads[n]
        opt.step()
        opt.zero_grad(set_to_none=True)
        self._finish_update(params, shards, step)
        loss = loss.detach().float().clone()
        if self._grad_group is not None:
            all_reduce_mean_(loss, self._grad_group)
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
        if self._seq_group is not None:
            self._check_seq_batch(batch)
        metrics = self._core(state.params, state.opt_state, batch,
                             int(state.step))
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
            # The runner owns these graphs: they refer back to it weakly.
            fn = self._graphs[key] = _GraphStep(weakref.proxy(self), block,
                                                k)
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
        multiple of K. ``unroll=1`` steps eagerly, one ``step`` a batch.

        With ``step_guard`` (:class:`~autodist_tpu_torch.resilience.
        StepGuard`) the loop is divergence-safe: the guard reads the
        device-side ``notfinite`` flag every ``check_every`` steps (rounded
        up to a multiple of K), keeps a device copy of the last healthy
        state, and on divergence copies it back (``CheckpointManager.run``
        rolls back to the last checkpoint instead), skipping the offending
        batches. The snapshot is a second resident copy of the params and
        the optimizer state. ``AUTODIST_CHAOS``'s ``nan_at`` / ``oom_at``
        inject their faults here."""
        if unroll is None:
            unroll = const.ENV.AUTODIST_UNROLL.val
        unroll = max(1, int(unroll))
        if num_steps % unroll:
            raise ValueError(
                f"autodist_tpu_torch: num_steps={num_steps} is not a "
                f"multiple of unroll={unroll}; megasteps dispatch whole "
                f"K-step blocks")
        chaos = None
        if const.ENV.AUTODIST_CHAOS.val:
            from autodist_tpu_torch.resilience import chaos
        profiler = contextlib.nullcontext()
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self._remapper.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
        with profiler as prof:
            state, metrics = self._run_loop(state, data_iter, num_steps,
                                            step_guard, chaos, unroll)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            rank = dist.get_rank() if dist.is_initialized() else 0
            path = os.path.join(trace_dir, f"trace-rank{rank}.json")
            prof.export_chrome_trace(path)
            logging.info("profiler trace: %s", path)
        return state, metrics

    def _run_loop(self, state, data_iter, num_steps, step_guard, chaos,
                  unroll):
        """One ``step`` a batch, or one ``megastep`` a K-block, with the
        guard part of the JAX Runner's ``_run_observed``
        (``autodist_tpu/runner.py:1529-1760``): chaos injection before each
        dispatch, the flag read at the guard's cadence (K-block boundaries
        under ``unroll=K``), snapshot on a healthy check, rollback on a
        diverged one."""
        if step_guard is not None:
            step_guard.mark_good(0, state)
        metrics = None
        i = 0
        while i < num_steps:
            if unroll == 1:
                batch = next(data_iter)
            else:
                batch = self._next_block(data_iter, unroll)
            if chaos is not None:
                batch = chaos.maybe_poison_batch(i + 1, batch)
                chaos.maybe_oom(i + 1)
            if unroll == 1:
                state, metrics = self.step(state, batch)
            else:
                state, metrics = self.megastep(state, batch)
            i += unroll
            if step_guard is not None and (step_guard.due(i, unroll)
                                           or i >= num_steps):
                if step_guard.diverged(metrics):
                    i, state = step_guard.rollback(i)
                else:
                    step_guard.progressed()
                    step_guard.mark_good(i, state)
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


def optimizer_generation(opt):
    """How many times the port replaced ``opt``'s state tensors (a
    rollback or restore to a state from before its first step); a graph
    step captured over older ones captures anew."""
    return getattr(opt, "_autodist_generation", 0)


def _bump_generation(opt):
    opt._autodist_generation = optimizer_generation(opt) + 1


def _prime_optimizer(opt, tensors):
    """Make ``opt`` create its state for ``tensors``: one step over zero
    gradients. The values it writes are the caller's to overwrite."""
    for t in tensors:
        t.grad = torch.zeros_like(t)
    opt.step()
    opt.zero_grad(set_to_none=True)


def _state_dicts(opt_tree, names):
    """{name: optimizer state dict} read from a checkpoint-form
    ``opt_state`` tree (nested dicts / lists, or the dicts a raw read
    gives for lists) by each variable's '/'-joined path; ``{}`` where it
    holds nothing."""
    out = {}
    for name in names:
        node = opt_tree
        for part in name.split("/"):
            if isinstance(node, dict):
                node = node.get(part)
            elif isinstance(node, (list, tuple)) and part.isdigit() and \
                    int(part) < len(node):
                node = node[int(part)]
            else:
                node = None
            if node is None:
                break
        out[name] = node if isinstance(node, dict) else {}
    return out


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
    copies of the metrics: the next replay overwrites the graph's own.
    With stale variables the step's collectives depend on its phase in the
    staleness period, so there is one graph per phase (of the first step),
    each captured at its first call."""

    _NOT_BOUND_HINT = (
        "The graph is bound to the tensors of the state its first call was "
        "given: pass the state the previous call returned, or build a new "
        "callable (make_callable(batch, aot=True)) for a new state.")

    def __init__(self, runner, example, k=None):
        if runner.program.seq_axis_size > 1:
            raise NotImplementedError(
                "autodist_tpu_torch: a sequence-parallel step runs eagerly: "
                "capturing the ring's hops in a CUDA graph is not ported "
                "yet (ROADMAP.md, Queue A item 15); use step() or "
                "run(unroll=1)")
        self._runner = runner
        self.k = k
        flat, self._treedef = flatten(example)
        self._specs = [_leaf_spec(l) for l in flat]
        self._device = runner.remapper.device
        self._static = [torch.empty(shape, dtype=dtype, device=self._device)
                        for shape, dtype in self._specs]
        self._params = self._opt = self._leaves = None
        self.graphs = {}  # phase -> Graph

    def _graph(self, phase):
        graph = self.graphs.get(phase)
        if graph is None:
            graph = self.graphs[phase] = cuda_graph.Graph(
                cuda_graph.weak_call(self, lambda g: g._compute(phase)),
                self._device)
        return graph

    @property
    def graph(self):
        """The graph of phase 0: the only one without stale variables."""
        return self._graph(0)

    def bound_to(self, state):
        return self._opt is None or (
            state.opt_state is self._opt and
            all(a is b for a, b in zip(leaves(state.params), self._leaves)))

    def _bind(self, state):
        _make_capturable(state.opt_state, self._device)
        self._params, self._opt = state.params, state.opt_state
        self._leaves = leaves(state.params)
        self._generation = optimizer_generation(state.opt_state)

    def _compute(self, phase):
        batch = unflatten(self._treedef, self._static)
        core = self._runner._core
        if self.k is None:
            return core(self._params, self._opt, batch, phase)
        return _stack_metrics([
            core(self._params, self._opt, tree_map(lambda t: t[i], batch),
                 phase + i) for i in range(self.k)])

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
        elif optimizer_generation(self._opt) != self._generation:
            # The optimizer's state was dropped (a rollback or restore to a
            # state from before its first step): capture anew over the
            # state tensors the next step creates.
            self.graphs = {}
            self._bind(state)
        self._copy_in(batch)
        graph = self._graph(int(state.step) % self._runner._period)
        metrics = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, graph())
        return self._runner._advance(state, self.k or 1), metrics
