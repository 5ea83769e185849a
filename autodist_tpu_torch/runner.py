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
   * ``tp`` (the parameter split over the ``model``, ``expert`` or
     ``pipe`` axis, or two of them, ``ModelParallel`` / ``Pipeline``):
     the rank stores its piece. Over each axis that splits it, a Megatron
     layer's weight, an MoE layer's experts or hidden columns, or a
     stage's layers reach the loss as they are (the layer's collectives
     make its gradient this piece's); over any other it is all-gathered
     over the axis's group through :class:`_GatherShards`, whose backward
     reduce-scatters the gradient and divides it by the group's size
     (every rank of the group computed the same whole gradient). The
     gradient is then averaged over the data group and the shared axes
     that do not split it;

4. the optimizer step (shard-local for ``zero1`` / ``fsdp``, which assumes
   an optimizer that works element by element, as the JAX Runner does;
   others are refused), then ``all_gather_into_tensor`` of each ``zero1``
   shard into the whole parameter, and after every step ``t`` with
   ``t % (s + 1) == s`` the mean of each stale parameter over the group;
5. the loss's mean over the data group.

Under tensor or expert parallelism (a ``model`` or ``expert`` axis) the
ranks of one model (expert) group must be fed one batch. The gradients of
whole parameters and the loss, which every rank of such a group computes
whole, average over data x that axis: on the card the ranks' gradients of
a whole parameter differ in the last bits (scatter-add atomics), and the
mean keeps their copies bitwise equal.

Under pipeline parallelism (a ``pipe`` axis, ``Pipeline``) a rank stores
its stage: the variables split over ``pipe`` (kind ``tp`` over the pipe
group) reach the loss as its pieces and are never gathered, and
``scan_blocks`` runs them on the pipeline schedule (``pipeline/``), whose
output every rank of the pipe group holds whole, so every rank computes the
head and the loss alike. The ranks of a pipe group must be fed one batch
(stage 0 reads the inputs, every stage the loss). Each rank seeds its
backward with ``1 / S`` (S the pipe axis's size): the schedule's backward
sums the output's cotangents over the pipe group onto the last stage, and
the whole parameters' gradients (the head, counted on every rank, and the
embedding, whose input part arises on stage 0 alone) are summed over the
pipe group and averaged over the data group, so the group's sum is the
one-device gradient and the ranks' copies stay bitwise equal.

Under sequence parallelism (a ``seq`` axis, ``SequenceParallel``) the
loss runs inside the program's parallel context (``parallel/context.py``),
so the model's attention takes the ring or Ulysses hook and each rank
computes its chunk of the sequence; every rank of a seq group must be fed
one batch. A rank's gradient is its chunk's part of the gradient of the
group's summed losses (the ring carries the other chunks' parts back to
it), so the seq group's mean is the gradient of the mean loss.

The seq axis composes with one piece axis, model or pipe, and two piece
axes compose with each other (``{pipe, model}``, ``{expert, model}``: a
variable split over both by a composed partitioner, ``"0:2:pipe,2:2:
model"``). A rank shares its batch rows over every such axis, and one set
of rules holds for all:

* an eager step compares the batches of the ranks that share them (one
  all-gather over the group of those axes, ``Mesh.group_over``) and
  raises on a mismatch;
* the ``ar`` gradients and the loss average over data x seq x the piece
  axes, each multiplied by S under a pipe axis (the pipe group's sum, with
  the ``1 / S`` seed kept); the other kinds first take the same mean (the
  pipe group's sum) over seq x the piece axes before their data-axis
  lowering;
* a piece's gradient (a Megatron weight, an MoE layer's experts, a
  stage's layers) averages over data x seq x the piece axes that do not
  split it (its piece group holds the other pieces, not copies), times S
  where pipe does not split it: a stage's layer norm, split over pipe
  alone, averages over data x model; the embedding split over model
  alone sums over pipe; an MoE layer's experts split over both average
  over data;
* the logical forms gather a piece over the group of each axis that
  splits it: no parameter is split over seq.

The expert axis composes with neither seq nor pipe, and the seq axis with
one piece axis only (``GraphTransformer`` refuses the rest, ROADMAP items
A10 (i)-seq, (j)-expert and (k)).

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
the capture's warm-up (it also issues every collective the step uses, over
every group and in every hop direction, so NCCL's communicators and its
point-to-point connections exist before capture), then captures: after N
calls the state has taken N steps. A graph cannot branch on the host's
step count, so with stale variables there is one graph per phase of the
staleness period (the JAX step branches with ``lax.cond``); every rank
takes the same phase at the same call, so the ranks capture the same
collectives in the same order. The optimizer must be capturable
(``capturable=True`` is turned on where it exists; SGD needs none; others
are refused).

The graph paths run under every axis the eager step runs under (data,
seq, model, expert, pipe, seq x model, pipe x seq): the ring's and the
pipeline's hops, the Megatron and expert all-reduces and gathers, and the
pipe schedule's ticks are all fixed by the step's shapes. Two things
differ from the eager step. The batch check of the ranks that share a
batch (two all-gathers and a host read) runs once, on the batch (block)
of a graph step's first call, and not on its replays. And a capture needs
NCCL: over a gloo group (whose collectives stage CUDA tensors through the
host) a graph step on CUDA raises ``RuntimeError``; it never runs the
eager step instead. On the CPU the same static-buffer code runs directly,
over any backend.

``to_logical`` / ``from_logical`` carry a state to and from its
checkpoint form (whole, unpadded params and optimizer state by variable
name); ``run(step_guard=)`` is the divergence-safe loop
(``resilience.StepGuard``): the device-side ``notfinite`` flag is read
every ``check_every`` steps (rounded up to a multiple of K under
``unroll=K``), a healthy check refreshes the guard's snapshot, a
diverged one copies the snapshot back into the state's own tensors (so a
graph bound to them stays bound) and skips the offending batches.

Telemetry (``observability/``, on unless ``AUTODIST_TELEMETRY=0``):
``run`` records the JAX Runner's step metrics (``step.latency_ms``,
``step.data_wait_ms``, ``step.count``, ``step.examples``,
``step.examples_per_sec``, ``step.unroll``), the ``step-loop`` span, and
the attribution, memory, pipeline and goodput ledgers, finalized after the
loop, then gathers the ranks' snapshots on the chief and flushes the
trace; a graph step's capture runs in a ``compile`` span. One difference:
on CUDA a dispatch returns once its work is queued, so each dispatch's
wall time is the interval between ``torch.cuda.Event``s recorded after
consecutive dispatches (read without a sync at the guard's cadence, and
after one sync at the loop's end), not the host clock's delta; the data
wait stays on the host clock. With telemetry off the loop makes no
telemetry call at all.

With telemetry on, ``run`` also folds each dispatch's window into the
skew ring (``observability/skew.py``; on CUDA anchored from the CUDA
events at the loop's final drain) and finalizes the per-layer profile
(``observability/profile.py``): from the ``torch.profiler`` trace under
``AUTODIST_TRACE=profiler``, after the profiler stops, else from the
model's costs. The chief starts the live monitor
(``observability/monitor.py``) when ``AUTODIST_MONITOR_PORT`` is set.

The chief renders the transform report (``report.py``) at each of the
port's compiles: a Runner's first eager dispatch and each graph capture.
``write_report`` adds the compiled step's section and ``dump_compiled``
writes its op text: one whole step recorded on ``meta`` tensors, its
collectives recorded and not run (``utils/step_text.py``), the
counterpart of the JAX step's HLO.

Not ported yet (ROADMAP.md): the overlap scheduler (A9b) and with it
``dump_scheduled``, and the online re-tuning controller (A12).
"""
import contextlib
import math
import os
import time
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer import \
    reduce_bucket
from autodist_tpu_torch.kernel.synchronization.compressor import \
    all_reduce_mean_
from autodist_tpu_torch.parallel import context as parallel_context
from autodist_tpu_torch.parallel.collectives import GatherShards as \
    _GatherShards
from autodist_tpu_torch.parallel.collectives import all_gather as _all_gather
from autodist_tpu_torch.parallel.collectives import \
    reduce_scatter as _reduce_scatter
from autodist_tpu_torch.remapper import Remapper
from autodist_tpu_torch.utils import cuda_graph, logging, step_text
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
        # Stale variables by period (s + 1); the step's phase is the step
        # count modulo their lcm.
        self._periods = {name: s.staleness + 1 for name, s in
                         program.synchronizers.items() if s.staleness > 0}
        self._period = math.lcm(*self._periods.values()) \
            if self._periods else 1
        self._shards = weakref.WeakKeyDictionary()  # optimizer -> zero1
        self._graphs = {}  # megastep graphs by block structure and phase
        self._captures = 0  # graph captures timed as compiles (telemetry)
        self._reported = False  # the first eager dispatch rendered a report
        self._execution = None  # what last ran the step: eager, CUDA graph
        # The axes whose groups share a rank's batch rows: seq (each rank
        # its chunk of the sequence) and the piece axes, model, expert or
        # pipe (each rank its pieces of the tp variables), alone or
        # together. The gradients of whole parameters and the loss average
        # over data x all of them; a piece's over data x those that do not
        # split it.
        self._stages = program.pipe_axis_size  # whole gradients sum over pipe
        self._seq_size = program.seq_axis_size
        # {name: ((axis, dim), ...)}: the piece axes that split each tp
        # variable.
        self._piece_dims = program.piece_dims()
        self._shared_axes = ((const.MESH_AXIS_SEQ,) if self._seq_size > 1
                             else ()) + program.piece_axes
        self._share_group = self._mesh.group_over(self._shared_axes) \
            if self._shared_axes else None
        self._grad_group = self._mesh.group_over(
            (const.MESH_AXIS_DATA,) + self._shared_axes)
        # A piece's gradient averages over data x the shared axes that do
        # not split it (sums over pipe where pipe does not split it). Every
        # rank makes the same groups in the same order (``new_group`` is
        # collective).
        self._piece_groups = {}
        for name in sorted(self._piece_dims):
            axes = self._reduce_axes(name)
            if axes not in self._piece_groups:
                self._piece_groups[axes] = self._mesh.group_over(axes)
        # The group an MoE layer's partial output sums over on {expert,
        # model} (made here, where every rank makes it).
        both = (const.MESH_AXIS_EXPERT, const.MESH_AXIS_MODEL)
        self._moe_group = self._mesh.group_over(both) if set(both) <= set(
            program.piece_axes) else None
        self._buckets = self.bucket_plan()
        # Telemetry handle resolved ONCE at construction: the step loop
        # gates on one attribute, so AUTODIST_TELEMETRY=0 means zero
        # telemetry calls on the hot path.
        self._obs = observability if observability.enabled() else None
        if self._obs is not None:
            # The live monitor: opt-in chief HTTP endpoint; with no
            # AUTODIST_MONITOR_PORT (or telemetry off) one int check, no
            # thread, no port.
            try:
                from autodist_tpu_torch.observability import monitor
                monitor.ensure_started()
            except Exception as e:  # noqa: BLE001 - must never kill a run
                logging.debug("monitor not started: %s", e)
        if self._obs is not None:
            pad_bytes = 0
            for name, (_dim, logical, padded) in program.paddings().items():
                v = self._item.var_by_name(name)
                if logical:
                    pad_bytes += int(v.size_bytes * (padded - logical)
                                     / logical)
            self._obs.registry().gauge("padding.bytes").set(pad_bytes)

    def _split_axes(self, name):
        """The piece axes that split variable ``name`` (none: whole)."""
        return tuple(a for a, _ in self._piece_dims.get(name, ()))

    def _reduce_axes(self, name):
        """The axes over which variable ``name``'s gradient is reduced:
        data x the shared axes (seq, the piece axes) that do not split it
        (a piece group holds the other pieces, not copies)."""
        split = self._split_axes(name)
        return (const.MESH_AXIS_DATA,) + tuple(
            a for a in self._shared_axes if a not in split)

    def _pipe_sum(self, name):
        """The factor that turns variable ``name``'s mean over its reduce
        group into the pipe group's sum: S under a pipe axis of S ranks
        that does not split it (every rank's backward was seeded 1 / S),
        else 1."""
        if self._stages > 1 and \
                const.MESH_AXIS_PIPELINE not in self._split_axes(name):
            return self._stages
        return 1

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
        """{var_name: (kind, dim)}: ``stale``, ``fsdp``, ``zero1``, ``tp``
        or ``ar`` (``DistributedProgram.var_kinds``)."""
        return self._kinds

    def bucket_plan(self):
        """The all-reduces of one step's ``ar`` and ``tp`` gradients (a
        ``tp`` gradient is its piece's), in order: lists of variable names.
        Fusable synchronizers of one fusion group, dtype, kind and reduce
        group share a bucket (one collective); the others reduce alone.
        ``zero1`` / ``fsdp`` / ``stale`` variables take no all-reduce."""
        buckets, keyed = [], {}
        for name, sync in self._program.synchronizers.items():
            kind = self._kinds[name][0]
            if kind not in ("ar", "tp"):
                continue
            if getattr(sync, "fusable", False):
                key = (sync.group, sync.var.dtype, kind,
                       self._reduce_axes(name))
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
        layout (padded; an ``fsdp`` or ``tp`` variable's piece only) and
        build the
        optimizer over the update tensors: the stored trainable leaves,
        except that a ``zero1`` variable's is this rank's shard of it (a
        tensor of its own, ``1/n`` of the variable, so its optimizer state
        is too). The captured tree is untouched."""
        resolve_device(self._remapper.device)
        params = self._remapper.place_params(self._item.params, copy=True)
        opt = self._optimizer_over(params)
        return TrainState(torch.zeros((), dtype=torch.int64), params, opt)

    def _optimizer_over(self, params):
        """The optimizer over ``params``' update tensors (their trainable
        leaves, marked as requiring gradients; a ``zero1`` variable's shard
        instead, a tensor of its own), its shards registered for the
        step."""
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
        if any(k in ("zero1", "fsdp", "tp") for k, _ in
               self._kinds.values()) and \
                not isinstance(opt, ELEMENTWISE_OPTIMIZERS):
            raise ValueError(
                f"autodist_tpu_torch: {type(opt).__name__} cannot update a "
                f"variable shard by shard: the PS / partitioned / tensor-"
                f"parallel lowering runs the optimizer on each rank's shard "
                f"or piece, which gives the whole update only for an "
                f"optimizer that treats each element on its own "
                f"({', '.join(c.__name__ for c in ELEMENTWISE_OPTIMIZERS)}). "
                f"Build the strategy with gspmd_update=True (PS family, "
                f"no model axis), or use AllReduce()")
        self._shards[opt] = shards
        return opt

    def logical_params(self, state):
        """The params at their logical shapes, detached: padding cut off,
        an ``fsdp`` variable's pieces all-gathered over the data group and
        a ``tp`` variable's over the model (expert) group (collectives:
        every rank calls them), a stale variable this rank's copy (the JAX
        Runner's stored array holds every device's copy)."""
        def logical(path, t):
            name = path_to_name(path)
            t = t.detach()
            if self._kind(name)[0] != "zero1":  # stored whole
                t = self._gather_piece(name, t)
            return self._cut_padding(name, t)
        return tree_map_with_path(logical, state.params)

    def _gather_piece(self, name, t):
        """``t``, shaped like variable ``name``'s update tensor, gathered
        whole: over the data group for ``zero1`` / ``fsdp``, over the group
        of each piece axis that splits it for ``tp``; as it is
        otherwise."""
        kind, dim = self._kind(name)
        if kind in ("zero1", "fsdp") and self._mesh.group() is not None:
            return _all_gather(t, dim, self._mesh.group())
        for axis, d in self._piece_dims.get(name, ()):
            t = _all_gather(t, d, self._mesh.group(axis))
        return t

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
        shards, ``fsdp`` and ``tp`` pieces: collectives every rank calls)
        and cut to the logical shape; the others (``step``) are kept as
        they are. Tensors are detached views or gathered copies on the
        device."""
        per_var = {}
        for name, t in self._update_tensors(state):
            out = {}
            for key, v in state.opt_state.state.get(t, {}).items():
                if not isinstance(v, torch.Tensor):
                    raise TypeError(
                        f"autodist_tpu_torch: optimizer state {name}/{key} "
                        f"is a {type(v).__name__}, not a tensor: only "
                        f"tensor state has a checkpoint form")
                v = v.detach()
                if v.dim() and v.shape == t.shape:
                    v = self._cut_padding(name, self._gather_piece(name, v))
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
        to this rank's ``fsdp`` or ``tp`` piece), a ``zero1`` variable's
        shard taken
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
        layout on this rank's device: padded, cut to the ``fsdp`` or ``tp``
        piece, and with ``shard`` a ``zero1`` variable's shard of the
        whole."""
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
        """The params the loss sees: ``fsdp`` pieces all-gathered over the
        data group (through :class:`_GatherShards`, so their gradients
        reduce-scatter); a ``tp`` piece as it is over each piece axis on
        which the parallel context says it reaches a Megatron layer, an MoE
        layer or a pipeline stage as its piece, and all-gathered over the
        group of any other axis that splits it, its gradient
        reduce-scattered and divided by the group's size; padding cut
        off."""
        group = self._mesh.group()
        ctx = self._program.parallel_context()

        def view(path, t):
            name = path_to_name(path)
            kind, dim = self._kind(name)
            if kind == "fsdp":
                t = _GatherShards.apply(t, dim, group)
            for axis, d in self._piece_dims.get(name, ()):
                if not ctx.arrives_as_piece(name, axis):
                    t = _GatherShards.apply(t, d, self._mesh.group(axis),
                                            self._mesh.shape[axis])
            t = self._cut_padding(name, t)
            if const.MESH_AXIS_PIPELINE in self._split_axes(name):
                ctx.mark_stage(t)  # this rank's stage (scan_blocks asks)
            return t
        return tree_map_with_path(view, params)

    def _sync_gradients(self, grads):
        """Reduce ``grads`` ({name: gradient of the stored leaf}) over the
        data group, by kind; a ``zero1`` gradient is replaced by this
        rank's shard of the mean. Under shared axes (seq, model, expert,
        pipe: the module docstring's rules) an ``ar`` bucket reduces over
        data x those axes, a ``tp`` piece's over data x the shared axes
        that do not split it, and the ``zero1`` / ``fsdp`` / ``stale``
        kinds first take their mean over the shared axes; under a pipe
        axis of S ranks the gradients that pipe does not split (seeded with
        1 / S) are summed over the pipe group instead: the bucket's mean
        times S, the other kinds' sum over the pipe group. Averaging a
        whole parameter's gradient over its model group keeps the ranks'
        copies bitwise equal: on the card each rank's gradient differs from
        the others' in the last bits (scatter-add atomics). A one-device
        local mesh (no process group) has nothing to reduce."""
        group = self._mesh.group()
        if group is None:
            return
        syncs = self._program.synchronizers
        for bucket in self._buckets:
            first = bucket[0]
            over = self._grad_group if self._kinds[first][0] == "ar" else \
                self._piece_groups[self._reduce_axes(first)]
            if len(bucket) > 1:
                reduce_bucket([grads[n] for n in bucket], over)
            else:
                syncs[first].sync_gradient(grads[first], over)
            if self._pipe_sum(first) > 1:
                # The mean over data x pipe (x the other shared axes),
                # times S: the pipe group's sum.
                for name in bucket:
                    grads[name].mul_(self._stages)
        n = self._program.data_axis_size
        for name, (kind, dim) in self._kinds.items():
            if kind not in ("ar", "tp") and self._share_group is not None:
                if self._stages > 1:  # pipe's sum, the others' mean
                    dist.all_reduce(grads[name], group=self._share_group)
                    rest = dist.get_world_size(self._share_group) // \
                        self._stages
                    if rest > 1:
                        grads[name].div_(rest)
                else:
                    all_reduce_mean_(grads[name], self._share_group)
            if kind == "zero1":
                grads[name] = _reduce_scatter(grads[name], dim, group).div_(n)
            elif kind == "fsdp":  # born reduce-scattered (the sum)
                grads[name].div_(n)

    def _check_shared_batch(self, batch):
        """Raise unless every rank that shares this rank's batch (its group
        over the seq and piece axes) holds this batch; nothing without
        such axes."""
        if self._share_group is not None:
            # Attention over mismatched sequences, or pieces of one layer
            # applied to two batches, would train on neither.
            self._check_group_batch(
                batch, self._share_group, self._shared_axes,
                "; ".join(self._SHARED_WHY[a] for a in self._shared_axes))

    def process_groups(self):
        """The process groups a step's collectives run over: each mesh
        axis's and the gradient groups (none on a local mesh)."""
        groups = [self._mesh.group(a) for a in self._mesh.axis_names]
        groups += [self._share_group, self._grad_group]
        groups += list(self._piece_groups.values()) + [self._moe_group]
        out = []
        for g in groups:
            if g is not None and all(g is not h for h in out):
                out.append(g)
        return out

    def _check_group_batch(self, batch, group, axes, why):
        """Raise unless every rank of ``group`` (this rank's group over the
        mesh axes ``axes``) holds this batch, shapes and bytes (two
        all-gathers over the group: the lengths, then the bytes). ``why``
        says what the ranks of such a group compute."""
        flat = [torch.as_tensor(l).detach() for l in leaves(batch)]
        device = flat[0].device if flat else self._remapper.device
        shapes = torch.tensor([d for t in flat for d in (t.dim(),) +
                               tuple(t.shape)], dtype=torch.int64)
        mine = torch.cat([shapes.to(device).view(torch.uint8)] + [
            t.contiguous().reshape(-1).view(torch.uint8) for t in flat])
        p = dist.get_world_size(group)
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
            name = " x ".join(axes)
            raise ValueError(
                f"autodist_tpu_torch: the ranks of a {name} group were fed "
                f"different batches; every rank of a {name} group takes the "
                f"same batch ({why})")

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
        # step_text.phase names the parts of the step in the recorded step
        # text (_step_text); a shared no-op otherwise.
        with step_text.phase("forward"), \
                parallel_context.use(self._program.parallel_context()):
            out = item.loss_fn(self._compute_view(params), batch)
        loss, aux = out if item.aux_output else (out, None)
        named = self._trainable_leaves(params)
        with step_text.phase("backward"):
            grads = torch.autograd.grad(loss, [t for _, t in named],
                                        self._backward_seed(loss),
                                        allow_unused=True)
            # Unused leaves get zeros (as jax.grad gives); the reduction
            # writes in place, so expanded (stride-0) gradients become real
            # tensors.
            grads = {n: (torch.zeros_like(t) if g is None else
                         g.contiguous()) for (n, t), g in zip(named, grads)}
        with step_text.phase("grad-sync"):
            self._sync_gradients(grads)
        shards = self._shards.get(opt, {})
        for n, t in named:
            shards.get(n, t).grad = grads[n]
        with step_text.phase("update"):
            opt.step()
            opt.zero_grad(set_to_none=True)
            self._finish_update(params, shards, step)
        with step_text.phase("metrics"):
            loss = loss.detach().float().clone()
            if self._grad_group is not None:
                all_reduce_mean_(loss, self._grad_group)
            metrics = {"loss": loss, "notfinite": torch.logical_not(
                torch.isfinite(loss))}
        if aux is not None:
            metrics["aux"] = tree_map(lambda t: t.detach() if isinstance(
                t, torch.Tensor) else t, aux)
        return metrics

    def _backward_seed(self, loss):
        """The loss's cotangent: None (1), or 1 / S under a pipe axis of S
        ranks, where every rank computes the loss whole and the group's
        sum of their gradients is the gradient."""
        if self._stages == 1:
            return None
        return torch.full_like(loss, 1.0 / self._stages)

    @staticmethod
    def _advance(state, k):
        """The host side of ``k`` steps: the step counter, and the stale
        mark on the consumed state."""
        state.step._autodist_stale = True
        return TrainState(state.step + k, state.params, state.opt_state)

    # What the ranks of a group over each shared axis compute.
    _SHARED_WHY = {
        const.MESH_AXIS_SEQ: "under sequence parallelism each computes its "
        "chunk of the sequence",
        const.MESH_AXIS_MODEL: "under tensor parallelism each computes its "
        "pieces of every layer",
        const.MESH_AXIS_EXPERT: "under expert parallelism each computes its "
        "experts' share of every token",
        const.MESH_AXIS_PIPELINE: "under pipeline parallelism stage 0 reads "
        "the inputs and every stage the loss"}

    def _step(self, state, batch):
        if not self._reported:  # the first eager dispatch: its "compile"
            self._reported = True
            self._auto_report("eager")
        self._check_shared_batch(batch)
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
        first call was given (the graph is bound to its tensors). Under a
        seq or piece axis the ranks that share a batch are checked to hold
        one at the first call only. On CUDA every process group of the
        step must be NCCL's (``RuntimeError`` otherwise)."""
        self._remapper.shard_batch(example_batch)
        if aot:
            step = _GraphStep(self, example_batch)
        else:
            step = self._step
        if not shard_inputs:
            return step
        shard = self._remapper.shard_batch
        return lambda state, batch: step(state, shard(batch))

    # -- the transform report ------------------------------------------------

    def _auto_report(self, execution):
        """The chief renders the transform report at each of the port's
        compiles, a Runner's first eager dispatch and each graph capture
        (``execution``: ``"eager"`` or ``"CUDA graph"``, the page's badge;
        capture -> strategy -> placements; the compiled-step section
        upgrades through :meth:`write_report`): the counterpart of
        ``autodist_tpu/runner.py:1084``. It never traces the step and never
        kills a run. With telemetry off (``AUTODIST_TELEMETRY=0``) it
        renders nothing, as the loop then makes no telemetry call and
        writes nothing; :meth:`write_report` still renders on request."""
        self._execution = execution
        if self._obs is None:
            return
        try:
            if observability.tracing.process_index() != 0:
                return
            from autodist_tpu_torch import report
            path = report.render_report(self._program, execution=execution)
            logging.info("transform report: %s", path)
        except Exception as e:  # noqa: BLE001 - reporting must never kill a run
            logging.warning("transform report failed: %s", e)

    def _step_text(self, batch, shard_inputs=True):
        """One whole training step as text, one op a line
        (:mod:`~autodist_tpu_torch.utils.step_text`): the counterpart of
        the JAX Runner's ``_aot_executable(batch).as_text()``. The step
        runs once on ``meta`` tensors shaped like this program's state at
        its stored layout (zero1 shards, fsdp / tp pieces, padding) and
        ``batch``, with a fresh optimizer over them (primed, so the text
        holds a steady step's update), at the last phase of the staleness
        period (where every stale average runs). Its collectives are
        recorded, not run, so a rank may call this alone. No state changes
        and no kernel launches (a kernel's call is one line)."""
        if shard_inputs:
            batch = self._remapper.shard_batch(batch)
        meta = torch.device("meta")
        pairs, treedef = flatten_with_path(self._item.params)
        stored = []
        for path, leaf in pairs:
            t = torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device=meta)
            placement = self._placements[path_to_name(path)]
            stored.append(self._remapper.place_params(
                t, placements=placement._replace(device=meta)))
        params = unflatten(treedef, stored)
        opt = self._optimizer_over(params)
        _prime_optimizer(opt, [t for g in opt.param_groups
                               for t in g["params"]])
        flat, batch_def = flatten(batch)
        flat = [torch.empty_like(torch.as_tensor(l), device=meta)
                if isinstance(l, (torch.Tensor, np.ndarray)) else l
                for l in flat]
        with step_text.record() as rec:
            for path, t in flatten_with_path(params)[0]:
                rec.name(t, "p." + path_to_name(path))
            for i, t in enumerate(flat):
                if isinstance(t, torch.Tensor):
                    rec.name(t, f"b.{i}")
            self._core(params, opt, unflatten(batch_def, flat),
                       self._period - 1)
        return rec.text()

    def write_report(self, batch, shard_inputs=True):
        """Render the full transform report, the compiled step's section
        included (its collective table and op text from
        :meth:`_step_text`); returns the page's path. Runs no collective:
        the chief may call it alone."""
        from autodist_tpu_torch import report
        text = self._step_text(batch, shard_inputs)
        path = report.render_report(self._program, step_text=text,
                                    execution=self._execution)
        logging.info("transform report (with the step text): %s", path)
        return path

    def dump_compiled(self, batch):
        """Write the transformed step's op text (:meth:`_step_text`) to
        ``DEFAULT_GRAPH_DUMP_DIR/3-transformed-step.txt`` (the JAX
        package's stage numbering: ``3-transformed-hlo.txt``); returns its
        path. A failure (e.g. a batch the program cannot take) re-raises
        under ``AUTODIST_DUMP_GRAPHS`` (the caller asked for graph
        artifacts, so a silent miss is a bug) and otherwise returns the
        failure message, never ``None``."""
        path = os.path.join(const.DEFAULT_GRAPH_DUMP_DIR,
                            "3-transformed-step.txt")
        try:
            text = self._step_text(batch)
            const.ensure_working_dirs()
            from autodist_tpu_torch.report import write_atomic
            write_atomic(path, text)
            return path
        except Exception as e:  # noqa: BLE001
            if const.ENV.AUTODIST_DUMP_GRAPHS.val:
                raise
            logging.warning("step text dump failed: %s", e)
            return f"step text dump failed: {type(e).__name__}: {e}"

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

    def _wire_loader(self, data_iter, unroll):
        """Compose a :class:`~autodist_tpu_torch.data.NativeDataLoader`
        with the depth-N :class:`~autodist_tpu_torch.data.DevicePrefetcher`
        (``AUTODIST_PREFETCH_DEPTH``) and, under ``unroll=K``, the
        :class:`~autodist_tpu_torch.data.BlockStacker`, so the next batch
        (K-block) is copied while the current step runs and the loader's
        pinned buffers cycle. Returns ``(iterator, yields_blocks)``: with
        ``yields_blocks`` it hands out placed K-blocks, one a megastep.
        Any other iterator is returned as it is."""
        from autodist_tpu_torch.data.loader import (BlockStacker,
                                                    DevicePrefetcher,
                                                    NativeDataLoader)
        if not isinstance(data_iter, NativeDataLoader):
            return data_iter, False
        depth = max(0, const.ENV.AUTODIST_PREFETCH_DEPTH.val)
        if unroll > 1:
            stacker = BlockStacker(data_iter, unroll, recycle_to=data_iter,
                                   device=data_iter.device)
            return DevicePrefetcher(
                stacker, self._remapper, depth=depth, loader=stacker,
                shard_fn=self._remapper.shard_block), True
        return DevicePrefetcher(data_iter, self._remapper, depth=depth,
                                loader=data_iter), False

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
        inject their faults here.

        A :class:`~autodist_tpu_torch.data.NativeDataLoader` passed as
        ``data_iter`` is fed through :meth:`_wire_loader`: its batches (or,
        under ``unroll=K``, its K-blocks, stacked in pinned buffers) are
        copied to the device one step ahead; any other iterator's batches
        are placed at each step (K-blocks stacked on the host first)."""
        if unroll is None:
            unroll = const.ENV.AUTODIST_UNROLL.val
        unroll = max(1, int(unroll))
        if num_steps % unroll:
            raise ValueError(
                f"autodist_tpu_torch: num_steps={num_steps} is not a "
                f"multiple of unroll={unroll}; megasteps dispatch whole "
                f"K-step blocks")
        data_iter, yields_blocks = self._wire_loader(data_iter, unroll)
        obs = self._obs
        if trace_dir is None and obs is not None and \
                observability.tracing._mode() == "profiler":
            # AUTODIST_TRACE=profiler: the device timeline without the
            # caller having to plumb a trace_dir.
            const.ensure_working_dirs()
            trace_dir = const.DEFAULT_TRACE_DIR
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
            # The per-layer profile reads the trace, which exists only once
            # the profiler stops: the loop's finalize leaves it to us.
            state, metrics = self._run_loop(state, data_iter, num_steps,
                                            step_guard, chaos, unroll,
                                            yields_blocks,
                                            profiled=bool(trace_dir))
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            rank = dist.get_rank() if dist.is_initialized() else 0
            path = os.path.join(trace_dir, f"trace-rank{rank}.json")
            prof.export_chrome_trace(path)
            logging.info("profiler trace: %s", path)
            if obs is not None:
                self._finalize_profile(unroll, trace=path, steps=num_steps)
        return state, metrics

    def _held_tensors(self, state, data_iter=None, step_guard=None):
        """The tensors the loop holds, for the memory ledger's samples off
        the card: the state's params and optimizer state (and the tensors
        the optimizer updates: zero1 shards), the graphs' static batch
        buffers, the prefetcher's in-flight batches and the guard's
        snapshot."""
        out = list(leaves(state.params))
        opt = state.opt_state
        for group in getattr(opt, "param_groups", ()):
            out += list(group["params"])
        for st in getattr(opt, "state", {}).values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        for graph in list(self._graphs.values()):
            out += list(getattr(graph, "_static", ()))
        for batch, _ in list(getattr(data_iter, "_inflight", ())):
            out += [t for t in leaves(batch) if isinstance(t, torch.Tensor)]
        snap = getattr(step_guard, "_snapshot", None)
        if snap is not None:
            out += [c for _, c in snap.tensors]
            out += [c for _, entries in snap.states if entries
                    for _, _, c in entries]
        return out

    def _oom_forensics(self, exc, unroll, context, held=None):
        """On a device OOM (``memory.is_oom``), write the post-mortem report
        and the ``oom`` flight event. Any other exception, and any failure
        inside the forensics themselves, is left alone; the caller
        re-raises either way."""
        try:
            from autodist_tpu_torch.observability import memory as memory_mod
            if not memory_mod.is_oom(exc):
                return
            memory_mod.oom_report(
                exc, predicted=memory_mod.predicted_for_runner(
                    self, unroll=unroll),
                context=context, knobs={"unroll": unroll}, held=held)
        except Exception as e:  # noqa: BLE001 - forensics degrade silently
            logging.debug("oom forensics failed: %s", e)

    def _run_loop(self, state, data_iter, num_steps, step_guard, chaos,
                  unroll, yields_blocks=False, profiled=False):
        """The step loop of every run: one ``step`` a batch, or one
        ``megastep`` a K-block (pulled whole from ``data_iter`` with
        ``yields_blocks``, else stacked from K batches). The JAX Runner's
        ``_run_observed``
        (``autodist_tpu/runner.py:1529-1852``) less its re-tuning: chaos
        injection before each
        dispatch, the flag read at the guard's cadence (K-block boundaries
        under ``unroll=K``), snapshot on a healthy check, rollback on a
        diverged one; and with telemetry on, per dispatch one clock mark
        (:class:`DispatchClock`) and a host data-wait read, flushed into
        the registry, the attribution ledger and the skew ring on the same
        cadence, and the ledgers and the per-layer profile finalized after
        the loop (cold path; ``profiled``: the caller finalizes the profile
        from its profiler's trace). With telemetry off every telemetry
        touch is skipped: no clock, registry or span call."""
        obs = self._obs
        reg = obs.registry() if obs is not None else None
        k = unroll
        cadence = flush_cadence(step_guard, k)
        ledger = mem_ledger = clock = None
        batch_examples = 0

        def held():
            return self._held_tensors(state, data_iter, step_guard)
        skew_mod = None
        if obs is not None:
            from autodist_tpu_torch.observability import attribution
            from autodist_tpu_torch.observability import memory as memory_mod
            # The skew ring: dispatch windows fold in on the flush cadence
            # (on CUDA at the final drain, anchored after its sync); off
            # (AUTODIST_SKEW_RING=0) it costs nothing.
            try:
                from autodist_tpu_torch.observability import skew
                if skew.ring_enabled():
                    skew_mod = skew
            except Exception as e:  # noqa: BLE001 - must not kill runs
                logging.debug("skew ring unavailable: %s", e)
            clock = DispatchClock(self._remapper.device,
                                  windows=skew_mod is not None)
            try:
                ledger = attribution.Ledger(unroll=k)
            except Exception as e:  # noqa: BLE001 - must not kill runs
                logging.debug("attribution ledger unavailable: %s", e)
            try:
                # The predicted breakdown is priced ONCE here (cold path);
                # samples ride the flush cadence and the loop's ends.
                mem_ledger = memory_mod.MemoryLedger(
                    predicted=memory_mod.predicted_for_runner(self,
                                                              unroll=k),
                    unroll=k,
                    resident_copies=2 if step_guard is not None else 1,
                    held=held)
                mem_ledger.sample("loop-start")
            except Exception as e:  # noqa: BLE001 - must not kill runs
                logging.debug("memory ledger unavailable: %s", e)

        def flush(final=False):
            done = clock.flush(reg, final)
            if skew_mod is not None:  # anchored by a final drain, if any
                skew_mod.observe_dispatches(clock.take_windows())
            if not done:
                return
            if ledger is not None:
                for dt, st, wait_s, compiled in done:
                    # A dispatch that captured its graph is the port's
                    # compile (goodput's compile class), not a step.
                    if not compiled:
                        ledger.observe(dt * 1e3, wait_s * 1e3, st)
            reg.histogram("step.data_wait_ms").observe_many(
                [wait_s * 1e3 for _, _, wait_s, _ in done])
            steps_done = sum(st for _, st, _, _ in done)
            reg.counter("host_transfer.batches").inc(len(done))
            if batch_examples:
                total = sum(dt for dt, _, _, _ in done)
                reg.counter("step.examples").inc(batch_examples * steps_done)
                if total > 0:
                    reg.gauge("step.examples_per_sec").set(
                        round(batch_examples * steps_done / total, 1))
            if mem_ledger is not None:
                mem_ledger.sample("flush")

        metrics = None
        span = (obs.span("step-loop", steps=num_steps, unroll=k)
                if obs is not None else observability.tracing.NULL_SPAN)
        with span:
            if obs is not None and k > 1:
                # Unroll badge: step.latency_ms is per-dispatch/K.
                reg.gauge("step.unroll").set(k)
            if step_guard is not None:
                step_guard.mark_good(0, state)
            if clock is not None:
                clock.start()
            i = 0
            while i < num_steps:
                if obs is not None:
                    t_fetch = clock.now()
                if k == 1 or yields_blocks:
                    batch = next(data_iter)
                else:
                    batch = self._next_block(data_iter, k)
                if obs is not None:
                    wait_s = clock.now() - t_fetch
                    if not batch_examples:
                        first = next(iter(leaves(batch)), None)
                        if getattr(first, "ndim", 0) > (1 if k > 1 else 0):
                            # Under unroll the leading dim is the block's.
                            batch_examples = int(
                                first.shape[1 if k > 1 else 0])
                if chaos is not None:
                    batch = chaos.maybe_poison_batch(i + 1, batch)
                captures = self._captures
                try:
                    if chaos is not None:
                        chaos.maybe_oom(i + 1)
                    if k == 1:
                        state, metrics = self.step(state, batch)
                    else:
                        state, metrics = self.megastep(state, batch)
                except Exception as e:
                    # Device OOM forensics: the post-mortem, then re-raise
                    # (the failure itself is never swallowed).
                    if obs is not None:
                        self._oom_forensics(e, k, f"step-loop step {i + 1}",
                                            held=held)
                    raise
                i += k
                at_boundary = i % cadence == 0
                if obs is not None:
                    clock.mark(k, wait_s, self._captures != captures)
                    if at_boundary or i >= num_steps:
                        flush(final=i >= num_steps)
                if step_guard is not None and (at_boundary
                                               or i >= num_steps):
                    if step_guard.diverged(metrics):
                        i, state = step_guard.rollback(i)
                        if obs is not None:
                            clock.start()  # don't bill rollback as steps
                    else:
                        step_guard.progressed()
                        step_guard.mark_good(i, state)
            if obs is not None:
                flush(final=True)
        if obs is not None:
            self._finalize_telemetry(reg, ledger, mem_ledger, k, profiled)
        return state, metrics

    def _finalize_telemetry(self, reg, ledger, mem_ledger, unroll,
                            profiled=False):
        """End-of-loop bookkeeping on the cold path, each part fail-open:
        the attribution ledger (model terms priced here, not in the loop),
        the pipeline bubble gauges, the goodput segment, the memory ledger,
        then the ranks' snapshots gathered on the chief and the trace
        flushed."""
        obs = self._obs
        from autodist_tpu_torch.observability import attribution
        from autodist_tpu_torch.observability import goodput as goodput_mod
        from autodist_tpu_torch.observability import memory as memory_mod
        from autodist_tpu_torch.pipeline import observe as pipe_observe
        from autodist_tpu_torch.tuner import calibration
        try:
            cal_path = calibration.path_for(self, unroll)
        except Exception as e:  # noqa: BLE001
            logging.debug("calibration path unavailable: %s", e)
            cal_path = None
        try:
            if ledger is not None and ledger.steps:
                ledger.terms = attribution.terms_for_runner(self,
                                                            unroll=unroll)
                attribution.finalize(ledger, reg, calibration_path=cal_path)
        except Exception as e:  # noqa: BLE001
            logging.debug("attribution not recorded: %s", e)
        if not profiled and ledger is not None and ledger.steps:
            # Without a profiler trace the profile is the model's; with
            # one, run() finalizes it once the trace exists.
            self._finalize_profile(unroll)
        try:
            pipe_observe.finalize(self, reg)
        except Exception as e:  # noqa: BLE001
            logging.debug("pipeline bubble not recorded: %s", e)
        try:
            goodput_mod.finalize(self, reg, unroll=unroll)
        except Exception as e:  # noqa: BLE001
            logging.debug("goodput not recorded: %s", e)
        try:
            if mem_ledger is not None:
                mem_ledger.sample("loop-end")
                memory_mod.finalize(mem_ledger, reg,
                                    calibration_path=cal_path)
        except Exception as e:  # noqa: BLE001
            logging.debug("memory ledger not recorded: %s", e)
        try:
            obs.sync_cluster()
            obs.flush_trace()
        except Exception as e:  # noqa: BLE001
            logging.warning("telemetry flush failed: %s", e)


    def _finalize_profile(self, unroll, trace=None, steps=None):
        """The per-layer profile (``observability/profile.py``): the
        ledger's device terms split per model scope, reconciled to the
        last attribution summary; measured from the ``torch.profiler``
        ``trace`` of ``steps`` steps when there is one. One cold-path
        pass; ``AUTODIST_PROFILE=0`` makes no profiling call."""
        try:
            from autodist_tpu_torch.observability import attribution
            from autodist_tpu_torch.observability import profile as profile_mod
            from autodist_tpu_torch.tuner import calibration
            if not profile_mod.enabled() or \
                    attribution.last_summary() is None:
                return None
            prof = profile_mod.profile_runner(self, unroll=unroll,
                                              trace=trace, steps=steps)
            return profile_mod.finalize(
                prof, attribution.last_summary(), self._obs.registry(),
                calibration_path=calibration.path_for(self, unroll))
        except Exception as e:  # noqa: BLE001
            logging.debug("per-layer profile not recorded: %s", e)
            return None


def flush_cadence(step_guard, unroll):
    """Steps between the observed loops' guard checks and telemetry
    flushes: the guard's ``check_every``, else
    ``AUTODIST_GUARD_CHECK_EVERY``, rounded up to a multiple of ``unroll``
    (the flag aggregates per dispatch, so checks land on K-block
    boundaries)."""
    cadence = (step_guard.check_every if step_guard is not None
               else max(1, const.ENV.AUTODIST_GUARD_CHECK_EVERY.val))
    return -(-cadence // unroll) * unroll


class DispatchClock:
    """Per-dispatch wall time for the observed step loops.

    On the CPU a dispatch runs to its end before it returns, and its wall
    time is the host clock's delta between consecutive dispatch ends (the
    JAX package's reading). On CUDA a dispatch (an eager step, a graph
    replay) returns once its work is queued, so the host delta would time
    the enqueue; instead :meth:`mark` records one ``torch.cuda.Event`` on
    the current stream after each dispatch (no sync), and a dispatch's
    wall time is the interval between the completions of the previous
    dispatch's event (or the loop's start event) and its own: the
    device's inter-completion time, idle gaps included. :meth:`drain`
    reads the dispatches whose events have completed without waiting, or
    with ``final`` after one synchronize. Marks are host-side and never
    run inside a graph capture (the loop marks after a dispatch returns).

    Two by-products for the telemetry above the registry:

    * the billed windows: the host span from each :meth:`start` to its
      last mark is recorded as a ``step-dispatches`` trace span when the
      window closes (the next :meth:`start`, or a final drain), so the
      goodput ledger bills a checkpoint save into step time only where it
      overlapped dispatches;
    * with ``windows=True``, every drained dispatch's ``(end, dur, steps,
      wait)`` on the host's ``perf_counter`` clock, for the skew ring
      (:meth:`take_windows`). On CUDA the events' chain is anchored to
      one host reading taken right after a synchronize (the final drain,
      or a restart after a rollback): each end is that reading less the
      event time to the last event. No dispatch adds a sync.
    """

    def __init__(self, device, windows=False):
        self.cuda = torch.device(device).type == "cuda"
        # (event or host end time, steps, wait_s, compiled)
        self._pending = []
        self._prev = None   # the last drained mark (event or host time)
        self._span = None   # host [start, last mark] of the open window
        self._windows = [] if windows else None
        self._unanchored = []   # CUDA: (event, dur_s, steps, wait_s)

    @staticmethod
    def now():
        return time.perf_counter()

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return self.now()

    def start(self):
        """Begin (or begin again, dropping the undrained marks)."""
        self._close_window()
        self._anchor()
        self._pending.clear()
        self._prev = self._stamp()
        self._span = [self.now(), None]

    def mark(self, steps, wait_s, compiled=False):
        """One dispatch of ``steps`` steps, after ``wait_s`` s of host data
        wait; ``compiled`` when it captured its graph."""
        self._pending.append((self._stamp(), steps, wait_s, compiled))
        if self._span is not None:
            self._span[1] = self.now()

    def _close_window(self):
        """Record the open window's host span (``step-dispatches``)."""
        span, self._span = self._span, None
        if span is None or span[1] is None:
            return
        from autodist_tpu_torch.observability import tracing
        tracing.record_complete("step-dispatches", tracing.perf_to_us(
            span[0]), (span[1] - span[0]) * 1e6)

    def _anchor(self):
        """CUDA: turn the drained, unanchored events into host windows."""
        if not self._unanchored:
            return
        last = self._unanchored[-1][0]
        last.synchronize()
        t_last = self.now()
        for ev, dur, steps, wait in self._unanchored:
            self._windows.append((t_last - ev.elapsed_time(last) / 1e3, dur,
                                  steps, wait))
        self._unanchored.clear()

    def drain(self, final=False):
        """``[(wall_s, steps, wait_s, compiled)]`` of the completed
        dispatches since the last drain, oldest first."""
        out = []
        if self.cuda:
            if final and self._pending:
                self._pending[-1][0].synchronize()
            while self._pending and self._pending[0][0].query():
                ev, *rest = self._pending.pop(0)
                out.append((self._prev.elapsed_time(ev) / 1e3, *rest))
                if self._windows is not None:
                    self._unanchored.append((ev, out[-1][0], rest[0],
                                             rest[1]))
                self._prev = ev
        else:
            for t, *rest in self._pending:
                out.append((t - self._prev, *rest))
                if self._windows is not None:
                    self._windows.append((t, out[-1][0], rest[0], rest[1]))
                self._prev = t
            self._pending.clear()
        if final:
            self._anchor()
            self._close_window()
        return out

    def take_windows(self):
        """The anchored ``(end_perf, dur_s, steps, wait_s)`` windows since
        the last call (``[]`` without ``windows=True``)."""
        if not self._windows:
            return []
        out = list(self._windows)
        self._windows.clear()
        return out

    def flush(self, reg, final=False):
        """:meth:`drain` into ``reg``'s ``step.latency_ms`` (per step) and
        ``step.count``; returns the drained dispatches for the caller's
        own accounting."""
        done = self.drain(final)
        if done:
            reg.histogram("step.latency_ms").observe_many(
                [dt * 1e3 / st for dt, st, _, _ in done])
            reg.counter("step.count").inc(sum(st for _, st, _, _ in done))
        return done


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


def require_nccl(groups, device):
    """Raise ``RuntimeError`` unless every process group of ``groups`` is
    NCCL's where the step runs on CUDA: a CUDA graph captures NCCL's
    collectives, while gloo's stage CUDA tensors through the host (no graph
    can hold them). Nothing to check on other devices."""
    if torch.device(device).type != "cuda":
        return
    for group in groups:
        backend = str(dist.get_backend(group)).lower()
        if "nccl" not in backend:
            raise RuntimeError(
                f"autodist_tpu_torch: a graph step (make_callable(aot=True), "
                f"megastep, run(unroll>1)) on CUDA needs NCCL: this step's "
                f"collectives run over a {backend} group, which a CUDA graph "
                f"cannot capture. Start the world with the nccl backend "
                f"(Cluster.start does on a CUDA device), or use the eager "
                f"step (step(), run(unroll=1))")


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
        self._device = runner.remapper.device
        require_nccl(runner.process_groups(), self._device)
        self._runner = runner
        self.k = k
        flat, self._treedef = flatten(example)
        self._specs = [_leaf_spec(l) for l in flat]
        self._static = [torch.empty(shape, dtype=dtype, device=self._device)
                        for shape, dtype in self._specs]
        self._params = self._opt = self._leaves = None
        self._checked = False  # the first call's batch checked
        self.graphs = {}  # phase -> Graph
        self._built = set()  # phases whose capture ran (telemetry)

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
            if cuda and t.device.type == "cpu" and not t.is_pinned():
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
            self._built = set()
            self._bind(state)
        if not self._checked:
            # Once, not per replay: the check's all-gathers and host read
            # cannot sit in a graph.
            self._runner._check_shared_batch(batch)
            self._checked = True
        self._copy_in(batch)
        phase = int(state.step) % self._runner._period
        graph = self._graph(phase)
        obs = self._runner._obs
        captured = phase not in self._built
        if obs is not None and captured:
            # The capture (its warm-up step included) is the counterpart
            # of the JAX step's compile: timed in a span around it, never
            # inside it.
            t0 = time.perf_counter()
            with obs.span("compile", path="graph", unroll=self.k or 1):
                out = graph()
            dt_ms = (time.perf_counter() - t0) * 1e3
            self._runner._captures += 1
            obs.registry().gauge("compile.ms").set(round(dt_ms, 3))
            obs.record_event("compile", f"graph step unroll={self.k or 1} "
                             f"captured in {dt_ms:.0f}ms")
        else:
            out = graph()
        if captured:
            self._built.add(phase)
            self._runner._auto_report("CUDA graph")
        metrics = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, out)
        return self._runner._advance(state, self.k or 1), metrics
