"""Pipeline schedules: GPipe microbatching over the ``pipe`` axis.

Counterpart of ``autodist_tpu/pipeline/schedule.py``. The JAX package runs
one SPMD ``lax.scan`` over the ticks of the schedule inside a
``shard_map`` over ``pipe``, with a ``ppermute`` hop a tick, and lets
autodiff turn it into the backward pipeline. Here each rank holds its own
stage and runs its own ticks, so the whole schedule is ONE
``torch.autograd.Function`` (:class:`_Pipeline`):

* **forward**: the ticks in order. At tick ``t`` stage ``r`` computes
  microbatch ``t - r`` (``shift``) or, one microbatch in flight,
  microbatch ``t // S`` at the ticks with ``t % S == r``
  (``sequential``); stage 0 takes the microbatch from ``x``, the others
  the activation the previous stage sent at the tick before. A hop
  carries a computed microbatch to the next stage; the last stage keeps
  its outputs and broadcasts them over the pipe group at the end, so
  every rank returns the whole ``(batch, ...)`` output (the JAX legacy
  commit: its last-stage buffer and ``psum``);
* **backward**: the same ticks in reverse. The output's cotangents are
  summed over the pipe group (the transpose of the broadcast, as the
  ``psum``'s is), stage ``r`` takes the vector-Jacobian product of its
  stage for the microbatch it ran at that tick (``torch.autograd.grad``
  on the graph the forward kept) and hops the input's cotangent to the
  previous stage. A stage accumulates its parameters' gradients in
  descending microbatch order under every schedule, so ``shift`` and
  ``sequential`` give the same bits.

Every rank of the group takes part in a tick's hop whenever any stage
sends at that tick (the hop is a collective); a tick at which no stage
sends issues none. In the JAX package every rank's copy of each hop runs
because one SPMD program runs them; in PyTorch each rank's autograd
engine runs only the nodes that reach its loss, which is why the
schedule is one ``Function`` and not a ``Function`` per hop.

Under a model axis too (``{pipe, model}``) a stage's layers are this
rank's Megatron pieces, and the stage's forward, its VJP and ``1f1b``'s
recompute run the model group's collectives. The ranks of a model group
sit at one stage and run the same ticks (and skip the same idle slots),
so they issue those collectives in one order; the hop and the output
carry the whole activation, which every rank of a model group holds.

The hop is ``parallel/collectives.exchange`` (an ``all_to_all_single``
with zero splits but to the neighbour: gloo takes no CUDA tensors in its
P2P calls), the commit a ``broadcast`` from the last stage, its transpose
an ``all_reduce``.

Schedules (:data:`SCHEDULES`): ``shift`` (pipelined), ``sequential`` (the
unpipelined control arm, bitwise equal to ``shift``), ``shift-noskip``
(shift with the idle slots computing on garbage input, the measurement
arm; same values) and ``1f1b`` (shift's ticks; the forward keeps only the
stage inputs and the backward recomputes the stage first, the JAX
``jax.checkpoint`` of the stage: the loss is bitwise ``shift``'s, since
both forwards run the stage with the gradient on, through the same
kernels).

Gradient rule: each rank's loss sees the whole output, and the summed
cotangents reach the last stage; the Runner seeds every rank's backward
with ``1 / S`` and sums the whole parameters' gradients over the pipe
group, so the group's sum is the one-device gradient (``runner.py``). A
caller outside the Runner seeds its backward the same way.

The executor runs ``M + S - 1`` ticks under ``shift`` (``M * S`` under
``sequential``) with the broadcast commit in every case; the JAX executor
runs its sharded ``done`` conveyor (``M + 2S - 3`` ticks, equal at
``S = 2``) when ``M % S == 0``. And it skips idle slots on every backend
and under a seq axis (a Python ``if``; the ranks of a seq group sit at one
stage and skip the same ticks); the JAX package skips neither on the CPU
nor under a seq axis (:func:`resolve_skip_idle`, whose values are kept):
the values are the same, the ticks that compute differ.
"""
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel import context as parallel_context
from autodist_tpu_torch.parallel.collectives import exchange
from autodist_tpu_torch.utils import cuda_graph
from autodist_tpu_torch.utils.scope import named_scope
from autodist_tpu_torch.utils.tree import flatten, unflatten

#: ``shift`` — the pipelined schedule; ``sequential`` — the bitwise
#: unpipelined control arm; ``shift-noskip`` — shift with the idle slots
#: computing on garbage input (the measurement arm); ``1f1b`` — shift with
#: the stage recomputed in the backward, so the forward holds only the
#: stage inputs.
SCHEDULES = ("shift", "sequential", "shift-noskip", "1f1b")


def resolve_skip_idle(backend=None, seq_manual=False):
    """The JAX package's resolved default for ``skip_idle=None``: off under
    a sequence-parallel composition and on the CPU, on elsewhere.
    ``backend`` None is this process's default device type ("cuda" when a
    card is present, else "cpu"). Kept for its values; the port's executor
    skips idle slots on every backend (a Python ``if``, which has no
    transpose to pay for)."""
    if seq_manual:
        return False
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    return str(backend).lower() != "cpu"


def stack_stage_params(stage_params_list):
    """[per-stage tree, ...] -> one tree with a leading stage dim."""
    flat = [flatten(t) for t in stage_params_list]
    treedef = flat[0][1]
    return unflatten(treedef, [torch.stack(parts)
                               for parts in zip(*(f[0] for f in flat))])


def bubble_fraction(p_size, num_microbatches, sharded_commit=None):
    """Idle-slot fraction of the shifting schedule: the GPipe
    ``(P-1)/(M+P-1)``, or with ``sharded_commit=True`` the JAX executor's
    conveyor ``(2P-3)/(M+2P-3)`` (equal at P = 2)."""
    if sharded_commit:
        ticks = num_schedule_steps(p_size, num_microbatches, True)
        return (ticks - num_microbatches) / ticks
    return (p_size - 1) / (num_microbatches + p_size - 1)


def num_schedule_steps(p_size, num_microbatches, sharded_commit,
                       schedule="shift"):
    """The JAX executor's scan trip count of a schedule."""
    if schedule == "sequential":
        return num_microbatches * p_size
    if sharded_commit:
        return num_microbatches + 2 * p_size - 3
    return num_microbatches + p_size - 1


def executor_ticks(p_size, num_microbatches, schedule="shift"):
    """Ticks the port's executor runs: ``num_schedule_steps`` without the
    sharded commit (the port always broadcasts)."""
    return num_schedule_steps(p_size, num_microbatches, False,
                              "sequential" if schedule == "sequential"
                              else "shift")


def _work(schedule, t, stage, p_size, num_micro):
    """The microbatch stage ``stage`` computes at tick ``t``, or None."""
    if schedule == "sequential":
        return t // p_size if t % p_size == stage else None
    m = t - stage
    return m if 0 <= m < num_micro else None


class _Run:
    """One call's schedule on this rank: its forward and its backward,
    with what the forward keeps for the backward."""

    def __init__(self, stage_fn, treedef, num_micro, group, stage, p_size,
                 schedule, skip_idle, counts):
        self.stage_fn = stage_fn
        self.treedef = treedef
        self.m = num_micro
        self.group = group
        self.stage = stage
        self.p = p_size
        self.schedule = schedule
        self.skip_idle = skip_idle
        self.keep = schedule != "1f1b"
        self.ticks = executor_ticks(p_size, num_micro, schedule)
        self.counts = counts
        # The backward runs outside the loss's parallel context (and on
        # the autograd engine's thread): 1f1b's recompute of a stage whose
        # Megatron layers ask for it takes it from here.
        self.ctx = parallel_context.current()

    def _apply(self, leaves, inp):
        """The stage on ``inp``: the leaves' leading (stage) dim taken,
        under the ``stage`` scope (the JAX schedule's)."""
        with named_scope("stage"):
            params = unflatten(self.treedef, [l[0] for l in leaves])
            y = self.stage_fn(params, inp)
        if y.shape != inp.shape or y.dtype != inp.dtype:
            raise ValueError(
                f"pipeline stage maps {tuple(inp.shape)} {inp.dtype} to "
                f"{tuple(y.shape)} {y.dtype}: every stage must keep the "
                f"activation's shape and dtype")
        return y

    def _hop(self, t, send, like, backward):
        """The tick's hop (forward: to the next stage; backward: to the
        previous): returns what this stage received, or None."""
        step = -1 if backward else 1
        senders = [r for r in range(self.p)
                   if 0 <= r + step < self.p and
                   _work(self.schedule, t, r, self.p, self.m) is not None]
        if not senders:
            return None
        me = self.stage
        dst = me + step if me in senders else None
        src = me - step if me - step in senders else None
        recv = torch.empty(like.shape, dtype=like.dtype,
                           device=like.device) if src is not None else None
        exchange(send.contiguous() if dst is not None else like, recv,
                 self.group, dst=dst, src=src)
        cuda_graph.count_item(self.counts, "hops")
        return recv

    def forward(self, x, leaves, needs_dx):
        p, m_count, me = self.p, self.m, self.stage
        self.needs_dx = needs_dx or me > 0
        x_micro = x.reshape((m_count, -1) + tuple(x.shape[1:]))
        self.leaves = [l.detach().requires_grad_(l.requires_grad)
                       for l in leaves]
        self.saved = {}
        outs = torch.empty_like(x_micro)
        recv = None
        for t in range(self.ticks):
            m = _work(self.schedule, t, me, p, m_count)
            send = None
            if m is not None:
                inp = (x_micro[m] if me == 0 else recv).detach()
                # Under 1f1b too the stage runs with the gradient on (the
                # same kernels as its recompute and as shift: the flash
                # forward has an inference variant), and only its graph is
                # dropped.
                with torch.enable_grad():
                    inp.requires_grad_(self.needs_dx)
                    y = self._apply(self.leaves, inp)
                self.saved[m] = (inp, y) if self.keep else inp.detach()
                y = y.detach()
                if me == p - 1:
                    with named_scope("shift"):
                        outs[m].copy_(y)
                send = y
            elif not self.skip_idle:
                # The idle slot computes on garbage; its output goes
                # nowhere.
                with torch.no_grad():
                    self._apply(self.leaves, torch.zeros_like(x_micro[0]))
            with named_scope("shift"):
                recv = self._hop(t, send, x_micro[0], backward=False)
        cuda_graph.count_item(self.counts, "forward_ticks", self.ticks)
        if p > 1:
            dist.broadcast(outs, src=dist.get_global_rank(self.group, p - 1),
                           group=self.group)
        return outs.reshape(x.shape)

    def backward(self, dout):
        p, m_count, me = self.p, self.m, self.stage
        d_micro = dout.reshape((m_count, -1) + tuple(dout.shape[1:]))
        if p > 1:  # the broadcast's transpose: the cotangents' sum
            d_micro = d_micro.contiguous()
            dist.all_reduce(d_micro, group=self.group)
        trainable = [l for l in self.leaves if l.requires_grad]
        grads = [None] * len(trainable)
        dx = torch.zeros_like(d_micro) if me == 0 and self.needs_dx else None
        recv = None
        for t in reversed(range(self.ticks)):
            m = _work(self.schedule, t, me, p, m_count)
            send = None
            if m is not None:
                dy = d_micro[m] if me == p - 1 else recv
                if self.keep:
                    inp, y = self.saved.pop(m)
                else:
                    inp = self.saved.pop(m)
                    with torch.enable_grad(), parallel_context.use(self.ctx):
                        inp.requires_grad_(self.needs_dx)
                        y = self._apply(self.leaves, inp)
                inputs = ([inp] if self.needs_dx else []) + trainable
                got = torch.autograd.grad(y, inputs, dy, allow_unused=True)
                if self.needs_dx:
                    if me == 0:
                        dx[m] = got[0]
                    else:
                        send = got[0]
                    got = got[1:]
                for i, g in enumerate(got):
                    if g is None:
                        continue
                    grads[i] = g if grads[i] is None else grads[i] + g
            recv = self._hop(t, send, d_micro[0], backward=True)
        cuda_graph.count_item(self.counts, "backward_ticks", self.ticks)
        self.saved = None
        out = iter(g if g is not None else torch.zeros_like(l)
                   for g, l in zip(grads, trainable))
        dleaves = [next(out) if l.requires_grad else None
                   for l in self.leaves]
        self.leaves = None
        return (dx.reshape(dout.shape) if dx is not None else None), dleaves


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        return run.forward(x, leaves, ctx.needs_input_grad[1])

    @staticmethod
    def backward(ctx, dout):
        dx, dleaves = ctx.run.backward(dout)
        ctx.run = None
        return (None, dx, *dleaves)


#: Calls and ticks of the executor in this process (reset by the caller):
#: ``forward_ticks`` / ``backward_ticks`` summed over the calls, ``hops``
#: the exchanges this rank took part in. Under a CUDA graph of the step
#: they count per replay (``utils/cuda_graph.count_item``), as a kernel
#: wrapper's launches do, not at the capture.
counts = {"forward_ticks": 0, "backward_ticks": 0, "hops": 0}


def _schedule_args(schedule, skip_idle):
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    if schedule == "shift-noskip":
        return "shift", False if skip_idle is None else skip_idle
    return schedule, True if skip_idle is None else skip_idle


def run_stage(local_params, stage_fn, x, num_microbatches, mesh,
              axis_name=const.MESH_AXIS_PIPELINE, skip_idle=None,
              schedule="shift"):
    """The schedule over this rank's stage: ``local_params`` leaves with a
    leading dim of 1 (this rank's stage), ``x`` this rank's batch; the
    common core of :func:`pipeline_apply` and ``ops.scan_blocks``."""
    schedule, skip_idle = _schedule_args(schedule, skip_idle)
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(f"batch {b} not divisible by microbatches "
                         f"{num_microbatches}")
    p_size = mesh.shape.get(axis_name, 1)
    group = mesh.group(axis_name) if p_size > 1 else None
    if p_size > 1 and group is None:
        raise NotImplementedError(
            f"pipeline_apply over a '{axis_name}' axis of {p_size} needs a "
            f"rank mesh (one process per device, a torch.distributed "
            f"world): a single process holds one stage")
    leaves, treedef = flatten(local_params)
    run = _Run(stage_fn, treedef, num_microbatches, group,
               mesh.axis_index(axis_name), p_size, schedule, skip_idle,
               counts)
    with named_scope("pipeline"):
        return _Pipeline.apply(run, x, *leaves)


def pipeline_apply(stage_params, stage_fn, x, num_microbatches, mesh=None,
                   axis_name=const.MESH_AXIS_PIPELINE, seq_axis=None,
                   seq_dim=None, skip_idle=None, schedule="shift"):
    """Apply a stack of pipelined stages to a batch.

    Args:
        stage_params: tree whose leaves have a leading stage dim: whole
            (= the ``axis_name`` axis's size; this rank takes its own
            stage), or this rank's piece of one stage (the Runner's view of
            a variable the strategy split over ``pipe``,
            ``parallel.context.stage_pieces``).
        stage_fn: ``(params_one_stage, activation) -> activation``, keeping
            the activation's shape and dtype.
        x: (batch, ...) this rank's input activations (its data shard).
        num_microbatches: microbatch count M (batch % M == 0).
        mesh: the rank mesh (must contain ``axis_name``); None: the active
            parallel context's.
        seq_axis/seq_dim: sequence parallelism inside the stages: when
            ``seq_axis`` names a mesh axis of more than one rank, ``x`` is
            this rank's chunk of the sequence along activation dim
            ``seq_dim`` (the rank's place on that axis), every stage's
            activation and the output stay that chunk, and ``stage_fn``
            runs the seq group's collectives itself (the ring's hops). A
            hop goes to the next stage's rank of the same seq index (the
            pipe group holds the ranks that share this rank's place on
            every other axis), and the ranks of a seq group run the same
            stage at the same tick, so their collectives pair up. The JAX
            function takes the global activation and splits it itself.
        skip_idle: False computes the idle slots on garbage input (same
            values); None skips them.
        schedule: one of :data:`SCHEDULES`.
    Returns: (batch, ...) outputs of the final stage, on every rank.
    """
    if mesh is None:
        ctx = parallel_context.current()
        mesh = ctx.mesh if ctx is not None else None
        if mesh is None:
            raise ValueError("pipeline_apply needs a mesh: pass mesh=, or "
                             "call it inside a Runner step")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh {dict(mesh.shape)} has no '{axis_name}' "
                         f"axis; pipeline_apply needs it (add it to "
                         f"mesh_axes)")
    if seq_axis is not None and mesh.shape.get(seq_axis, 1) > 1 and (
            seq_dim is None or not 0 < seq_dim < x.dim()):
        raise ValueError(
            f"pipeline_apply over the '{seq_axis}' axis needs seq_dim, the "
            f"activation's sequence dim (1 <= seq_dim < {x.dim()}), got "
            f"{seq_dim!r}")
    p_size = mesh.shape[axis_name]
    leaves, treedef = flatten(stage_params)
    piece = parallel_context.stage_pieces(leaves) is not None
    want = 1 if piece else p_size
    for i, leaf in enumerate(leaves):
        lead = leaf.shape[0] if leaf.dim() else None
        if lead != want:
            have = lead * p_size if piece and lead else lead
            raise ValueError(
                f"stage_params leaf {i} has leading dim {have}, but the "
                f"'{axis_name}' mesh axis has size {p_size}; each device "
                f"runs exactly one stage, so the stage count must equal the "
                f"pipe-axis size")
    if not piece and p_size > 1:
        idx = mesh.axis_index(axis_name)
        leaves = [l.narrow(0, idx, 1) for l in leaves]
    return run_stage(unflatten(treedef, leaves), stage_fn, x,
                     num_microbatches, mesh, axis_name, skip_idle, schedule)

