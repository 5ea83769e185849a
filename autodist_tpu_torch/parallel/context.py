"""Parallel context: how a strategy reaches inside a model.

Counterpart of ``autodist_tpu/parallel/context.py``. The Runner activates
a :class:`ParallelContext` (built from the strategy proto's GraphConfig by
``DistributedProgram.parallel_context``) around the user's loss, and the
framework's model-level ops consult it: the attention resolver
(``models/transformer.py``) picks the sequence-parallel attention, and
``ops.scan_blocks`` lowers a stacked block stack onto the pipeline
schedule (``pipeline/schedule.py``) when ``pipeline_microbatches`` is set
and the mesh has a ``pipe`` axis. With no context, or no such axis, the
same ops keep their single-device semantics, so models stay runnable as
plain PyTorch code.

A JAX program sees the global arrays and asks the mesh for its place; a
rank here holds its own shard, so the context also tells it its place on
the ``seq`` axis: ``seq_index``, ``seq_size`` and ``seq_group`` (the
process group of the ranks that share its batch rows), on the ``model``
axis: ``model_index``, ``model_size`` and ``model_group`` (the ranks that
share its batch and hold the other pieces of its weights), the same on the
``expert`` axis (``expert_*``) and the ``pipe`` axis (``pipe_*``: the
ranks that share its batch and hold the other stages), and on the ``data``
axis (``data_*``: the ranks that hold the batch's other rows).

Under tensor, expert or pipeline parallelism one rule decides which split
weights reach the model as their pieces: :meth:`
ParallelContext.arrives_as_piece`, which the Runner asks for each variable
and each axis that splits it (over the others it gathers it); a pipe piece
is a stage's layers, and :func:`stage_pieces` tells ``scan_blocks`` and
``pipeline_apply`` that a stacked tree arrived as this rank's stage. The
Megatron layers (``models/layers.py``) then see a piece as a weight
1/``model_size`` of its whole width, and :func:`megatron` gives them the
context to run the Megatron form with; ``parallel/moe.py`` sees
E/``expert_size`` experts and asks :func:`experts`.

Two piece axes compose where one variable is split over both (a composed
partitioner, ``"0:2:pipe,2:2:model"``): ``{pipe, model}``, where a stage's
stacked Megatron weights arrive as this rank's layers and heads, so the
Megatron forms run inside the stage on the model group; and ``{expert,
model}``, where an MoE layer's experts arrive as this rank's experts and
hidden columns, and :meth:`ParallelContext.group_over` gives the group the
layer's partial output sums over.

One more rule says which batch a layer that couples a batch's tokens (MoE
routing: capacity, slot order, aux loss) sees: :attr:`ParallelContext.
global_batch`.

One context carries a seq attention and a piece axis at once (a ``{seq,
model}`` or ``{pipe, seq}`` mesh): :meth:`ParallelContext.attn_fn` gives
the ring or Ulysses over this rank's seq group (the ranks that share its
place on every other axis), while :func:`megatron` and
:func:`stage_pieces` answer for the model and pipe axes as they do alone,
and :func:`chunk` cuts the same chunk.
"""
import contextlib
import contextvars
import weakref

from autodist_tpu_torch import const

_var = contextvars.ContextVar("autodist_tpu_torch_parallel_ctx",
                              default=None)


class ParallelContext:
    """What the strategy decided about intra-program parallelism.

    Attributes:
        mesh: the rank mesh the program runs on (``cluster.Mesh``).
        seq_attn: "" | "ring" | "ulysses", the sequence-parallel attention
            (GraphConfig.seq_attn).
        pipeline_microbatches: GPipe microbatch count M; > 0 lowers
            ``scan_blocks`` onto the pipeline schedule over a ``pipe`` axis
            of more than one rank (GraphConfig.pipeline_microbatches).
        pipeline_schedule: ``"shift"`` (pipelined, default),
            ``"sequential"`` (the bitwise unpipelined control arm),
            ``"shift-noskip"`` or ``"1f1b"`` (shift's tick order, the stage
            recomputed in the backward); read from
            ``AUTODIST_PIPELINE_SCHEDULE`` when not given, at construction,
            as the JAX context reads it.
        act_seq_dim: the activation dim that is the sequence ((batch, seq,
            hidden): 1).
        seq_index, seq_size, seq_group: this rank's place on the ``seq``
            axis, the axis's size and its process group (from the mesh).
        model_index, model_size, model_group: the same for the ``model``
            axis; ``expert_*`` for the ``expert`` axis, ``pipe_*`` for the
            ``pipe`` axis and ``data_*`` for the ``data`` axis.
        pieces: {axis: the variables that reach the model as their pieces
            over that axis}: over ``model`` the Megatron layers' weights
            (``sharding_rules.megatron_pieces``) and an MoE layer's
            columns, over ``expert`` its experts (``expert_pieces``), over
            ``pipe`` every variable split over it.
        explicit: the program takes the JAX Runner's explicit path
            (``DistributedProgram.use_explicit_path``), on which a data
            shard is the model's whole batch (:attr:`global_batch`).

    The JAX context's ``attn_hook_in_use`` flag, which its loss reads to
    learn that the model took the hook, is :func:`chunk` here: the rule
    that decides it, which the model and its loss both call.

    ``op_shardings`` (Queue A item 12) is not ported: setting it raises.
    """

    def __init__(self, mesh, seq_attn="", pipeline_microbatches=0,
                 act_seq_dim=1, op_shardings=None, pipeline_schedule=None,
                 pieces=None, explicit=False):
        if op_shardings:
            raise NotImplementedError(
                "op_shardings: Automap's activation constraints are not "
                "ported to autodist_tpu_torch yet (ROADMAP.md, Queue A item "
                "12)")
        self.mesh = mesh
        self.seq_attn = seq_attn
        self.pipeline_microbatches = pipeline_microbatches
        self.pipeline_schedule = (pipeline_schedule or
                                  const.ENV.AUTODIST_PIPELINE_SCHEDULE.val or
                                  "shift")
        self.act_seq_dim = act_seq_dim
        self.pieces = {a: frozenset(v) for a, v in (pieces or {}).items()}
        self._stage = {}  # id -> weakref of the tensors that are pipe pieces
        self.explicit = explicit
        self._attn_cache = {}
        self._logged = set()

    def _size(self, axis):
        return 1 if self.mesh is None else self.mesh.shape.get(axis, 1)

    def _index(self, axis):
        return 0 if self.mesh is None else self.mesh.axis_index(axis)

    def _group(self, axis):
        if self._size(axis) <= 1:
            return None
        return self.mesh.group(axis)

    seq_size = property(lambda self: self._size(const.MESH_AXIS_SEQ))
    seq_index = property(lambda self: self._index(const.MESH_AXIS_SEQ))
    seq_group = property(lambda self: self._group(const.MESH_AXIS_SEQ))
    model_size = property(lambda self: self._size(const.MESH_AXIS_MODEL))
    model_index = property(lambda self: self._index(const.MESH_AXIS_MODEL))
    model_group = property(lambda self: self._group(const.MESH_AXIS_MODEL))
    expert_size = property(lambda self: self._size(const.MESH_AXIS_EXPERT))
    expert_index = property(lambda self: self._index(
        const.MESH_AXIS_EXPERT))
    expert_group = property(lambda self: self._group(
        const.MESH_AXIS_EXPERT))
    pipe_size = property(lambda self: self._size(const.MESH_AXIS_PIPELINE))
    pipe_index = property(lambda self: self._index(
        const.MESH_AXIS_PIPELINE))
    pipe_group = property(lambda self: self._group(
        const.MESH_AXIS_PIPELINE))
    data_size = property(lambda self: self._size(const.MESH_AXIS_DATA))
    data_index = property(lambda self: self._index(const.MESH_AXIS_DATA))
    data_group = property(lambda self: self._group(const.MESH_AXIS_DATA))

    @property
    def global_batch(self):
        """Whether a layer that couples the tokens of a batch (MoE routing:
        its capacity, slot order and aux loss) sees the global batch, the
        data group's shards together, rather than this rank's shard. The
        JAX package's answer depends on its Runner's path: its GSPMD path
        computes on the global batch, its explicit path (``shard_map``
        manual over ``data``: PS, ZeRO, compressors, staleness) on each
        data shard. So: on the GSPMD path over a data axis of more than one
        rank."""
        return not self.explicit and self.data_size > 1

    def arrives_as_piece(self, name, axis):
        """Whether variable ``name``, split over ``axis`` (the model,
        expert or pipe axis of more than one rank), reaches the model as
        this rank's piece over it (a Megatron layer's weight, an MoE
        layer's experts or columns, a stage's layers) rather than gathered
        whole over the axis's group."""
        return self._size(axis) > 1 and name in self.pieces.get(axis, ())

    def group_over(self, axes):
        """The process group of the ranks that share this rank's place on
        every axis but ``axes`` (``cluster.Mesh.group_over``; one axis:
        its group)."""
        return self.mesh.group_over(axes)

    def mark_stage(self, tensor):
        """Record ``tensor`` as a pipe piece this rank's loss receives (the
        Runner calls it for each piece it passes through)."""
        self._stage[id(tensor)] = weakref.ref(tensor)

    def is_stage(self, tensor):
        ref = self._stage.get(id(tensor))
        return ref is not None and ref() is tensor

    def log_once(self, key):
        """True the first time ``key`` is asked on this context: one log
        line per program for a condition every step meets."""
        first = key not in self._logged
        self._logged.add(key)
        return first

    def attn_fn(self, causal):
        """The strategy's attention hook, or None for default attention.

        Causality comes from the model (its config knows), which is why
        the resolver takes an explicit flag instead of reading masks."""
        if not self.seq_attn or self.seq_size <= 1:
            return None  # no seq axis on this mesh: the default is right
        key = (self.seq_attn, bool(causal))
        fn = self._attn_cache.get(key)
        if fn is None:
            from autodist_tpu_torch.parallel.ring_attention import (
                make_ring_attn_fn, make_ulysses_attn_fn)
            make = {"ring": make_ring_attn_fn,
                    "ulysses": make_ulysses_attn_fn}.get(self.seq_attn)
            if make is None:
                raise ValueError(f"unknown seq_attn {self.seq_attn!r} "
                                 f"(expected 'ring' or 'ulysses')")
            fn = make(self.mesh, causal=causal)
            self._attn_cache[key] = fn
        return fn


def current():
    """The active ParallelContext, or None outside a Runner step."""
    return _var.get()


@contextlib.contextmanager
def use(ctx):
    token = _var.set(ctx)
    try:
        yield ctx
    finally:
        _var.reset(token)


def resolve_attn(causal=False):
    """Strategy-provided ``attn_fn(q, k, v, mask)`` or None (use default)."""
    ctx = current()
    return ctx.attn_fn(causal) if ctx is not None else None


def megatron(weight, dim, whole):
    """The active context when ``weight`` reached a Megatron layer as its
    piece (:meth:`ParallelContext.arrives_as_piece`): a model axis of more
    than one rank, and ``weight`` 1/``model_size`` of its ``whole`` width
    along ``dim``. None when it arrived whole; any other width raises."""
    ctx = current()
    width = weight.shape[dim]
    if ctx is None or ctx.model_size <= 1 or width == whole:
        return None
    if width * ctx.model_size != whole:
        raise ValueError(
            f"a weight of width {width} along dim {dim} is neither whole "
            f"({whole}) nor its piece over a model axis of "
            f"{ctx.model_size}")
    return ctx


def stage_pieces(leaves):
    """The active context when ``leaves`` (a stacked tree's, in
    ``scan_blocks`` or ``pipeline_apply``) reached the model as this rank's
    pieces over a ``pipe`` axis of more than one rank: its stage of the
    stacked layers. None when they arrived whole (no context, no pipe axis,
    or variables the strategy did not split over ``pipe``); a tree of some
    pieces and some whole leaves raises."""
    ctx = current()
    if ctx is None or ctx.pipe_size <= 1 or not leaves:
        return None
    marked = [ctx.is_stage(t) for t in leaves]
    if all(marked):
        return ctx
    if any(marked):
        raise ValueError(
            f"a stacked tree of {len(leaves)} leaves holds {sum(marked)} "
            f"pipe pieces and {len(leaves) - sum(marked)} whole leaves: "
            f"the Pipeline strategy's stage_pattern must match every leaf "
            f"of a pipelined stack, or none")
    return None


def experts(weight, whole):
    """The active context when ``weight``, an expert-stacked kernel of
    ``whole`` experts along dim 0, reached the MoE layer as this rank's
    piece (:meth:`ParallelContext.arrives_as_piece`): an expert axis of
    more than one rank and 1/``expert_size`` of the experts. None when it
    arrived whole; any other count raises."""
    ctx = current()
    n = weight.shape[0]
    if ctx is None or ctx.expert_size <= 1 or n == whole:
        return None
    if n * ctx.expert_size != whole:
        raise ValueError(
            f"an expert kernel of {n} experts is neither whole ({whole}) "
            f"nor its piece over an expert axis of {ctx.expert_size}")
    return ctx


def chunk(attn_fn, s):
    """(offset, length) of this rank's chunk of a length-``s`` sequence
    when a model given ``attn_fn`` encodes only that chunk: no explicit
    ``attn_fn`` and an active context with a seq attention over more than
    one rank (the one case in which :func:`resolve_attn` gives a hook).
    None otherwise. Raises unless the seq axis divides ``s``: the ring
    takes equal chunks, and the mean of the ranks' token means is the
    whole sequence's only then."""
    ctx = current()
    if attn_fn is not None or ctx is None or not ctx.seq_attn or \
            ctx.seq_size <= 1:
        return None
    p = ctx.seq_size
    if s % p:
        raise ValueError(
            f"sequence length {s} is not divisible by the seq axis's size "
            f"{p}: sequence parallelism splits it into equal chunks")
    return ctx.seq_index * (s // p), s // p
