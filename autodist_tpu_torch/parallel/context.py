"""Parallel context: how a strategy reaches inside a model.

Counterpart of ``autodist_tpu/parallel/context.py``. The Runner activates
a :class:`ParallelContext` (built from the strategy proto's GraphConfig by
``DistributedProgram.parallel_context``) around the user's loss, and the
framework's model-level ops consult it: the attention resolver
(``models/transformer.py``) picks the sequence-parallel attention. With no
context, or no ``seq`` axis, the same ops keep their single-device
semantics, so models stay runnable as plain PyTorch code.

A JAX program sees the global arrays and asks the mesh for its place; a
rank here holds its own shard, so the context also tells it its place on
the ``seq`` axis: ``seq_index``, ``seq_size`` and ``seq_group`` (the
process group of the ranks that share its batch rows).
"""
import contextlib
import contextvars

from autodist_tpu_torch import const

_var = contextvars.ContextVar("autodist_tpu_torch_parallel_ctx",
                              default=None)


class ParallelContext:
    """What the strategy decided about intra-program parallelism.

    Attributes:
        mesh: the rank mesh the program runs on (``cluster.Mesh``).
        seq_attn: "" | "ring" | "ulysses", the sequence-parallel attention
            (GraphConfig.seq_attn).
        seq_index, seq_size, seq_group: this rank's place on the ``seq``
            axis, the axis's size and its process group (from the mesh).

    The JAX context's ``attn_hook_in_use`` flag, which its loss reads to
    learn that the model took the hook, is :func:`chunk` here: the rule
    that decides it, which the model and its loss both call.

    ``pipeline_microbatches`` (Queue A item 10(e)) and ``op_shardings``
    (item 12) are not ported: setting either raises.
    """

    def __init__(self, mesh, seq_attn="", pipeline_microbatches=0,
                 op_shardings=None):
        if pipeline_microbatches:
            raise NotImplementedError(
                "pipeline_microbatches: the pipeline lowering is not ported "
                "to autodist_tpu_torch yet (ROADMAP.md, Queue A item 10(e))")
        if op_shardings:
            raise NotImplementedError(
                "op_shardings: Automap's activation constraints are not "
                "ported to autodist_tpu_torch yet (ROADMAP.md, Queue A item "
                "12)")
        self.mesh = mesh
        self.seq_attn = seq_attn
        self._attn_cache = {}

    @property
    def seq_size(self):
        return 1 if self.mesh is None else \
            self.mesh.shape.get(const.MESH_AXIS_SEQ, 1)

    @property
    def seq_index(self):
        return 0 if self.mesh is None else \
            self.mesh.axis_index(const.MESH_AXIS_SEQ)

    @property
    def seq_group(self):
        if self.mesh is None or self.seq_size <= 1:
            return None
        return self.mesh.group(const.MESH_AXIS_SEQ)

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
