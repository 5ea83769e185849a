"""Sequence (context) parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``autodist_tpu/parallel/ring_attention.py``: attention over
a sequence split across the ranks of the ``seq`` process group, rank
``i`` holding positions ``[i * s, (i + 1) * s)``.

* :func:`ring_attention`: the K/V blocks travel around the ring, one hop
  to the next rank at a time. Each hop's compute is the flash forward
  kernel at the block's global offsets (``ops.block_attn_fwd``, f32 o and
  lse), and the hops merge by log-sum-exp (``combine_blocks``). The
  backward (a ``torch.autograd.Function``) sends K/V around once more,
  running the flash backward kernels against the saved global lse
  (``block_attn_bwd``), and dk/dv travel with their block, arriving home
  after the last hop: memory stays O(s) per rank in both passes. The
  forward sends the next hop's K/V while this hop computes.
* :func:`ulysses_attention`: an all-to-all trades the sequence split for
  a head split, the port's ``flash_attention`` runs over the whole
  sequence for ``heads / P`` heads, and a second all-to-all trades back.
  Fewer, larger messages; needs heads % P == 0. (The JAX function's
  ``inner_attn`` has no caller and is not ported.)

The JAX functions run inside ``shard_map`` over the ``seq`` axis
(``_wrap_sharded``); here a rank already holds its shard, so the hooks
take the seq axis's process group from the mesh, and the group gives its
size and the rank's place on the ring. A hop is an
``all_to_all_single`` whose splits are zero for every rank but the
neighbours, on every backend: gloo's P2P ``send`` / ``recv`` do not take
CUDA tensors, while its all-to-all stages them through the host, and on
NCCL the all-to-all is the same grouped send and receive a P2P exchange
would issue. One transport serves the CPU tests, the card and NCCL.
Offsets are host ints baked into each kernel call, so these run eagerly;
capturing the ring in a CUDA graph is ROADMAP item A15's.
"""
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.ops.flash_attention import (block_attn_bwd,
                                                    block_attn_fwd,
                                                    combine_blocks)
from autodist_tpu_torch.ops.flash_attention import \
    flash_attention as _flash_attn

_NEG_INF = -1e30


def _a2a_hop(send, recv, group, my_idx, p_size):
    """One tensor to the next rank, the previous rank's into ``recv``, as
    an all-to-all with zero splits to every other rank (bytes: the
    exchange moves data and computes nothing)."""
    nbytes = send.numel() * send.element_size()
    out_splits, in_splits = [0] * p_size, [0] * p_size
    in_splits[(my_idx + 1) % p_size] = nbytes
    out_splits[(my_idx - 1) % p_size] = nbytes
    return dist.all_to_all_single(
        recv.view(-1).view(torch.uint8), send.reshape(-1).view(torch.uint8),
        out_splits, in_splits, group=group, async_op=True)


def _start_hop(tensors, group, my_idx, p_size):
    """Start one hop of the ring for ``tensors``: each goes to the next
    rank, and the previous rank's arrives in a new buffer. Returns what
    :func:`_finish_hop` takes."""
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    works = [_a2a_hop(s, r, group, my_idx, p_size)
             for s, r in zip(sends, recvs)]
    return sends, recvs, works


def _finish_hop(pending):
    _, recvs, works = pending
    for w in works:
        w.wait()
    return recvs


def _hop(tensors, group, my_idx, p_size):
    return _finish_hop(_start_hop(tensors, group, my_idx, p_size))


def _ring_fwd_impl(q, k, v, my_idx, group, causal, p_size):
    """Forward ring: K/V rotate, finalized (o, lse) partials merge.
    Returns (o f32, lse f32 (b, h, sq, 1))."""
    sq, sk = q.shape[2], k.shape[2]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3] + (1,), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    kt, vt = k, v
    for t in range(p_size):
        # After t hops this rank holds the K/V block of rank my_idx - t;
        # global positions decide causal visibility.
        pending = (_start_hop((kt, vt), group, my_idx, p_size)
                   if t < p_size - 1 else None)
        src = (my_idx - t) % p_size
        ob, lb = block_attn_fwd(q, kt, vt, causal, my_idx * sq, src * sk)
        o, lse = combine_blocks(o, lse, ob, lb)
        if pending is not None:
            kt, vt = _finish_hop(pending)
    return o, lse


def _ring_bwd_impl(q, k, v, o, lse, my_idx, do, group, causal, p_size):
    """Backward ring: K/V make one more rotation, each hop running the
    block backward against the global lse; dk/dv accumulate with their
    block, and the last hop brings them home. delta comes from the f32 o
    (the JAX package takes it from o in q's dtype)."""
    sq, sk = q.shape[2], k.shape[2]
    do = do.to(q.dtype)
    delta = (do * o).sum(-1, keepdim=True)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kt, vt = k, v
    for t in range(p_size):
        src = (my_idx - t) % p_size
        dqb, dkb, dvb = block_attn_bwd(q, kt, vt, do, lse, delta, causal,
                                       my_idx * sq, src * sk)
        dq += dqb
        dk += dkb
        dv += dvb
        if p_size == 1:
            break
        if t < p_size - 1:
            kt, vt, dk, dv = _hop((kt, vt, dk, dv), group, my_idx, p_size)
        else:
            dk, dv = _hop((dk, dv), group, my_idx, p_size)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, p_size, my_idx):
        o, lse = _ring_fwd_impl(q, k, v, my_idx, group, causal, p_size)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring = (group, causal, p_size, my_idx)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, p_size, my_idx = ctx.ring
        dq, dk, dv = _ring_bwd_impl(q, k, v, o, lse, my_idx, do, group,
                                    causal, p_size)
        return dq, dk, dv, None, None, None, None


def _place(group):
    """(size, this rank's index) of ``group`` (None: the world)."""
    return dist.get_world_size(group), dist.get_rank(group)


def ring_attention(q, k, v, group=None, causal=False):
    """Ring attention over the ranks of ``group`` (default: the world).

    q/k/v: (batch, heads, seq_local, head_dim), this rank's chunk of the
    sequence (the group's rank ``i`` holds chunk ``i``; every chunk has one
    length). Returns (batch, heads, seq_local, head_dim) in q's dtype.
    Every rank of the group calls it together."""
    p_size, my_idx = _place(group)
    return _RingAttention.apply(q, k, v, group, bool(causal), p_size,
                                my_idx)


def _all_to_all(send, group):
    """all_to_all_single of ``send``'s dim-0 chunks (as bytes)."""
    recv = torch.empty_like(send)
    n = send.shape[0]
    dist.all_to_all_single(recv.view(n, -1).view(torch.uint8),
                           send.view(n, -1).view(torch.uint8), group=group)
    return recv


def _seq_to_heads(x, group, p_size):
    """(b, h, s_local, d) -> (b, h / P, s, d): head group j to rank j, the
    ranks' sequence chunks concatenated in rank order."""
    b, h, sl, d = x.shape
    send = x.reshape(b, p_size, h // p_size, sl, d).transpose(0, 1)
    recv = _all_to_all(send.contiguous(), group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // p_size, p_size * sl,
                                               d)


def _heads_to_seq(y, group, p_size):
    """The inverse of :func:`_seq_to_heads`."""
    b, hp, s, d = y.shape
    send = y.reshape(b, hp, p_size, s // p_size, d).permute(2, 0, 1, 3, 4)
    recv = _all_to_all(send.contiguous(), group)
    return recv.transpose(0, 1).reshape(b, p_size * hp, s // p_size, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, p_size):
        ctx.group, ctx.p_size = group, p_size
        return _seq_to_heads(x, group, p_size)

    @staticmethod
    def backward(ctx, dy):
        return _heads_to_seq(dy, ctx.group, ctx.p_size), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, p_size):
        ctx.group, ctx.p_size = group, p_size
        return _heads_to_seq(y, group, p_size)

    @staticmethod
    def backward(ctx, dx):
        return _seq_to_heads(dx, ctx.group, ctx.p_size), None, None


def ulysses_attention(q, k, v, group=None, causal=False):
    """Ulysses sequence parallelism over the ranks of ``group``: an
    all-to-all from a sequence split to a head split, the port's
    ``flash_attention`` over the whole sequence, and the all-to-all back.

    q/k/v: (batch, heads, seq_local, head_dim) with heads % P == 0."""
    p_size, _ = _place(group)
    if q.shape[1] % p_size != 0:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by "
                         f"seq-axis size ({p_size})")
    q, k, v = (_SeqToHeads.apply(t, group, p_size) for t in (q, k, v))
    return _HeadsToSeq.apply(_flash_attn(q, k, v, causal), group, p_size)


def _seq_group(mesh):
    """The process group of the mesh's seq axis."""
    if mesh is None or mesh.device_mesh is None:
        raise NotImplementedError(
            "sequence parallelism needs a rank mesh (one process per "
            "device, a torch.distributed world): a single process holds no "
            "shard of a sequence")
    return mesh.group(const.MESH_AXIS_SEQ)


def make_ring_attn_fn(mesh, causal=False):
    """An ``attn_fn(q, k, v, mask)`` hook (``models.layers.mha``) running
    ring attention over the mesh's seq axis. ``mask`` is ignored:
    causality is positional (``causal=``)."""
    group = _seq_group(mesh)
    return lambda q, k, v, mask=None: ring_attention(q, k, v, group, causal)


def make_ulysses_attn_fn(mesh, causal=False):
    """As :func:`make_ring_attn_fn`, with Ulysses attention."""
    group = _seq_group(mesh)
    return lambda q, k, v, mask=None: ulysses_attention(q, k, v, group,
                                                        causal)
