"""Split parameters gathered at use, the collectives under them, and the
neighbour exchange that the ring's hops and the pipeline's stage hops share.

A split parameter's pieces are all-gathered along their dim for the
forward, and the backward reduce-scatters the gradient, as the VJP of
JAX's tiled ``all_gather`` does (``autodist_tpu/runner.py:839-846``). Over
the data group (an ``fsdp`` variable) the ranks hold different batches, so
the reduce-scatter's sum is the data group's gradient sum. Over a model
group (a ``tp`` variable outside the Megatron layers) every rank holds the
same batch and computes the same whole gradient, so the sum is the model
size times it: :class:`GatherShards` divides it back (``div``).

:func:`exchange` moves one tensor to one rank of a group and receives one
from another as an ``all_to_all_single`` whose splits are zero for every
other rank, on every backend: gloo's P2P ``send`` / ``recv`` do not take
CUDA tensors, while its all-to-all stages them through the host, and on
NCCL the all-to-all is the same grouped send and receive a P2P exchange
would issue. One transport serves the CPU tests, the card and NCCL.
"""
import torch
import torch.distributed as dist


class GatherShards(torch.autograd.Function):
    """``piece``'s group pieces all-gathered along ``dim`` over ``group``;
    the backward reduce-scatters the gradient (the sum over the group lands
    on this rank's piece), divided by ``div``."""

    @staticmethod
    def forward(ctx, piece, dim, group, div=1):
        ctx.dim, ctx.group, ctx.div = dim, group, div
        return all_gather(piece, dim, group)

    @staticmethod
    def backward(ctx, grad):
        out = reduce_scatter(grad, ctx.dim, ctx.group)
        if ctx.div != 1:
            out.div_(ctx.div)
        return out, None, None, None


def all_gather(piece, dim, group):
    """The group's pieces concatenated along ``dim`` (rank order), as a new
    tensor (``all_gather_into_tensor`` gathers along dim 0: a piece split
    along another dim is moved to the front, and the result moved back)."""
    moved = piece.detach().movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = moved.new_empty((moved.shape[0] * n,) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def reduce_scatter(whole, dim, group):
    """This rank's piece along ``dim`` of the sum of ``whole`` over the
    group (``reduce_scatter_tensor`` along dim 0, moved as in
    :func:`all_gather`)."""
    moved = whole.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def exchange(send, recv, group, dst=None, src=None, async_op=False):
    """``send``'s bytes to group rank ``dst`` and group rank ``src``'s into
    ``recv`` (``dst`` / ``src`` None: nothing that way; ``send`` then only
    names the device), as one ``all_to_all_single``
    over ``group`` (None: the world) with zero splits to every other rank.
    Every rank of the group calls it together; a rank that sends or
    receives nothing still takes part. Returns the work (``async_op``) or
    None."""
    p = dist.get_world_size(group)
    in_splits, out_splits = [0] * p, [0] * p
    empty = torch.empty(0, dtype=torch.uint8, device=send.device)
    inp = out = empty
    if dst is not None:
        inp = send.reshape(-1).view(torch.uint8)
        in_splits[dst] = inp.numel()
    if src is not None:
        out = recv.view(-1).view(torch.uint8)
        out_splits[src] = out.numel()
    return dist.all_to_all_single(out, inp, out_splits, in_splits,
                                  group=group, async_op=async_op)
