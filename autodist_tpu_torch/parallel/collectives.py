"""Split parameters gathered at use, and the collectives under them.

A split parameter's pieces are all-gathered along their dim for the
forward, and the backward reduce-scatters the gradient, as the VJP of
JAX's tiled ``all_gather`` does (``autodist_tpu/runner.py:839-846``). Over
the data group (an ``fsdp`` variable) the ranks hold different batches, so
the reduce-scatter's sum is the data group's gradient sum. Over a model
group (a ``tp`` variable outside the Megatron layers) every rank holds the
same batch and computes the same whole gradient, so the sum is the model
size times it: :class:`GatherShards` divides it back (``div``).
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
