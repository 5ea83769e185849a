"""Mixture-of-experts with expert parallelism.

Counterpart of ``autodist_tpu/parallel/moe.py``, with the same param tree
(``gate/kernel`` (d, E), ``up/kernel`` (E, d, h), ``down/kernel`` (E, h, d)),
the same rule table and the same numerics: the gate's logits and softmax in
f32, top-k routing renormalised (ties to the lower expert, as
``lax.top_k``), the Switch load-balancing aux loss taken before any drop,
GShard's capacity ``C = min(T, max(1, ceil(T k / E cf)))`` with the
k-major slot order (every token's first choice claims a slot before any
token's second), dropped assignments written to a trash cell, the tanh
GELU, and the combine in f32 cast back to ``x``'s dtype.

The JAX package leaves expert parallelism to GSPMD. Here a rank of an
``expert`` group (``ModelParallel(..., rules=EXPERT_RULES,
mesh_axis="expert")``) receives its E/ep experts' ``up`` / ``down`` pieces
(``sharding_rules.expert_pieces``) and :func:`apply` runs the explicit
form: the rank fills and computes only its rows of the (E, C, d) buffer,
combines its experts' weighted outputs into a partial (T, d) sum in f32,
and all-reduces that over the expert group. ``x`` and the renormalised
gate values enter the expert path through a copy-to-expert (identity
forward; the gradient summed over the group: each rank's backward reaches
only its experts' assignments). The routing and the aux loss stay outside
that copy: every rank of the group computes them whole.

Over a ``model`` axis too (each expert's FFN split Megatron-wise by a
composed partitioner: ``up`` ``"0:2:expert,2:2:model"``, ``down``
``"0:2:expert,1:2:model"``) a rank computes the h/tp hidden columns of its
E/ep experts (``up`` (E/ep, d, h/tp), the GELU, ``down`` (E/ep, h/tp,
d)), and the copy and the sum run over the expert x model group.

Which batch the routing sees is the JAX Runner's path's choice, asked in
one place (``ParallelContext.global_batch``): on its GSPMD path (an
AllReduce base) ``apply`` sees the global batch, so the capacity counts
the global tokens, each rank's slots follow the data shards before it
(an all-gather of the (k, E) routing counts over the data group) and the
aux loss takes its means over the data group; on its explicit path (PS,
ZeRO, compressors) each data shard is a batch of its own.
"""
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from autodist_tpu_torch import const
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.parallel import context
from autodist_tpu_torch.parallel.collectives import all_gather
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import tree_map

# Sharding rule for ModelParallel-style overlays: expert dim on `expert` axis.
EXPERT_RULES = (
    (r"moe/(up|down)/kernel$", 0),
    (r"moe/gate/kernel$", 1),
)


class MoEConfig:
    def __init__(self, num_experts=8, top_k=2, d_model=64, d_hidden=256,
                 dtype=torch.float32, capacity_factor=1.25):
        self.num_experts = num_experts
        self.top_k = top_k
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.dtype = dtype
        # Per-expert buffer size C = ceil(T * top_k / E * capacity_factor).
        # >= E/top_k guarantees C = T (no token ever dropped).
        self.capacity_factor = capacity_factor


def init(generator, cfg, device="cuda"):
    """Float32 params drawn on the CPU from ``generator`` (default: seed 0)
    with the JAX initializers' distributions, then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    e, d, h = cfg.num_experts, cfg.d_model, cfg.d_hidden
    params = {
        "gate": {"kernel": L.glorot(generator, (d, e))},
        "up": {"kernel": L.glorot(generator, (e, d, h), in_axis=-2,
                                  out_axis=-1)},
        "down": {"kernel": L.glorot(generator, (e, h, d), in_axis=-2,
                                    out_axis=-1)},
    }
    return tree_map(lambda t: t.to(device), params)


class _MeanOverGroup(torch.autograd.Function):
    """The mean of ``x`` over ``group``, where each rank's ``x`` is a mean
    over its data shard (shards of one size): the global batch's mean, on
    every rank. Each rank's loss then reads the global statistic and the
    Runner averages the ranks' gradients, so the backward hands each rank
    the group's mean of the incoming gradients: that average over the data
    group gives the gradient of the global batch's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out.div_(dist.get_world_size(group))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad.div_(dist.get_world_size(ctx.group)), None


def _top_k(gates, k):
    """``lax.top_k`` over the last dim: the k largest values, descending,
    and their indices, the lower index first among equal values (a stable
    sort; ``torch.topk`` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(gates, cfg, group=None):
    """Top-k routing shared by the dispatch and dense paths.

    gates: (T, E) softmax probabilities. ``group``: the data group whose
    shards make up the global batch the aux loss is taken over (None: this
    batch is the whole one).
    Returns (top_vals (T, k) normalized, top_idx (T, k), aux scalar).
    """
    top_vals, top_idx = _top_k(gates, cfg.top_k)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)

    # Switch-style load-balancing auxiliary loss (computed pre-drop, the
    # standard formulation: drops depend on buffer order, load balance
    # should not).  Normalize by top_k: the routing indicator sums to top_k
    # per token, so dividing keeps `density` a per-expert token fraction
    # (sums to 1) and the aux scale independent of k.
    routed = F.one_hot(top_idx, cfg.num_experts).float().sum(-2)  # (T, E)
    density = routed.mean(0) / cfg.top_k
    density_proxy = gates.mean(0)           # mean gate prob per expert
    if group is not None:
        density, density_proxy = _MeanOverGroup.apply(
            torch.stack([density, density_proxy]), group)
    aux = cfg.num_experts * torch.sum(density * density_proxy)
    return top_vals, top_idx, aux


def _batch_group(ctx):
    """The context when the routing must see the global batch (its
    ``global_batch`` rule), else None. A seq axis splits the tokens of a
    row over ranks, which the slot order does not follow: it raises."""
    if ctx is None:
        return None
    if ctx.seq_size > 1:
        raise NotImplementedError(
            "autodist_tpu_torch: an MoE layer under a seq axis (each rank "
            "holding a chunk of the sequence) is not ported yet: the "
            "routing's slot order would have to follow the chunks "
            "(ROADMAP.md, Queue A item 10(i)-seq)")
    return ctx if ctx.global_batch else None


def _whole(params, cfg, what):
    for name in ("up", "down"):
        if params[name]["kernel"].shape[0] != cfg.num_experts:
            raise ValueError(
                f"{what} computes every expert: it takes the whole "
                f"{name}/kernel ({cfg.num_experts} experts), not "
                f"{params[name]['kernel'].shape[0]}")


def apply(params, cfg, x):
    """x: (..., d_model) -> (moe_out, aux_loss).

    Capacity-based dispatch (the production path): per-expert buffers of
    C = ceil(T*k/E * capacity_factor) tokens; experts compute only their
    buffer. Dispatch and combine are index-based, as in the JAX package (a
    gather into the buffer; each token's k weighted expert outputs summed
    back), with static shapes throughout: no host sync, so the step can be
    captured and ``flops_estimate`` runs it on ``meta`` tensors.

    Under an expert axis whose ranks hold E/ep experts each (the pieces
    of ``EXPERT_RULES``) a rank computes its experts only, under a model
    axis whose ranks hold h/tp hidden columns of each expert its columns
    only, and the group of those axes all-reduces the (T, d) f32 output;
    see the module docstring for the batch the routing sees.
    """
    lead_shape = tuple(x.shape[:-1])
    tokens = math.prod(lead_shape)
    k, num_e, d = cfg.top_k, cfg.num_experts, cfg.d_model
    flat_x = x.reshape(tokens, d)
    up, down = params["up"]["kernel"], params["down"]["kernel"]
    ep = context.experts(up, num_e)
    if ep is not None and down.shape[0] != up.shape[0]:
        raise ValueError(f"up/kernel holds {up.shape[0]} experts and "
                         f"down/kernel {down.shape[0]}: one expert piece "
                         f"each")
    tp = context.megatron(up, 2, cfg.d_hidden)
    if down.shape[1] != up.shape[2]:
        raise ValueError(f"up/kernel holds {up.shape[2]} hidden columns and "
                         f"down/kernel {down.shape[1]} rows: one column "
                         f"piece each")
    ctx = context.current()
    # The ranks whose partial outputs make up the layer's: the group of the
    # expert axis, the model axis or both.
    axes = tuple(a for a, c in ((const.MESH_AXIS_EXPERT, ep),
                                (const.MESH_AXIS_MODEL, tp)) if c is not None)
    group = ctx.group_over(axes) if axes else None
    shard = _batch_group(ctx)
    data = 1 if shard is None else shard.data_size

    logits = flat_x.float() @ params["gate"]["kernel"].float()
    gates = torch.softmax(logits, dim=-1)                        # (T, E)
    top_vals, top_idx, aux = _route(
        gates, cfg, None if shard is None else shard.data_group)

    # Capacity from the global batch's tokens (the JAX package's static
    # shape: the data shards are of one size).
    global_tokens = tokens * data
    capacity = min(global_tokens, max(1, math.ceil(
        global_tokens * k / num_e * cfg.capacity_factor)))
    # Capacity semantics are a numerics contract: at the default
    # capacity_factor=1.25 overflow tokens are DROPPED for that expert
    # (callers wanting the drop-free oracle need capacity_factor >= E/k or
    # dense_apply). One log line per program.
    if capacity < global_tokens and (ctx is None or ctx.log_once(
            ("moe_drop", num_e, capacity, global_tokens))):
        logging.info(
            "MoE dispatch: E=%d capacity=%d tokens=%d (top_k=%d, cf=%.2f) — "
            "over-capacity assignments are dropped", num_e, capacity,
            global_tokens, cfg.top_k, cfg.capacity_factor)

    # k-major assignment order: every token's 1st choice claims buffer
    # slots before any token's 2nd choice (GShard's priority rule), so
    # capacity overflow drops low-priority assignments first. A slot is the
    # assignment's place among its expert's: the j-th choices of every
    # earlier choice rank j' < j (of every data shard), then of the data
    # shards before this one, then of this shard's earlier tokens.
    idx = top_idx.t()                                            # (k, T)
    mask = F.one_hot(idx, num_e)                                 # (k, T, E)
    counts = mask.sum(1)                                         # (k, E)
    within = ((mask.cumsum(1) - mask) * mask).sum(-1)            # (k, T)
    if shard is None:
        before = torch.zeros_like(counts)
    else:
        every = all_gather(counts, 0, shard.data_group).view(data, k, num_e)
        before = every[:shard.data_index].sum(0)
        counts = every.sum(0)
    offset = counts.cumsum(0) - counts + before                  # (k, E)
    slot = within + offset.gather(1, idx)                        # (k, T)
    keep = slot < capacity

    # This rank's experts: all of them, or its piece [e0, e0 + E/ep).
    local_e = up.shape[0]
    first = 0 if ep is None else ep.expert_index * local_e
    if ep is not None:
        keep = keep & (idx >= first) & (idx < first + local_e)
    cells = local_e * capacity

    # Token-id buffer (0 = empty): assignment (j, t) writes token t + 1
    # into its expert's slot; dropped ones (and other ranks' experts) write
    # a trash cell. Kept (e, slot) pairs are unique, so no write races.
    flat_ec = torch.where(keep, (idx - first) * capacity + slot,
                          cells).reshape(-1)                     # (k*T,)
    tok_ids = torch.arange(tokens, device=x.device).repeat(k)
    buf = torch.zeros(cells + 1, dtype=torch.long, device=x.device) \
        .scatter_(0, flat_ec, tok_ids + 1)[:cells]

    xc = flat_x.to(cfg.dtype)
    vals = top_vals.t().reshape(-1)                              # (k*T,)
    if group is not None:
        xc = L.copy_to_model(xc, group)
        vals = L.copy_to_model(vals, group)
    up, down = up.to(cfg.dtype), down.to(cfg.dtype)
    occupied = (buf > 0).unsqueeze(-1)
    expert_in = torch.where(occupied, xc[(buf - 1).clamp(min=0)], 0) \
        .view(local_e, capacity, d)
    h = F.gelu(torch.bmm(expert_in, up), approximate="tanh")
    expert_out = torch.bmm(h, down).view(cells, d)

    # Combine: each assignment gathers its expert's output slot, weighted
    # by the (renormalized) gate; dropped assignments contribute zero.
    y = expert_out[flat_ec.clamp(max=cells - 1)]
    w = vals * keep.reshape(-1).float()
    out = (y.float() * w[:, None]).view(k, tokens, d).sum(0)
    if group is not None:
        out = L.reduce_from_model(out, group)
    return out.reshape(lead_shape + (d,)).to(x.dtype), aux


def dense_apply(params, cfg, x):
    """Dense all-experts compute (numerics reference; E/k x the FLOPs).

    Every expert's FFN runs on every token and the combine weights zero the
    non-routed pairs — no token is ever dropped, so this is the drop-free
    oracle :func:`apply` is tested against. It takes the whole expert
    kernels; its aux loss follows the same batch rule as :func:`apply`.
    """
    _whole(params, cfg, "dense_apply")
    shard = _batch_group(context.current())
    logits = x.float() @ params["gate"]["kernel"].float()
    gates = torch.softmax(logits, dim=-1)                       # (..., E)
    flat_gates = gates.reshape(-1, cfg.num_experts)
    top_vals, top_idx, aux = _route(
        flat_gates, cfg, None if shard is None else shard.data_group)
    combine = torch.zeros_like(flat_gates).scatter(
        1, top_idx, top_vals).reshape(gates.shape)              # (..., E)

    xc = x.to(cfg.dtype)
    up = params["up"]["kernel"].to(cfg.dtype)
    down = params["down"]["kernel"].to(cfg.dtype)
    h = F.gelu(torch.einsum("...d,edh->...eh", xc, up), approximate="tanh")
    per_expert = torch.einsum("...eh,ehd->...ed", h, down)
    out = torch.einsum("...ed,...e->...d", per_expert.float(), combine)
    return out.to(x.dtype), aux


def reference_apply(params, cfg, x):
    """Per-token loop reference (slow, for numeric tests)."""
    _whole(params, cfg, "reference_apply")
    logits = x.float() @ params["gate"]["kernel"].float()
    gates = torch.softmax(logits, dim=-1)
    flat_x = x.reshape(-1, cfg.d_model)
    flat_g = gates.reshape(-1, cfg.num_experts)
    outs = []
    for t in range(flat_x.shape[0]):
        vals, idx = _top_k(flat_g[t], cfg.top_k)
        vals = vals / vals.sum()
        acc = torch.zeros(cfg.d_model, device=x.device)
        for j in range(cfg.top_k):
            e = int(idx[j])
            up = params["up"]["kernel"][e]
            xt = flat_x[t].to(torch.promote_types(x.dtype, up.dtype))
            h = F.gelu(xt @ up, approximate="tanh")
            acc = acc + vals[j] * (h @ params["down"]["kernel"][e])
        outs.append(acc)
    return torch.stack(outs).reshape(x.shape).to(x.dtype)
