"""Functional layer library over nested dicts of tensors.

Counterpart of ``autodist_tpu/models/layers.py``: the same param-tree keys
and layouts (dense kernels are (in, out), embeddings (vocab, dim)), so a
JAX param tree converts leaf by leaf (``convert.params_from_jax``).
Parameters stay float32 and are cast to the compute ``dtype`` at use.

Conv kernels are HWIO (kh, kw, in, out) and conv / batch norm / max-pool
activations NHWC at the function boundary, as in the JAX package. Inside,
an NHWC tensor viewed as NCHW (``permute(0, 3, 1, 2)``) is a
``channels_last`` tensor, which cuDNN takes without a copy; the kernel
reaches it as a ``channels_last`` OIHW copy in the compute dtype.

Ported: the initializers, ``dense``, ``conv``, ``batchnorm``, ``layernorm``,
``embed``, ``mha``, ``mha_decode`` (one token against a KV cache),
``dot_product_attention``, ``causal_mask``, ``lstm``, ``max_pool`` (the
ResNet stem's ``reduce_window``) and the losses (``softmax_xent``,
``sigmoid_bce``).

Tensor parallelism (``ModelParallel``): where the weights reach a layer as
this rank's Megatron pieces (``parallel.context.megatron``), ``mha`` and
the transformer's MLP run the Megatron forms. The input of the
column-parallel q/k/v and up projections goes through
:func:`copy_to_model` (identity; its gradient all-reduced over the model
group), and the row-parallel out and down projections are
``dense(..., row_group=)`` (this rank's partial product all-reduced over
the model group, the whole bias added once after the sum). The JAX
package writes none of this: GSPMD inserts the collectives.
"""
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from autodist_tpu_torch.parallel import context
from autodist_tpu_torch.parallel.collectives import GatherShards
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.scope import einsum


# -- initializers ------------------------------------------------------------

def glorot(generator, shape, dtype=torch.float32, in_axis=-2, out_axis=-1):
    """Glorot-scaled standard normal truncated to [-2, 2] (the JAX
    package's distribution; its values differ)."""
    rank = len(shape)
    rest = int(np.prod([shape[i] for i in range(rank)
                        if i not in (in_axis % rank, out_axis % rank)]))
    fan_in, fan_out = shape[in_axis] * rest, shape[out_axis] * rest
    scale = math.sqrt(2.0 / max(1.0, (fan_in + fan_out) / 2.0))
    t = torch.empty(shape, dtype=dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return scale * t


def he_conv(generator, shape, dtype=torch.float32):
    """He-normal for HWIO conv kernels."""
    fan_in = int(np.prod(shape[:-1]))
    return torch.randn(shape, generator=generator, dtype=dtype) * \
        math.sqrt(2.0 / fan_in)


def normal(generator, shape, stddev=0.02, dtype=torch.float32):
    return stddev * torch.randn(shape, generator=generator, dtype=dtype)


def dense_init(generator, in_dim, out_dim, use_bias=True):
    p = {"kernel": glorot(generator, (in_dim, out_dim))}
    if use_bias:
        p["bias"] = torch.zeros(out_dim)
    return p


def conv_init(generator, kh, kw, in_ch, out_ch, use_bias=False):
    p = {"kernel": he_conv(generator, (kh, kw, in_ch, out_ch))}
    if use_bias:
        p["bias"] = torch.zeros(out_ch)
    return p


def batchnorm_init(ch):
    return {"scale": torch.ones(ch), "bias": torch.zeros(ch)}


def layernorm_init(dim):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def embed_init(generator, vocab, dim, stddev=0.02):
    return {"embedding": normal(generator, (vocab, dim), stddev)}


def mha_init(generator, dim, num_heads):
    return {name: dense_init(generator, dim, dim)
            for name in ("query", "key", "value", "out")}


def lstm_init(generator, in_dim, hidden):
    return {"wi": glorot(generator, (in_dim, 4 * hidden)),
            "wh": glorot(generator, (hidden, 4 * hidden)),
            "bias": torch.zeros(4 * hidden)}


# -- layers ------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the gradient
    over the model group (each rank's column pieces contribute their part
    of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the forward sums the row pieces' partial products over
    the model group; the identity backward (every rank needs the whole
    output's gradient for its piece)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    """``x`` in front of column-parallel weights over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """The sum over ``group`` of the ranks' partial ``x``."""
    return _ReduceFromModel.apply(x, group)


def dense(p, x, dtype=None, row_group=None):
    """``x @ kernel + bias``. With ``row_group`` the kernel is this rank's
    row piece (its input dim split over the model group) and ``x`` the
    matching piece of the input: the partial product is summed over the
    group, then the whole bias added once."""
    k = p["kernel"]
    if dtype is not None:
        x, k = x.to(dtype), k.to(dtype)
    y = x @ k
    if row_group is not None:
        y = reduce_from_model(y, row_group)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def same_pads(size, window, stride):
    """(lo, hi) padding of one spatial dim under XLA's ``"SAME"``: the
    output has ceil(size / stride) positions and the odd pixel of the total
    goes to the high side (so a stride-2 window at an even size is padded
    (0, 1), where a symmetric pad would shift every window by one)."""
    total = max((-(-size // stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    """``x`` (NHWC) padded for a "SAME" (kh, kw) window, and the symmetric
    (h, w) padding left for the library call: an asymmetric pad is done
    here explicitly, a symmetric one by the call itself."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[1], kh, stride),
                          same_pads(x.shape[2], kw, stride))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (0, 0, wl, wr, ht, hb), value=value), (0, 0)


def conv(p, x, stride=1, dtype=None):
    """NHWC conv with an HWIO kernel and XLA's "SAME" padding (the only
    padding the zoo uses).

    The activation goes to ``F.conv2d`` as the NCHW view of its NHWC memory
    (``channels_last``) and the kernel as a ``channels_last`` OIHW copy
    made in the compute dtype, so cuDNN sees one memory format and adds no
    layout transposes."""
    k = p["kernel"]
    if dtype is not None:
        x = x.to(dtype)
    x, pads = _pad_same(x, k.shape[0], k.shape[1], stride)
    w = k.permute(3, 0, 1, 2).to(dtype or k.dtype,
                                 memory_format=torch.contiguous_format)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2),
                 stride=stride, padding=pads).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def max_pool(x, window=3, stride=2):
    """Max over "SAME" (window x window) windows of NHWC ``x``, padded with
    -inf: ``lax.reduce_window(x, -inf, max, ..., "SAME")``."""
    x, pads = _pad_same(x, window, window, stride, value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                        padding=pads).permute(0, 2, 3, 1)


def batchnorm(p, x, eps=1e-5):
    """Train-mode batch norm over every axis but the last: batch
    statistics (population variance), no running averages, the result in
    ``x``'s dtype.

    ``F.batch_norm(x, None, None, scale, bias, training=True)`` with the
    channels at dim 1 (an NCHW view of NHWC memory): PyTorch reduces and
    normalises a bf16 input in f32 (its accumulation type) and rounds the
    result once, which is the JAX package's ``x.astype(float32)`` form
    without the f32 copy. Scale and bias enter in f32 (bf16 ones under
    ``precision="bf16"`` upcast exactly, as JAX's type promotion does).
    Statistics are this rank's own (no sync-BN)."""
    y = F.batch_norm(x.movedim(-1, 1), None, None, p["scale"].float(),
                     p["bias"].float(), training=True, eps=eps)
    return y.movedim(1, -1)


def layernorm(p, x, eps=1e-6):
    """Population variance and eps 1e-6, computed in float32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def embed(p, ids):
    """Row lookup; ``GraphItem.capture`` marks the table as sparse-access."""
    return p["embedding"][ids]


def mha(p, x, num_heads, mask=None, dtype=None, attn_fn=None):
    """Multi-head self-attention. ``attn_fn(q, k, v, mask)`` may override
    the inner attention; q/k/v are (batch, heads, seq, head_dim).

    Given this rank's Megatron pieces (q/k/v column pieces, out a row
    piece), it attends over its share of the heads, whose count it takes
    from the q piece's width, and sums the out projection over the model
    group. Where the model axis does not divide the heads, the pieces are
    gathered first and every rank computes the whole layer."""
    b, s, d = x.shape
    hd = d // num_heads
    tp = context.megatron(p["query"]["kernel"], 1, d)
    if tp is not None and p["query"]["kernel"].shape[1] % hd:
        p = _gather_attention(p, tp, num_heads)
        tp = None
    group = None if tp is None else tp.model_group
    if group is not None:
        x = copy_to_model(x, group)
    width = p["query"]["kernel"].shape[1]
    heads = width // hd

    def split(t):
        return t.reshape(b, s, heads, hd).transpose(1, 2)

    q = split(dense(p["query"], x, dtype))
    k = split(dense(p["key"], x, dtype))
    v = split(dense(p["value"], x, dtype))
    if attn_fn is not None:
        o = attn_fn(q, k, v, mask)
    else:
        o = dot_product_attention(q, k, v, mask)
    o = o.transpose(1, 2).reshape(b, s, width)
    return dense(p["out"], o, dtype, row_group=group)


def _gather_attention(p, tp, num_heads):
    """The attention weights whole, from this rank's pieces: q/k/v kernels
    along dim 1 and biases along dim 0, the out kernel along dim 0, each
    gathered over the model group (its gradient reduce-scattered and
    divided by the model size)."""
    if tp.log_once("mha-gather"):
        logging.warning(
            "ModelParallel: the model axis (%d) does not divide the %d "
            "attention heads; the attention weights are gathered at use "
            "and every rank computes all heads", tp.model_size, num_heads)

    def gather(t, dim):
        return GatherShards.apply(t, dim, tp.model_group, tp.model_size)
    out = {name: {"kernel": gather(p[name]["kernel"], 1),
                  **({"bias": gather(p[name]["bias"], 0)}
                     if "bias" in p[name] else {})}
           for name in ("query", "key", "value")}
    out["out"] = dict(p["out"], kernel=gather(p["out"]["kernel"], 0))
    return out


def dot_product_attention(q, k, v, mask=None):
    """Reference attention: softmax(qk^T/sqrt(d))v with an f32 softmax;
    masked logits take ``finfo(float32).min``."""
    hd = q.shape[-1]
    logits = einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def mha_decode(p, x, num_heads, k_cache, v_cache, pos, dtype=None):
    """Single-token self-attention against a preallocated KV cache.

    ``x`` is one token per slot, (slots, 1, dim); ``k_cache`` / ``v_cache``
    are (slots, heads, cache_len, head_dim); ``pos`` (slots,) is each
    slot's position. This token's k/v are written at ``pos`` IN PLACE (a
    ``scatter_`` on the position dim: an exact copy, so a captured CUDA
    graph updates its static cache), then the one query row attends over
    the whole cache under a ``j <= pos`` mask through
    :func:`dot_product_attention`: masked logits take ``finfo(float32).min``
    and the f32 softmax gives them exactly 0, so rows past ``pos`` (zeros,
    or a previous occupant's values) contribute nothing. The JAX package
    broadcasts the query to ``cache_len`` rows to match its full forward
    bitwise; one row is ``cache_len`` times less work here.

    Returns ``(out, k_cache, v_cache)``; the caches are the arguments,
    updated.
    """
    b, s, d = x.shape
    hd = d // num_heads
    cache_len = k_cache.shape[2]

    def split(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    q = split(dense(p["query"], x, dtype))
    k = split(dense(p["key"], x, dtype))      # (slots, heads, 1, hd)
    v = split(dense(p["value"], x, dtype))
    pos = pos.long()
    at = pos.view(b, 1, 1, 1).expand(b, num_heads, 1, hd)
    k_cache.scatter_(2, at, k.to(k_cache.dtype))
    v_cache.scatter_(2, at, v.to(v_cache.dtype))
    mask = (torch.arange(cache_len, device=x.device)[None, None, None, :] <=
            pos[:, None, None, None])
    o = dot_product_attention(q, k_cache, v_cache, mask)
    o = o.transpose(1, 2).reshape(b, s, d)
    return dense(p["out"], o, dtype), k_cache, v_cache


def causal_mask(seq_len, device=None):
    return torch.tril(torch.ones((1, 1, seq_len, seq_len), dtype=torch.bool,
                                 device=device))


# -- recurrent ---------------------------------------------------------------

def lstm(p, xs, hidden, reverse=False, dtype=None):
    """LSTM over time: xs (batch, time, in_dim) -> (batch, time, hidden) f32.

    The JAX package's ``lax.scan`` cell as a loop over time steps, with the
    input products of all steps as one matmul before the loop: per step
    z = x.wi + h.wh + bias in the compute dtype, gates i, f, g, o in f32,
    forget gate sigmoid(f + 1). Carries start at f32 zeros; h is cast to
    wh's dtype for its product. ``reverse`` runs time backwards and returns
    the outputs in the original order."""
    wi, wh, bias = p["wi"], p["wh"], p["bias"]
    if dtype is not None:
        wi, wh = wi.to(dtype), wh.to(dtype)
    b, steps = xs.shape[:2]
    zx = xs.to(wi.dtype) @ wi
    bias = bias.to(wi.dtype)
    h = torch.zeros((b, hidden), device=xs.device)
    c = torch.zeros((b, hidden), device=xs.device)
    hs = [None] * steps
    for t in (reversed(range(steps)) if reverse else range(steps)):
        z = zx[:, t] + h.to(wh.dtype) @ wh + bias
        i, f, g, o = z.float().chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[t] = h
    return torch.stack(hs, dim=1)


# -- losses ------------------------------------------------------------------

def token_xent(logits, labels):
    """Cross-entropy of each int label (the logits' shape without its last
    dim); f32 softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0]


def softmax_xent(logits, labels):
    """Mean cross-entropy over int labels; f32 softmax."""
    return token_xent(logits, labels).mean()


def sigmoid_bce(logits, targets):
    logits = logits.float()
    return (logits.clamp(min=0) - logits * targets +
            torch.log1p(torch.exp(-logits.abs()))).mean()
