"""Functional layer library over nested dicts of tensors.

Counterpart of ``autodist_tpu/models/layers.py``: the same param-tree keys
and layouts (dense kernels are (in, out), embeddings (vocab, dim)), so a
JAX param tree converts leaf by leaf (``convert.params_from_jax``).
Parameters stay float32 and are cast to the compute ``dtype`` at use.

Ported: the initializers, ``dense``, ``layernorm``, ``embed``, ``mha``,
``dot_product_attention``, ``causal_mask`` and the losses
(``softmax_xent``, ``sigmoid_bce``). Conv, batchnorm, lstm and the KV-cache
decode are not ported yet (ROADMAP.md).
"""
import math

import numpy as np
import torch


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


def normal(generator, shape, stddev=0.02, dtype=torch.float32):
    return stddev * torch.randn(shape, generator=generator, dtype=dtype)


def dense_init(generator, in_dim, out_dim, use_bias=True):
    p = {"kernel": glorot(generator, (in_dim, out_dim))}
    if use_bias:
        p["bias"] = torch.zeros(out_dim)
    return p


def layernorm_init(dim):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def embed_init(generator, vocab, dim, stddev=0.02):
    return {"embedding": normal(generator, (vocab, dim), stddev)}


def mha_init(generator, dim, num_heads):
    return {name: dense_init(generator, dim, dim)
            for name in ("query", "key", "value", "out")}


# -- layers ------------------------------------------------------------------

def dense(p, x, dtype=None):
    k = p["kernel"]
    if dtype is not None:
        x, k = x.to(dtype), k.to(dtype)
    y = x @ k
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


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
    the inner attention; q/k/v are (batch, heads, seq, head_dim)."""
    b, s, d = x.shape
    hd = d // num_heads

    def split(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    q = split(dense(p["query"], x, dtype))
    k = split(dense(p["key"], x, dtype))
    v = split(dense(p["value"], x, dtype))
    if attn_fn is not None:
        o = attn_fn(q, k, v, mask)
    else:
        o = dot_product_attention(q, k, v, mask)
    o = o.transpose(1, 2).reshape(b, s, d)
    return dense(p["out"], o, dtype)


def dot_product_attention(q, k, v, mask=None):
    """Reference attention: softmax(qk^T/sqrt(d))v with an f32 softmax;
    masked logits take ``finfo(float32).min``."""
    hd = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def causal_mask(seq_len, device=None):
    return torch.tril(torch.ones((1, 1, seq_len, seq_len), dtype=torch.bool,
                                 device=device))


# -- losses ------------------------------------------------------------------

def softmax_xent(logits, labels):
    """Mean cross-entropy over int labels; f32 softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def sigmoid_bce(logits, targets):
    logits = logits.float()
    return (logits.clamp(min=0) - logits * targets +
            torch.log1p(torch.exp(-logits.abs()))).mean()
