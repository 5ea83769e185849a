"""Transformer blocks shared by BERT (encoder) and the causal LM.

Counterpart of ``autodist_tpu/models/transformer.py``, with the same param
scopes (``layer<i>/attn/{query,key,value,out}``, ``layer<i>/mlp/{up,down}``).
Ported: ``TransformerConfig``, ``block_init``, ``init``, ``block_apply``,
``encode`` and ``logits``. The stacked-blocks layout, the sequence-parallel
attention hook and the KV-cache decode functions are not ported yet
(ROADMAP.md).
"""
import torch
import torch.nn.functional as F

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import tree_map


class TransformerConfig:
    def __init__(self, vocab=32000, dim=512, num_heads=8, num_layers=6,
                 mlp_dim=None, max_len=512, causal=False,
                 dtype=torch.bfloat16, num_segments=0):
        self.vocab = vocab
        self.dim = dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim or 4 * dim
        self.max_len = max_len
        self.causal = causal
        self.dtype = dtype
        self.num_segments = num_segments


def block_init(generator, cfg):
    return {
        "ln1": L.layernorm_init(cfg.dim),
        "attn": L.mha_init(generator, cfg.dim, cfg.num_heads),
        "ln2": L.layernorm_init(cfg.dim),
        "mlp": {"up": L.dense_init(generator, cfg.dim, cfg.mlp_dim),
                "down": L.dense_init(generator, cfg.mlp_dim, cfg.dim)},
    }


def block_apply(p, x, cfg, mask=None, attn_fn=None):
    h = L.layernorm(p["ln1"], x)
    x = x + L.mha(p["attn"], h, cfg.num_heads, mask=mask, dtype=cfg.dtype,
                  attn_fn=attn_fn)
    h = L.layernorm(p["ln2"], x)
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu(L.dense(p["mlp"]["up"], h, cfg.dtype), approximate="tanh")
    return x + L.dense(p["mlp"]["down"], h, cfg.dtype)


def init(cfg, generator=None, device="cuda"):
    """Float32 params drawn on the CPU from ``generator`` (default: seed 0)
    with the JAX initializers' distributions, then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.dim),
        "pos_embed": L.normal(generator, (cfg.max_len, cfg.dim), 0.02),
        "ln_f": L.layernorm_init(cfg.dim),
    }
    if cfg.num_segments:
        params["seg_embed"] = L.normal(generator, (cfg.num_segments, cfg.dim),
                                       0.02)
    for i in range(cfg.num_layers):
        params[f"layer{i}"] = block_init(generator, cfg)
    return tree_map(lambda t: t.to(device), params)


def encode(params, cfg, ids, segment_ids=None, attn_fn=None):
    """Token ids (batch, seq) -> final hidden states (batch, seq, dim).

    With no explicit ``attn_fn`` every layer's attention is the flash
    forward (``ops/flash_attention.py``), its causality positional. An
    explicit ``attn_fn`` receives the boolean causal mask, as in the JAX
    package.
    """
    s = ids.shape[1]
    # Embedding sum in f32; cast to the compute dtype after all three.
    x = L.embed(params["embed"], ids) + params["pos_embed"][:s]
    if cfg.num_segments and segment_ids is not None:
        x = x + params["seg_embed"][segment_ids]
    x = x.to(cfg.dtype)
    if attn_fn is None:
        from autodist_tpu_torch.ops.flash_attention import make_flash_attn_fn
        attn_fn = make_flash_attn_fn(causal=cfg.causal)
        mask = None
    else:
        mask = L.causal_mask(s, device=ids.device) if cfg.causal else None
    for i in range(cfg.num_layers):
        x = block_apply(params[f"layer{i}"], x, cfg, mask=mask,
                        attn_fn=attn_fn)
    return L.layernorm(params["ln_f"], x)


def logits(params, cfg, hidden):
    """Tied-embedding output projection, in f32."""
    return hidden.float() @ params["embed"]["embedding"].T.float()
