"""Transformer blocks shared by BERT (encoder) and the causal LM.

Counterpart of ``autodist_tpu/models/transformer.py``, with the same param
scopes (``layer<i>/attn/{query,key,value,out}``, ``layer<i>/mlp/{up,down}``,
or with ``scan_layers=True`` one ``blocks`` subtree of the same scopes
whose leaves carry a leading layer dim, applied through
``ops.scan_blocks``: one layer after another on one device, the pipeline
schedule under the ``Pipeline`` strategy). Ported: ``TransformerConfig``,
``block_init``, ``init``, ``block_apply``, ``encode`` (with the
sequence-parallel attention hook), ``logits`` and the KV-cache decode
functions ``init_cache``, ``block_decode`` and ``decode_step``. The
forward runs under the JAX package's named scopes (``embed``,
``layer<i>`` or ``blocks``, ``attn`` / ``mlp``, ``ln_f``, ``logits``),
which ``GraphItem.op_provenance`` and the stage cutter read.
"""
import torch
import torch.nn.functional as F

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.parallel import context
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.scope import named_scope
from autodist_tpu_torch.utils.tree import tree_map


class TransformerConfig:
    def __init__(self, vocab=32000, dim=512, num_heads=8, num_layers=6,
                 mlp_dim=None, max_len=512, causal=False,
                 dtype=torch.bfloat16, num_segments=0, scan_layers=False):
        self.vocab = vocab
        self.dim = dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_dim = mlp_dim or 4 * dim
        self.max_len = max_len
        self.causal = causal
        self.dtype = dtype
        self.num_segments = num_segments
        # Stacked-blocks layout: one "blocks" subtree with a leading layer
        # dim, applied through ops.scan_blocks.
        self.scan_layers = scan_layers


def block_init(generator, cfg):
    return {
        "ln1": L.layernorm_init(cfg.dim),
        "attn": L.mha_init(generator, cfg.dim, cfg.num_heads),
        "ln2": L.layernorm_init(cfg.dim),
        "mlp": {"up": L.dense_init(generator, cfg.dim, cfg.mlp_dim),
                "down": L.dense_init(generator, cfg.mlp_dim, cfg.dim)},
    }


def block_apply(p, x, cfg, mask=None, attn_fn=None):
    """One block. Under ``ModelParallel`` the attention and the MLP take
    this rank's Megatron pieces (``layers.mha``; the MLP's up projection
    column-parallel, its down projection row-parallel). The ``attn`` and
    ``mlp`` scopes nest under the caller's layer scope."""
    with named_scope("attn"):
        h = L.layernorm(p["ln1"], x)
        x = x + L.mha(p["attn"], h, cfg.num_heads, mask=mask,
                      dtype=cfg.dtype, attn_fn=attn_fn)
    with named_scope("mlp"):
        h = L.layernorm(p["ln2"], x)
        tp = context.megatron(p["mlp"]["up"]["kernel"], 1, cfg.mlp_dim)
        group = None if tp is None else tp.model_group
        if group is not None:
            h = L.copy_to_model(h, group)
        # jax.nn.gelu's default is the tanh approximation.
        h = F.gelu(L.dense(p["mlp"]["up"], h, cfg.dtype), approximate="tanh")
        return x + L.dense(p["mlp"]["down"], h, cfg.dtype, row_group=group)


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
    blocks = [block_init(generator, cfg) for _ in range(cfg.num_layers)]
    if cfg.scan_layers:
        from autodist_tpu_torch.pipeline.schedule import stack_stage_params
        params["blocks"] = stack_stage_params(blocks)
    else:
        for i, block in enumerate(blocks):
            params[f"layer{i}"] = block
    return tree_map(lambda t: t.to(device), params)


def encode(params, cfg, ids, segment_ids=None, attn_fn=None):
    """Token ids (batch, seq) -> final hidden states (batch, seq, dim).

    With no explicit ``attn_fn`` the strategy's attention comes first
    (``parallel.context.resolve_attn``: ``SequenceParallel``'s ring or
    Ulysses attention); then this rank encodes only its chunk of the
    sequence (``parallel.context.chunk``: its ids, positions and
    segments), every activation seq-local, and returns
    (batch, seq / P, dim). Otherwise
    every layer's attention is the flash forward
    (``ops/flash_attention.py``), its causality positional; a head dim or
    dtype the kernels do not take goes to the dense attention instead
    (``make_flash_attn_fn``). An explicit ``attn_fn`` receives the boolean
    causal mask, as in the JAX package.
    """
    s = ids.shape[1]
    off = 0
    if attn_fn is None:
        span = context.chunk(None, s)
        if span is not None:
            off, s = span
            attn_fn = context.resolve_attn(causal=cfg.causal)
            ids = ids[:, off:off + s]
            if segment_ids is not None:
                segment_ids = segment_ids[:, off:off + s]
        else:
            from autodist_tpu_torch.ops.flash_attention import \
                make_flash_attn_fn
            attn_fn = make_flash_attn_fn(causal=cfg.causal)
        mask = None
    else:
        mask = L.causal_mask(s, device=ids.device) if cfg.causal else None
    # Embedding sum in f32; cast to the compute dtype after all three.
    with named_scope("embed"):
        x = L.embed(params["embed"], ids) + params["pos_embed"][off:off + s]
        if cfg.num_segments and segment_ids is not None:
            x = x + params["seg_embed"][segment_ids]
        x = x.to(cfg.dtype)
    if cfg.scan_layers:
        from autodist_tpu_torch.ops.blocks import scan_blocks
        with named_scope("blocks"):
            x = scan_blocks(params["blocks"],
                            lambda bp, a: block_apply(bp, a, cfg, mask=mask,
                                                      attn_fn=attn_fn), x)
    else:
        for i in range(cfg.num_layers):
            with named_scope(f"layer{i}"):
                x = block_apply(params[f"layer{i}"], x, cfg, mask=mask,
                                attn_fn=attn_fn)
    with named_scope("ln_f"):
        return L.layernorm(params["ln_f"], x)


def logits(params, cfg, hidden):
    """Tied-embedding output projection, in f32."""
    with named_scope("logits"):
        return hidden.float() @ params["embed"]["embedding"].T.float()


# -- autoregressive decode (KV cache) ----------------------------------------

def init_cache(cfg, slots, cache_len, dtype=None, device="cuda"):
    """Preallocated per-layer KV cache on ``device``: (slots, heads,
    cache_len, head_dim) zeros per k / v per layer, keyed ``layer<i>/{k,v}``,
    in the compute dtype (what the k/v projections produce). Zeros are safe
    initial content: the ``j <= pos`` mask never exposes an unwritten row
    (``layers.mha_decode``)."""
    if cache_len > cfg.max_len:
        raise ValueError(
            f"cache_len {cache_len} exceeds the model's max_len "
            f"{cfg.max_len} (pos_embed table is the hard ceiling)")
    device = resolve_device(device)
    hd = cfg.dim // cfg.num_heads
    shape = (int(slots), cfg.num_heads, int(cache_len), hd)
    dt = dtype or cfg.dtype
    return {f"layer{i}": {"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}
            for i in range(cfg.num_layers)}


def block_decode(p, x, cfg, k_cache, v_cache, pos):
    """One transformer block for a single decode token per slot (under
    :func:`block_apply`'s scopes)."""
    with named_scope("attn"):
        h = L.layernorm(p["ln1"], x)
        a, k_cache, v_cache = L.mha_decode(p["attn"], h, cfg.num_heads,
                                           k_cache, v_cache, pos,
                                           dtype=cfg.dtype)
        x = x + a
    with named_scope("mlp"):
        h = L.layernorm(p["ln2"], x)
        h = F.gelu(L.dense(p["mlp"]["up"], h, cfg.dtype), approximate="tanh")
        return x + L.dense(p["mlp"]["down"], h, cfg.dtype), k_cache, v_cache


def decode_step(params, cfg, cache, tokens, pos):
    """One autoregressive step: feed ``tokens`` (slots,) at positions
    ``pos`` (slots,); returns ``(logits (slots, vocab) f32, cache)``, the
    logits predicting position ``pos + 1``. The cache is updated in place
    and returned.

    Every per-position op (embed, layernorm, dense, logits) is
    row-independent and the attention an exact masked select over the
    cache, so the step computes what :func:`encode` over the prefix (padded
    to the cache length, dense attention) computes at row ``pos``; in
    other matmul shapes, so to rounding, not bitwise (tests/test_torch_decode.py).
    """
    if cfg.scan_layers:
        raise NotImplementedError(
            "decode_step does not support scan_layers layouts; build the "
            "serving config with scan_layers=False")
    tokens, pos = tokens.long(), pos.long()
    with named_scope("embed"):
        x = L.embed(params["embed"], tokens[:, None]) + \
            params["pos_embed"][pos][:, None, :]
        x = x.to(cfg.dtype)
    for i in range(cfg.num_layers):
        with named_scope(f"layer{i}"):
            lc = cache[f"layer{i}"]
            x, _, _ = block_decode(params[f"layer{i}"], x, cfg, lc["k"],
                                   lc["v"], pos)
    with named_scope("ln_f"):
        x = L.layernorm(params["ln_f"], x)
    return logits(params, cfg, x)[:, 0, :], cache
