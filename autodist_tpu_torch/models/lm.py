"""Decoder-only causal language model with the next-token loss.

Counterpart of ``autodist_tpu/models/lm.py``, with the KV-cache decode
entry points ``make_decode_fn`` and ``init_decode_cache``
(``serve/decode.py`` serves them).
"""
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import transformer as T


def lm1b(vocab=32000, dtype=torch.bfloat16):
    return T.TransformerConfig(vocab=vocab, dim=1024, num_heads=16,
                               num_layers=16, max_len=1024, causal=True,
                               dtype=dtype)


def lm_tiny(vocab=256, dtype=torch.float32, max_len=64):
    return T.TransformerConfig(vocab=vocab, dim=64, num_heads=4, num_layers=2,
                               max_len=max_len, causal=True, dtype=dtype)


def init(cfg, generator=None, device="cuda"):
    return T.init(cfg, generator, device)


def make_loss_fn(cfg, attn_fn=None):
    """Next-token loss. batch = (tokens,): inputs tokens[:, :-1], targets
    tokens[:, 1:]. Under sequence parallelism ``encode`` gives this rank's
    chunk of the sequence, and the targets are cut to the same chunk
    (``parallel.context.chunk`` decides both): the loss is the rank's
    token mean, whose mean over the seq group (the Runner's) is the whole
    sequence's because the chunks are equal (``chunk`` raises
    otherwise)."""
    def loss_fn(params, batch):
        from autodist_tpu_torch.parallel import context
        (tokens,) = batch if isinstance(batch, (tuple, list)) else (batch,)
        hidden = T.encode(params, cfg, tokens[:, :-1], attn_fn=attn_fn)
        targets = tokens[:, 1:]
        span = context.chunk(attn_fn, targets.shape[1])
        if span is not None:
            targets = targets[:, span[0]:span[0] + span[1]]
        return L.softmax_xent(T.logits(params, cfg, hidden), targets)
    return loss_fn


def make_decode_fn(cfg):
    """``(params, cache, tokens, pos) -> (logits, cache)``: the step each
    decode lane captures per (slots, cache_len) bucket (serve/decode.py)."""
    def decode_fn(params, cache, tokens, pos):
        return T.decode_step(params, cfg, cache, tokens, pos)
    return decode_fn


def init_decode_cache(cfg, slots, cache_len, device="cuda"):
    return T.init_cache(cfg, slots, cache_len, device=device)
