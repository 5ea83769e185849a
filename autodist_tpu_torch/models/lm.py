"""Decoder-only causal language model with the next-token loss.

Counterpart of ``autodist_tpu/models/lm.py``. The KV-cache decode entry
points are not ported yet (ROADMAP.md).
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
    tokens[:, 1:]."""
    def loss_fn(params, batch):
        (tokens,) = batch if isinstance(batch, (tuple, list)) else (batch,)
        hidden = T.encode(params, cfg, tokens[:, :-1], attn_fn=attn_fn)
        return L.softmax_xent(T.logits(params, cfg, hidden), tokens[:, 1:])
    return loss_fn
