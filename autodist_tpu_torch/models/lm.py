"""Decoder-only causal language model configurations.

Counterpart of ``autodist_tpu/models/lm.py``. The next-token loss and the
KV-cache decode entry points are not ported yet (ROADMAP.md).
"""
import torch

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
