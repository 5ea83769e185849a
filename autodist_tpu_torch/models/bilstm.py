"""BiLSTM sentiment classifier.

Counterpart of ``autodist_tpu/models/bilstm.py``: embed, a forward and a
reverse LSTM over the tokens, and a head on the two final states
``[hf[:, -1], hb[:, 0]]``; the same param keys (``embed``, ``fwd``,
``bwd``, ``head``).
"""
import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import tree_map


class BiLSTMConfig:
    def __init__(self, vocab=20000, embed_dim=128, hidden=128, num_classes=2,
                 dtype=torch.float32):
        self.vocab = vocab
        self.embed_dim = embed_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.dtype = dtype


def init(cfg, generator=None, device="cuda"):
    """Float32 params drawn on the CPU from ``generator`` (default: seed 0),
    then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {"embed": L.embed_init(generator, cfg.vocab, cfg.embed_dim),
              "fwd": L.lstm_init(generator, cfg.embed_dim, cfg.hidden),
              "bwd": L.lstm_init(generator, cfg.embed_dim, cfg.hidden),
              "head": L.dense_init(generator, 2 * cfg.hidden,
                                   cfg.num_classes)}
    return tree_map(lambda t: t.to(device), params)


def apply(params, cfg, ids):
    x = L.embed(params["embed"], ids)
    hf = L.lstm(params["fwd"], x, cfg.hidden, dtype=cfg.dtype)
    hb = L.lstm(params["bwd"], x, cfg.hidden, reverse=True, dtype=cfg.dtype)
    h = torch.cat([hf[:, -1], hb[:, 0]], dim=-1)  # final states
    return L.dense(params["head"], h, dtype=torch.float32)


def make_loss_fn(cfg):
    """Cross-entropy loss. batch = (token ids (batch, time), int labels)."""
    def loss_fn(params, batch):
        ids, labels = batch
        return L.softmax_xent(apply(params, cfg, ids), labels)
    return loss_fn


def synthetic_batch(cfg, batch_size=64, seq_len=128, seed=0):
    """(ids int32 (batch, seq_len), labels int32) from
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab, (batch_size, seq_len)).astype(np.int32),
            rng.randint(0, cfg.num_classes, (batch_size,)).astype(np.int32))
