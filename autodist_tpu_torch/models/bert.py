"""BERT encoder with the masked-LM pretraining loss.

Counterpart of ``autodist_tpu/models/bert.py``.
"""
import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import transformer as T


def bert_base(vocab=30522, max_len=512, dtype=torch.bfloat16):
    return T.TransformerConfig(vocab=vocab, dim=768, num_heads=12,
                               num_layers=12, max_len=max_len, causal=False,
                               dtype=dtype, num_segments=2)


def bert_tiny(vocab=1000, max_len=64, dtype=torch.float32):
    return T.TransformerConfig(vocab=vocab, dim=64, num_heads=4, num_layers=2,
                               max_len=max_len, causal=False, dtype=dtype,
                               num_segments=2)


def init(cfg, generator=None, device="cuda"):
    return T.init(cfg, generator, device)


def make_loss_fn(cfg, attn_fn=None):
    """Masked-LM loss. batch = (ids, segment_ids, mlm_positions, mlm_labels).
    Not under sequence parallelism: the masked positions index the whole
    sequence, which no rank of a seq group holds (ROADMAP.md, Queue A item
    10(f))."""
    def loss_fn(params, batch):
        from autodist_tpu_torch.parallel import context
        if context.chunk(attn_fn, batch[0].shape[1]) is not None:
            raise NotImplementedError(
                "BERT's masked-LM loss under SequenceParallel is not ported "
                "to autodist_tpu_torch yet (ROADMAP.md, Queue A item "
                "10(f)): its masked positions index the whole sequence, "
                "and each rank encodes its chunk")
        ids, seg, positions, labels = batch
        hidden = T.encode(params, cfg, ids, segment_ids=seg, attn_fn=attn_fn)
        index = positions.long()[..., None].expand(-1, -1, hidden.shape[-1])
        picked = torch.gather(hidden, 1, index)
        return L.softmax_xent(T.logits(params, cfg, picked), labels)
    return loss_fn


def synthetic_batch(cfg, batch_size=8, seq_len=None, num_masked=4, seed=0):
    """(ids, segment_ids, mlm_positions, mlm_labels) int32 numpy arrays,
    the same values as the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    s = seq_len or min(cfg.max_len, 64)
    return (rng.randint(0, cfg.vocab, (batch_size, s)).astype(np.int32),
            rng.randint(0, 2, (batch_size, s)).astype(np.int32),
            rng.randint(0, s, (batch_size, num_masked)).astype(np.int32),
            rng.randint(0, cfg.vocab, (batch_size, num_masked)).astype(np.int32))
