"""BERT encoder with the masked-LM pretraining loss.

Counterpart of ``autodist_tpu/models/bert.py``.
"""
import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.utils.scope import named_scope


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
    """Masked-LM loss. batch = (ids, segment_ids, mlm_positions, mlm_labels):
    the cross-entropy's mean over the rows' masked positions.

    Under sequence parallelism (``parallel.context.chunk``) this rank
    encodes its chunk of the sequence, and its loss covers the masked
    positions in that chunk (:func:`chunk_mlm_loss`); without it the chunk
    is the whole sequence."""
    def loss_fn(params, batch):
        from autodist_tpu_torch.parallel import context
        ids, seg, positions, labels = batch
        hidden = T.encode(params, cfg, ids, segment_ids=seg, attn_fn=attn_fn)
        length = ids.shape[1]
        span = context.chunk(attn_fn, length) or (0, length)
        with named_scope("mlm_head"):
            return chunk_mlm_loss(params, cfg, hidden, positions, labels,
                                  span, length // span[1])
    return loss_fn


def chunk_mlm_loss(params, cfg, hidden, positions, labels, span, p):
    """The MLM loss of one rank of a seq group of ``p`` ranks, whose
    ``hidden`` (rows, length, dim) is the chunk ``span`` = (offset,
    length) of the sequence (``p`` 1 and the whole sequence without a seq
    axis).

    Every masked position is taken, at its index clamped into the chunk,
    with weight 1 where it falls in the chunk and 0 elsewhere (static
    shapes: no gather whose size depends on the data). The loss is
    ``p * sum(weight * xent) / N``, N the rows times the masked positions
    a row: the mean of the group's losses is the whole sequence's mean
    (the JAX package's loss over its global hidden states), although the
    chunks hold different counts of masked positions, row by row."""
    off, length = span
    local = positions.long() - off
    weight = ((local >= 0) & (local < length)).float()
    index = local.clamp(0, length - 1)[..., None].expand(
        -1, -1, hidden.shape[-1])
    picked = torch.gather(hidden, 1, index)
    return chunk_mean(L.token_xent(T.logits(params, cfg, picked), labels),
                      weight, p)


def chunk_mean(xent, weight, p):
    """``p * sum(weight * xent) / xent.numel()``: this chunk's share of
    the mean over every masked position of the rows."""
    return p * (xent * weight).sum() / xent.numel()


def synthetic_batch(cfg, batch_size=8, seq_len=None, num_masked=4, seed=0):
    """(ids, segment_ids, mlm_positions, mlm_labels) int32 numpy arrays,
    the same values as the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    s = seq_len or min(cfg.max_len, 64)
    return (rng.randint(0, cfg.vocab, (batch_size, s)).astype(np.int32),
            rng.randint(0, 2, (batch_size, s)).astype(np.int32),
            rng.randint(0, s, (batch_size, num_masked)).astype(np.int32),
            rng.randint(0, cfg.vocab, (batch_size, num_masked)).astype(np.int32))


def tiny_fixture(seed=0, device="cuda"):
    """(params, loss_fn, batch) for tests and the driver: the JAX
    package's tiny fixture's configuration and numpy batch (bitwise), with
    params drawn from ``torch.Generator().manual_seed(seed)`` on
    ``device`` (``convert.params_from_jax`` carries the JAX package's own
    across)."""
    cfg = bert_tiny()
    params = init(cfg, torch.Generator().manual_seed(seed), device=device)
    return params, make_loss_fn(cfg), synthetic_batch(
        cfg, batch_size=8, seq_len=16, seed=seed)
