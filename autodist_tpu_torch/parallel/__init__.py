"""Parallelism beyond data parallelism: sequence (context) parallelism.

Counterpart of ``autodist_tpu/parallel/``. Ported: ring and Ulysses
attention and the parallel context. Tensor parallelism
(``sharding_rules``), experts and the pipeline are not ported yet
(ROADMAP.md, Queue A item 10).
"""
from autodist_tpu_torch.parallel.context import (  # noqa: F401
    ParallelContext, resolve_attn)
from autodist_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attn_fn, make_ulysses_attn_fn, ring_attention,
    ulysses_attention)
