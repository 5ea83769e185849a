"""Parallelism beyond data parallelism: sequence (context) and tensor
parallelism.

Counterpart of ``autodist_tpu/parallel/``. Ported: ring and Ulysses
attention, the parallel context, the Megatron sharding rules
(``sharding_rules``) and the gathers of split parameters
(``collectives``). Experts and the pipeline are not ported yet
(ROADMAP.md, Queue A item 10).
"""
from autodist_tpu_torch.parallel.context import (  # noqa: F401
    ParallelContext, resolve_attn)
from autodist_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attn_fn, make_ulysses_attn_fn, ring_attention,
    ulysses_attention)
