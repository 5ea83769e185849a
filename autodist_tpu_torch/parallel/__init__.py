"""Parallelism beyond data parallelism: sequence (context), tensor,
expert and pipeline parallelism.

Counterpart of ``autodist_tpu/parallel/``. Ported: ring and Ulysses
attention, the parallel context, the Megatron and expert sharding rules
(``sharding_rules``), the gathers of split parameters and the neighbour
exchange (``collectives``), the mixture-of-experts layer (``moe``) and the
pipeline's re-export shim (``pipeline``; the schedule lives in
``autodist_tpu_torch.pipeline``).
"""
from autodist_tpu_torch.parallel.context import (  # noqa: F401
    ParallelContext, resolve_attn)
from autodist_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attn_fn, make_ulysses_attn_fn, ring_attention,
    ulysses_attention)
