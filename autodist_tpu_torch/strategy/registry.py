"""Builder names for ``AUTODIST_STRATEGY``.

Counterpart of the name registry in ``autodist_tpu/tuner/auto.py``
(``_registry``, ``builder_from_name``): the lowercased class names of the
ported builders plus the snake_case aliases. ``auto`` (the tuner) and
``automap`` are named but not ported: they raise ``NotImplementedError``
naming their ROADMAP item.
"""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.model_parallel_strategy import ModelParallel
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
from autodist_tpu_torch.strategy.pipeline_strategy import Pipeline
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy \
    import RandomAxisPartitionAR
from autodist_tpu_torch.strategy.sequence_parallel_strategy import \
    SequenceParallel
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import \
    UnevenPartitionedPS

BUILDERS = (AllReduce, PS, PSLoadBalancing, PartitionedPS,
            UnevenPartitionedPS, PartitionedAR, RandomAxisPartitionAR,
            Parallax, SequenceParallel, ModelParallel, Pipeline)
_ALIASES = {"ps_lb": PSLoadBalancing, "all_reduce": AllReduce,
            "partitioned_ps": PartitionedPS,
            "uneven_partitioned_ps": UnevenPartitionedPS,
            "partitioned_ar": PartitionedAR,
            "random_axis_ar": RandomAxisPartitionAR,
            "sequence_parallel": SequenceParallel,
            "model_parallel": ModelParallel}
# Names the JAX package resolves that the port does not build yet.
_NOT_PORTED = {
    "auto": "the tuner (ROADMAP.md, Queue A item 12)",
    "autostrategy": "the tuner (ROADMAP.md, Queue A item 12)",
    "automap": "Automap (ROADMAP.md, Queue A item 12)",
}


def registry():
    """{name: builder class} of every name ``AUTODIST_STRATEGY`` takes."""
    out = {cls.__name__.lower(): cls for cls in BUILDERS}
    out.update(_ALIASES)
    return out


def builder_from_name(name):
    """``AUTODIST_STRATEGY`` value -> builder instance (default ctor)."""
    key = str(name).strip().lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"AUTODIST_STRATEGY={name!r}: {_NOT_PORTED[key]} is not ported "
            f"to autodist_tpu_torch yet; name a ported builder, one of "
            f"{sorted(registry())}")
    reg = registry()
    if key not in reg:
        raise ValueError(
            f"AUTODIST_STRATEGY={name!r} names no known builder; one of "
            f"{sorted(reg)}")
    return reg[key]()
