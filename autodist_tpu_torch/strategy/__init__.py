"""Strategy builders, the compiler, and the ``AUTODIST_STRATEGY`` names."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce  # noqa: F401
from autodist_tpu_torch.strategy.base import (Strategy, StrategyBuilder,  # noqa: F401
                                              StrategyCompiler)
from autodist_tpu_torch.strategy.model_parallel_strategy import \
    ModelParallel  # noqa: F401
from autodist_tpu_torch.strategy.parallax_strategy import Parallax  # noqa: F401
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import \
    PartitionedAR  # noqa: F401
from autodist_tpu_torch.strategy.partitioned_ps_strategy import \
    PartitionedPS  # noqa: F401
from autodist_tpu_torch.strategy.pipeline_strategy import Pipeline  # noqa: F401
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing  # noqa: F401
from autodist_tpu_torch.strategy.ps_strategy import PS  # noqa: F401
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy \
    import RandomAxisPartitionAR  # noqa: F401
from autodist_tpu_torch.strategy.registry import builder_from_name  # noqa: F401
from autodist_tpu_torch.strategy.sequence_parallel_strategy import \
    SequenceParallel  # noqa: F401
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import \
    UnevenPartitionedPS  # noqa: F401

__all__ = ["Strategy", "StrategyBuilder", "StrategyCompiler", "PS",
           "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
           "AllReduce", "PartitionedAR", "RandomAxisPartitionAR", "Parallax",
           "SequenceParallel", "ModelParallel", "Pipeline", "builder_from_name"]
