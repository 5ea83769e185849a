"""Strategy builders (AllReduce in this slice) and the compiler."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce  # noqa: F401
from autodist_tpu_torch.strategy.base import (Strategy, StrategyBuilder,  # noqa: F401
                                              StrategyCompiler)
