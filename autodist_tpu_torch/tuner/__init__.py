"""Tuner: the analytic cost model and its calibration.

Counterpart of ``autodist_tpu/tuner/``, the part the observability ledgers
price with: :mod:`~autodist_tpu_torch.tuner.cost_model` (``Topology``,
``CostModel.strategy_cost`` / ``strategy_memory``) and
:mod:`~autodist_tpu_torch.tuner.calibration`. The strategy search
(``search.py``), ``AUTODIST_STRATEGY=auto`` (``auto.py``), ``serve_cost``
and the collective micro-probe come later (ROADMAP.md, A12).
"""
from autodist_tpu_torch.tuner.calibration import Calibration  # noqa: F401
from autodist_tpu_torch.tuner.cost_model import (  # noqa: F401
    CostBreakdown, CostModel, MemoryBreakdown, Topology)

__all__ = ["Calibration", "CostBreakdown", "CostModel", "MemoryBreakdown",
           "Topology"]
