"""Checkpoints: layout-free save/restore of the training state.

Counterpart of ``autodist_tpu/checkpoint/``: checkpoints keyed by the
*logical* variable names however the strategy stored them, so any world
(or plain numpy) can read them. ``saved_model_builder`` (an exported
apply function) is not ported yet (ROADMAP.md).
"""
from autodist_tpu_torch.checkpoint.saver import Saver, CheckpointManager  # noqa: F401
