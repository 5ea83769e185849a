"""Kernels: hand-written CUDA sources in ``csrc/`` with plain PyTorch
versions beside them; and ``scan_blocks``, the block-stack op a strategy
can pipeline (``ops/blocks.py``)."""
from autodist_tpu_torch.ops.blocks import scan_blocks  # noqa: F401
