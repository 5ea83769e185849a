"""Kernels: hand-written CUDA sources in ``csrc/`` with plain PyTorch
versions beside them."""
