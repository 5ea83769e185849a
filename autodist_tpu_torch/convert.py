"""Weights across the two packages.

A JAX param tree brought to the host (``jax.device_get(params)``: nested
dicts of numpy arrays) becomes the port's nested dict of tensors with the
same keys, layouts (dense kernels (in, out), embeddings (vocab, dim)) and
dtypes, and back.
"""
import numpy as np
import torch

from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import tree_map


def _to_tensor(leaf, device):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes supplies it); go
        # through the raw 16-bit pattern.
        bits = torch.from_numpy(np.array(arr, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(tree, device="cuda"):
    """JAX param tree (nested dicts of numpy arrays) -> nested dict of
    tensors on ``device``, leaf for leaf."""
    device = resolve_device(device)
    return tree_map(lambda leaf: _to_tensor(leaf, device), tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays on the host,
    dtypes kept (a bfloat16 leaf needs the ``ml_dtypes`` package, which
    gives numpy its bfloat16)."""
    def to_np(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy().copy()
    return tree_map(to_np, tree)
