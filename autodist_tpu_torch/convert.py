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


def sync_state_from_jax(tree, rank, device="cuda"):
    """A JAX ``TrainState.sync_state`` brought to the host (``{var_name:
    state}``, each leaf stacked over the data axis's devices, ``(n,) +
    shape``) -> rank ``rank``'s entries as the port's per-rank tensors on
    ``device``. Leafless entries (``()``, a stateless wire) are dropped, as
    the port keeps none. Copied into a live state with
    ``Runner._restore_sync_state``'s ``_assign_``, or compared leaf for
    leaf; the two packages can then start from the same PowerSGD ``q`` and
    the same residuals (the port's own ``q`` is a ``torch.Generator`` draw
    from the JAX seed, not the ``jax.random`` values)."""
    device = resolve_device(device)

    def row(leaf):
        return _to_tensor(np.asarray(leaf)[rank], device)
    out = {}
    for name, state in tree.items():
        if isinstance(state, (tuple, list)) and not state:
            continue
        out[name] = tree_map(row, state) if isinstance(state, dict) \
            else row(state)
    return out
