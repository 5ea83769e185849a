"""MLP and linear regression: the smallest zoo members.

Counterpart of ``autodist_tpu/models/mlp.py``, with the same param keys
(``dense<i>/{kernel,bias}``) and layouts.
"""
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.utils.device import resolve_device


def linreg_init(device="cuda"):
    """The c0 model: loss = mean((W*x + b - y)^2) with scalar W, b."""
    device = resolve_device(device)
    return {"W": torch.zeros((), device=device),
            "b": torch.zeros((), device=device)}


def linreg_loss(params, batch):
    x, y = batch
    pred = params["W"] * x + params["b"]
    return torch.mean(torch.square(pred - y))


class MLPConfig:
    def __init__(self, in_dim=32, hidden=(64, 64), num_classes=8,
                 dtype=torch.float32):
        self.in_dim = in_dim
        self.hidden = hidden
        self.num_classes = num_classes
        self.dtype = dtype


def init(cfg, generator=None, device="cuda"):
    """Float32 params drawn on the CPU from ``generator`` (default: seed
    0), then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dims = [cfg.in_dim] + list(cfg.hidden) + [cfg.num_classes]
    return {f"dense{i}": {k: t.to(device) for k, t in
                          L.dense_init(generator, d_in, d_out).items()}
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))}


def apply(params, cfg, x):
    n = len(cfg.hidden)
    for i in range(n):
        x = torch.relu(L.dense(params[f"dense{i}"], x, dtype=cfg.dtype))
    return L.dense(params[f"dense{n}"], x, dtype=torch.float32)


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        x, labels = batch
        return L.softmax_xent(apply(params, cfg, x), labels)
    return loss_fn
