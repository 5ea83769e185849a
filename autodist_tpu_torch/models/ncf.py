"""Neural Collaborative Filtering (NeuMF: GMF and MLP towers).

Counterpart of ``autodist_tpu/models/ncf.py``, with the same param keys
(``embed_{user,item}_{gmf,mlp}``, ``mlp<i>``, ``head``). The four tables
are read by row lookups, so ``GraphItem.capture`` marks them sparse-access.
"""
import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.scope import named_scope
from autodist_tpu_torch.utils.tree import tree_map


class NCFConfig:
    def __init__(self, num_users=100000, num_items=50000, gmf_dim=64,
                 mlp_dims=(128, 64, 32), dtype=torch.float32):
        self.num_users = num_users
        self.num_items = num_items
        self.gmf_dim = gmf_dim
        self.mlp_dims = mlp_dims
        self.dtype = dtype


def init(cfg, generator=None, device="cuda"):
    """Float32 params drawn on the CPU from ``generator`` (default: seed 0),
    then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    half = cfg.mlp_dims[0] // 2
    params = {
        "embed_user_gmf": L.embed_init(generator, cfg.num_users, cfg.gmf_dim,
                                       0.01),
        "embed_item_gmf": L.embed_init(generator, cfg.num_items, cfg.gmf_dim,
                                       0.01),
        "embed_user_mlp": L.embed_init(generator, cfg.num_users, half, 0.01),
        "embed_item_mlp": L.embed_init(generator, cfg.num_items, half, 0.01),
    }
    dims = list(cfg.mlp_dims)
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"mlp{i}"] = L.dense_init(generator, d_in, d_out)
    params["head"] = L.dense_init(generator, cfg.gmf_dim + dims[-1], 1)
    return tree_map(lambda t: t.to(device), params)


def apply(params, cfg, users, items):
    """One logit per (user, item) pair: (batch,) f32. Scopes mirror the
    param keys (``embed_*``, ``mlp<i>``, ``head``)."""
    with named_scope("embed_user_gmf"):
        ug = L.embed(params["embed_user_gmf"], users)
    with named_scope("embed_item_gmf"):
        gmf = ug * L.embed(params["embed_item_gmf"], items)
    with named_scope("embed_user_mlp"):
        um = L.embed(params["embed_user_mlp"], users)
    with named_scope("embed_item_mlp"):
        h = torch.cat([um, L.embed(params["embed_item_mlp"], items)], dim=-1)
    for i in range(len(cfg.mlp_dims) - 1):
        with named_scope(f"mlp{i}"):
            h = torch.relu(L.dense(params[f"mlp{i}"], h, dtype=cfg.dtype))
    with named_scope("head"):
        return L.dense(params["head"], torch.cat([gmf, h], dim=-1),
                       dtype=torch.float32)[..., 0]


def make_loss_fn(cfg):
    """Sigmoid cross-entropy. batch = (user ids, item ids, f32 labels)."""
    def loss_fn(params, batch):
        users, items, labels = batch
        return L.sigmoid_bce(apply(params, cfg, users, items), labels)
    return loss_fn


def synthetic_batch(cfg, batch_size=1024, seed=0):
    """(users int32, items int32, labels f32 in {0, 1}) from
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.num_users, (batch_size,)).astype(np.int32),
            rng.randint(0, cfg.num_items, (batch_size,)).astype(np.int32),
            rng.randint(0, 2, (batch_size,)).astype(np.float32))


def tiny_fixture(seed=0, device="cuda"):
    """(params, loss_fn, batch) for tests and the driver: the JAX
    package's tiny fixture's configuration and numpy batch (bitwise), with
    params drawn from ``torch.Generator().manual_seed(seed)`` on
    ``device`` (``convert.params_from_jax`` carries the JAX package's own
    across)."""
    cfg = NCFConfig(num_users=200, num_items=100, gmf_dim=16,
                    mlp_dims=(32, 16, 8))
    params = init(cfg, torch.Generator().manual_seed(seed), device=device)
    rng = np.random.RandomState(seed)
    batch = (rng.randint(0, cfg.num_users, (16,)).astype(np.int32),
             rng.randint(0, cfg.num_items, (16,)).astype(np.int32),
             rng.randint(0, 2, (16,)).astype(np.float32))
    return params, make_loss_fn(cfg), batch
