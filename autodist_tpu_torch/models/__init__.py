"""Model zoo: functional models over nested dicts of tensors.

Counterpart of ``autodist_tpu/models/__init__.py``; every module exposes
``init(cfg, generator=None, device="cuda")`` and ``make_loss_fn``.
"""
from autodist_tpu_torch.models import (bert, bilstm, layers, lm, mlp,  # noqa: F401
                                       ncf, resnet, transformer)

ZOO = {
    "mlp": mlp,
    "resnet": resnet,
    "bert": bert,
    "lm": lm,
    "bilstm": bilstm,
    "ncf": ncf,
}
