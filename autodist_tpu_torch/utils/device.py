"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device present they raise instead of carrying on on the CPU.
"""
import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises ``RuntimeError`` when a CUDA
    device is asked for (the default) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available, so device {str(dev)!r} cannot be used; "
            f"pass device='cpu' to run on the CPU")
    return dev
