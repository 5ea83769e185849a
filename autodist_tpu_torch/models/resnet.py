"""ResNet family: CIFAR basic-block nets and the ImageNet bottleneck
ResNet-50.

Counterpart of ``autodist_tpu/models/resnet.py``, with the same param keys
(``stem/{conv,bn}``, ``stage<s>/block<b>/{conv1,bn1,...,proj}``, ``head``)
and layouts (HWIO conv kernels, NHWC images), bf16 compute by default and
train-mode batch norm. The convolutions are cuDNN's (``F.conv2d``): the
JAX package runs them through XLA, with no Pallas kernel.
"""
import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import tree_map


def _basic_block_init(generator, in_ch, out_ch, stride):
    p = {"conv1": L.conv_init(generator, 3, 3, in_ch, out_ch),
         "bn1": L.batchnorm_init(out_ch),
         "conv2": L.conv_init(generator, 3, 3, out_ch, out_ch),
         "bn2": L.batchnorm_init(out_ch)}
    if stride != 1 or in_ch != out_ch:
        p["proj"] = L.conv_init(generator, 1, 1, in_ch, out_ch)
    return p


def _basic_block(p, x, stride, dtype):
    y = L.conv(p["conv1"], x, stride, dtype=dtype)
    y = torch.relu(L.batchnorm(p["bn1"], y))
    y = L.batchnorm(p["bn2"], L.conv(p["conv2"], y, 1, dtype=dtype))
    sc = L.conv(p["proj"], x, stride, dtype=dtype) if "proj" in p else x
    return torch.relu(y + sc)


def _bottleneck_init(generator, in_ch, mid_ch, stride):
    out_ch = 4 * mid_ch
    p = {"conv1": L.conv_init(generator, 1, 1, in_ch, mid_ch),
         "bn1": L.batchnorm_init(mid_ch),
         "conv2": L.conv_init(generator, 3, 3, mid_ch, mid_ch),
         "bn2": L.batchnorm_init(mid_ch),
         "conv3": L.conv_init(generator, 1, 1, mid_ch, out_ch),
         "bn3": L.batchnorm_init(out_ch)}
    if stride != 1 or in_ch != out_ch:
        p["proj"] = L.conv_init(generator, 1, 1, in_ch, out_ch)
    return p


def _bottleneck(p, x, stride, dtype):
    y = torch.relu(L.batchnorm(p["bn1"], L.conv(p["conv1"], x, 1,
                                                dtype=dtype)))
    y = torch.relu(L.batchnorm(p["bn2"], L.conv(p["conv2"], y, stride,
                                                dtype=dtype)))
    y = L.batchnorm(p["bn3"], L.conv(p["conv3"], y, 1, dtype=dtype))
    sc = L.conv(p["proj"], x, stride, dtype=dtype) if "proj" in p else x
    return torch.relu(y + sc)


class ResNetConfig:
    def __init__(self, stage_sizes, width=64, bottleneck=True,
                 num_classes=1000, cifar_stem=False, dtype=torch.bfloat16):
        self.stage_sizes = stage_sizes
        self.width = width
        self.bottleneck = bottleneck
        self.num_classes = num_classes
        self.cifar_stem = cifar_stem
        self.dtype = dtype


def resnet50(num_classes=1000, dtype=torch.bfloat16):
    return ResNetConfig([3, 4, 6, 3], 64, True, num_classes, False, dtype)


def resnet18(num_classes=1000, dtype=torch.bfloat16):
    return ResNetConfig([2, 2, 2, 2], 64, False, num_classes, False, dtype)


def cifar_resnet(depth=20, num_classes=10, dtype=torch.bfloat16):
    """CIFAR-style ResNet-(6n+2): 3 stages of n basic blocks, width 16."""
    n = (depth - 2) // 6
    return ResNetConfig([n, n, n], 16, False, num_classes, True, dtype)


def init(cfg, generator=None, device="cuda", input_ch=3):
    """Float32 params drawn on the CPU from ``generator`` (default: seed 0)
    with the JAX initializers' distributions, then moved to ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    stem_k = 3 if cfg.cifar_stem else 7
    params = {"stem": {"conv": L.conv_init(generator, stem_k, stem_k,
                                           input_ch, cfg.width),
                       "bn": L.batchnorm_init(cfg.width)}}
    in_ch = cfg.width
    blk_init = _bottleneck_init if cfg.bottleneck else _basic_block_init
    for s, n_blocks in enumerate(cfg.stage_sizes):
        ch = cfg.width * (2 ** s)
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            params[f"stage{s}/block{b}"] = blk_init(generator, in_ch, ch,
                                                    stride)
            in_ch = 4 * ch if cfg.bottleneck else ch
    params["head"] = L.dense_init(generator, in_ch, cfg.num_classes)
    return tree_map(lambda t: t.to(device), params)


def apply(params, cfg, images):
    """NHWC images -> f32 logits (batch, num_classes)."""
    x = images.to(cfg.dtype)
    x = L.conv(params["stem"]["conv"], x, 1 if cfg.cifar_stem else 2,
               dtype=cfg.dtype)
    x = torch.relu(L.batchnorm(params["stem"]["bn"], x))
    if not cfg.cifar_stem:
        x = L.max_pool(x, 3, 2)
    blk = _bottleneck if cfg.bottleneck else _basic_block
    for s, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            x = blk(params[f"stage{s}/block{b}"], x, stride, cfg.dtype)
    x = x.mean(dim=(1, 2))  # global average pool, in the compute dtype
    return L.dense(params["head"], x, dtype=torch.float32)


def make_loss_fn(cfg):
    """Cross-entropy loss. batch = (images NHWC, int labels)."""
    def loss_fn(params, batch):
        images, labels = batch
        return L.softmax_xent(apply(params, cfg, images), labels)
    return loss_fn


def synthetic_batch(batch_size=64, size=224, num_classes=1000, seed=0):
    """(images f32 (batch, size, size, 3), labels int32) from
    ``np.random.RandomState(seed)``, as the JAX package's benchmark draws
    them."""
    rng = np.random.RandomState(seed)
    return (rng.randn(batch_size, size, size, 3).astype(np.float32),
            rng.randint(0, num_classes, (batch_size,)).astype(np.int32))
