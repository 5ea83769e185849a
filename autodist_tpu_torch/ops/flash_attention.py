"""Flash attention: the hand-written CUDA forward kernel and its plain
PyTorch version.

Counterpart of ``autodist_tpu/ops/flash_attention.py``. The Pallas
``_fwd_kernel`` becomes ``csrc/flash_fwd.cu`` (tensor-core ``mma.sync`` for
bf16 inputs, f32 FMAs for f32 inputs; built by ``ops/build.py`` and called
through ctypes); :func:`flash_fwd_reference` is the same function in plain
PyTorch, computed in f32 as the Pallas kernel computes it.
:func:`flash_fwd` launches the kernel for a CUDA tensor and runs the plain
version for any other (the CPU tests; shape-only tracing on ``meta``).

The backward pair (``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``) lands with the
training slice inside the same ``torch.autograd.Function``; ring
attention's ``block_attn_fwd`` / ``combine_blocks`` wait for sequence
parallelism (ROADMAP.md).
"""
import ctypes
import math
import threading

import torch

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}


def causal_bias(sq, sk, q_offset=0, k_offset=0, device=None):
    """Additive causal bias (0 where visible, -1e30 where masked) for an
    (sq, sk) score block whose rows/cols sit at the given global offsets."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = k_offset + torch.arange(sk, device=device)[None, :]
    return torch.where(q_pos >= k_pos, 0.0, _NEG_INF)


def flash_fwd_reference(q, k, v, causal=False, q_offset=0, k_offset=0,
                        out_dtype=None):
    """Plain PyTorch version of the kernel: (o, lse (b, h, sq, 1) f32).

    Scores, softmax and p.v all in f32 from upcast inputs (the Pallas
    kernel's ``preferred_element_type=f32`` arithmetic). A row with no
    visible key gets o = 0 and lse = -1e30.
    """
    out_dtype = out_dtype or q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s + causal_bias(q.shape[2], k.shape[2], q_offset, k_offset,
                            device=q.device)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = m + torch.log(l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    if causal:
        empty = lse <= _NEG_INF / 2
        o = torch.where(empty, 0.0, o)
        lse = torch.where(empty, _NEG_INF, lse)
    return o.to(out_dtype), lse


def _check(q, k, v, out_dtype):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd takes (batch, heads, seq, head_dim) "
                         "q/k/v")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {_HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_TAGS:
        raise ValueError(f"q/k/v must share one dtype of float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"out_dtype must be q's dtype or float32, got "
                         f"{out_dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must lie on one device")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit 65535")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd needs head_dim contiguous (stride 1) "
                         "in q/k/v")


_count_lock = threading.Lock()  # replicas launch from their own threads
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
             [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _launch(q, k, v, causal, q_offset, k_offset, out_dtype):
    from autodist_tpu_torch.ops.build import load_library
    fn = load_library("flash_fwd").autodist_flash_fwd
    # Without argtypes ctypes passes every Python int as a 32-bit int,
    # which cuts pointers and strides.
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    b, h, sq, d = q.shape
    sk = k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, h, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], int(causal), int(q_offset), int(k_offset),
                 _DTYPE_TAGS[q.dtype], _DTYPE_TAGS[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        flash_fwd.launches += 1
    return o, lse


def flash_fwd(q, k, v, causal=False, q_offset=0, k_offset=0, out_dtype=None):
    """(o (b, h, sq, d) out_dtype, lse (b, h, sq, 1) f32).

    On a CUDA tensor this launches the hand-written kernel (or raises); on
    any other tensor it runs :func:`flash_fwd_reference`. ``launches``
    counts kernel launches.
    """
    out_dtype = out_dtype or q.dtype
    _check(q, k, v, out_dtype)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, q_offset, k_offset, out_dtype)
    return flash_fwd_reference(q, k, v, causal, q_offset, k_offset, out_dtype)


flash_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        o, _ = flash_fwd(q, k, v, causal, q_offset, 0)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash-attention backward kernels land with the training slice "
            "— ROADMAP.md")


def flash_attention(q, k, v, causal=False, q_offset=0):
    """softmax(qk^T/sqrt(d) [+ causal mask]) v through the flash forward.
    q/k/v: (batch, heads, seq, head_dim); ``q_offset`` shifts q's global
    positions for causal masking."""
    return _FlashAttention.apply(q, k, v, causal, q_offset)


def make_flash_attn_fn(causal=False):
    """An ``attn_fn(q, k, v, mask)`` hook (``models.layers.mha``'s
    signature). An explicit boolean ``mask``, which the fused kernel does
    not consume, goes to the dense reference attention."""
    from autodist_tpu_torch.models import layers as L

    def attn_fn(q, k, v, mask=None):
        if mask is not None:
            return L.dot_product_attention(q, k, v, mask)
        return flash_attention(q, k, v, causal)
    return attn_fn
