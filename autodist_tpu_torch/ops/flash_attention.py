"""Flash attention: the hand-written CUDA kernels and their plain PyTorch
versions.

Counterpart of ``autodist_tpu/ops/flash_attention.py``. The Pallas
``_fwd_kernel`` becomes ``csrc/flash_fwd.cu`` (bf16 at d = 64 / 128: a TMA
producer and ``wgmma`` consumer warpgroups; bf16 at d = 16 / 32:
``mma.sync``; f32: FMAs) and the backward pair ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` becomes ``csrc/flash_bwd.cu`` (bf16 at d = 64, and dq
at d = 128: TMA producer and ``wgmma`` consumer warpgroups, writing f32 or
bf16 gradients; bf16 at d = 16 / 32 and dk/dv at d = 128: ``mma.sync``;
f32: FMAs); built by ``ops/build.py`` and called through ctypes.
:func:`flash_fwd_reference` and :func:`flash_bwd_reference` are the same
functions in plain PyTorch, computed in f32 as the Pallas kernels compute
them. :func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
launch their kernel for a CUDA tensor and run the plain version for any
other (the CPU tests; shape-only tracing on ``meta``).
:func:`flash_attention` is the ``torch.autograd.Function`` over them, the
counterpart of the JAX package's ``custom_vjp``. Ring attention's hop
(``parallel/ring_attention.py``) runs :func:`block_attn_fwd` /
:func:`block_attn_bwd` (the same kernels at global offsets, f32 outputs)
and merges hops with :func:`combine_blocks`.
"""
import ctypes
import math

import torch

from autodist_tpu_torch.utils import cuda_graph
from autodist_tpu_torch.utils.scope import einsum

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
                        out_dtype=None, with_lowp=False):
    """Plain PyTorch version of the kernel: (o, lse (b, h, sq, 1) f32), and
    with ``with_lowp`` a third output, o rounded to q's dtype.

    Scores, softmax and p.v all in f32 from upcast inputs (the Pallas
    kernel's ``preferred_element_type=f32`` arithmetic). A row with no
    visible key gets o = 0 and lse = -1e30.
    """
    out_dtype = out_dtype or q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = s + causal_bias(q.shape[2], k.shape[2], q_offset, k_offset,
                            device=q.device)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = m + torch.log(l)
    o = einsum("bhqk,bhkd->bhqd", p, v.float()) / l
    if causal:
        empty = lse <= _NEG_INF / 2
        o = torch.where(empty, 0.0, o)
        lse = torch.where(empty, _NEG_INF, lse)
    o = o.to(out_dtype)
    if with_lowp:
        return o, lse, o.to(q.dtype)
    return o, lse


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
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd needs head_dim contiguous (stride 1) "
                         "in q/k/v")


_fns = {}  # symbol -> ctypes function with its argtypes set


def _kernel_fn(library, symbol, argtypes):
    """The library's C function, its argtypes set once. Without argtypes
    ctypes passes every Python int as a 32-bit int, which cuts pointers and
    strides."""
    fn = _fns.get(symbol)
    if fn is None:
        from autodist_tpu_torch.ops.build import load_library
        fn = getattr(load_library(library), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
                 [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5 +
                 [ctypes.c_void_p])
_TMA_HEAD_DIMS = (64, 128)  # bf16 head dims of the TMA / wgmma route


def _tma_ready(t):
    """``t`` itself when TMA can read it (16-byte aligned base, (b, h, s)
    strides positive multiples of 8 elements), else a fresh contiguous
    copy: an explicit copy, not another kernel."""
    if t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0
                                      for st in t.stride()[:3]):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _call(fn, device, *args):
    """``fn(*args, stream)`` with ``device``'s current stream, entering the
    device's context only when it is not the current one already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _launch(q, k, v, causal, q_offset, k_offset, out_dtype, with_lowp):
    fn = _kernel_fn("flash_fwd", "autodist_flash_fwd", _FWD_ARGTYPES)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype == torch.bfloat16 and d in _TMA_HEAD_DIMS:
        q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    o = torch.empty((b, h, sq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    # The kernel writes o rounded to q's dtype too when that differs from o's.
    lowp = (torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
            if with_lowp and q.dtype != out_dtype else None)
    outs = (o, lse) + ((o if lowp is None else lowp,) if with_lowp else ())
    if o.numel() == 0:
        return outs
    err = _call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), None if lowp is None else lowp.data_ptr(),
                lse.data_ptr(), b, h, sq, sk, d, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                int(causal), int(q_offset), int(k_offset),
                _DTYPE_TAGS[q.dtype], _DTYPE_TAGS[out_dtype])
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    cuda_graph.count_launch(flash_fwd)
    return outs


def flash_fwd(q, k, v, causal=False, q_offset=0, k_offset=0, out_dtype=None,
              with_lowp=False):
    """(o (b, h, sq, d) out_dtype, lse (b, h, sq, 1) f32), and with
    ``with_lowp`` a third output: o rounded to q's dtype, bitwise equal to
    ``o.to(q.dtype)`` and written by the same kernel (training saves the
    f32 o for the backward and hands the bf16 one to the model).

    On a CUDA tensor this launches the hand-written kernel (or raises); on
    any other tensor it runs :func:`flash_fwd_reference`. ``launches``
    counts kernel launches (a launch captured in a CUDA graph counts at
    each replay: ``utils/cuda_graph.py``).
    """
    out_dtype = out_dtype or q.dtype
    _check(q, k, v, out_dtype)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, q_offset, k_offset, out_dtype,
                       with_lowp)
    return flash_fwd_reference(q, k, v, causal, q_offset, k_offset, out_dtype,
                               with_lowp)


flash_fwd.launches = 0


def flash_bwd_reference(q, k, v, do, lse, delta, causal=False, q_offset=0,
                        k_offset=0):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) in f32.

    The Pallas pair's arithmetic, all in f32 from upcast inputs:
    p = exp(s - lse) with masked entries exactly 0 (so a row that sees no
    key contributes nothing; the JAX package's ``_dense_bwd`` does not mask
    and gives such a row p = 1), dp = do.v^T, ds = p (dp - delta) / sqrt(d).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        s = s + causal_bias(q.shape[2], k.shape[2], q_offset, k_offset,
                            device=q.device)
    p = torch.where(s > _NEG_INF / 2, torch.exp(s - lse), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq, dk, dv


def _bwd_inputs(q, k, v, do, lse, delta, out_dtype):
    """Check the backward's inputs against what the kernels take; returns
    ``do``, ``lse`` and ``delta`` in the layout they read."""
    _check(q, k, v, q.dtype)
    b, h, sq, d = q.shape
    if tuple(do.shape) != (b, h, sq, d) or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq, 1) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape "
                             f"{(b, h, sq, 1)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if out_dtype not in (torch.float32, q.dtype):
        raise ValueError(f"out_dtype must be float32 or q's dtype {q.dtype}, "
                         f"got {out_dtype}")
    if not all(t.device == q.device for t in (do, lse, delta)):
        raise ValueError("do/lse/delta must lie on q's device")
    # The kernels take q/k/v/do by strides but need the head dimension
    # contiguous: autograd may hand over an expanded ``do`` (stride 0), which
    # is copied. lse and delta are read as contiguous rows.
    if do.stride(-1) != 1:
        do = do.contiguous()
    return do, lse.contiguous(), delta.contiguous()


def _bwd_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset,
               out_dtype):
    """The plain version's (dq, dk, dv), in ``out_dtype``."""
    return tuple(g.to(out_dtype) for g in flash_bwd_reference(
        q, k, v, do, lse, delta, causal, q_offset, k_offset))


_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
                 [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5 +
                 [ctypes.c_void_p])


def _launch_bwd(wrapper, symbol, outs, q, k, v, do, lse, delta, causal,
                q_offset, k_offset):
    b, h, sq, d = q.shape
    if b * h * sq * k.shape[2] == 0:  # nothing to read: the outputs are 0
        for o in outs:
            o.zero_()
        return
    fn = _kernel_fn("flash_bwd", symbol,
                    _BWD_ARGTYPES[:6] + [ctypes.c_void_p] * len(outs) +
                    _BWD_ARGTYPES[6:])
    if q.dtype == torch.bfloat16 and d in _TMA_HEAD_DIMS:
        q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    err = _call(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *[o.data_ptr() for o in outs], b, h, sq, k.shape[2], d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], int(causal), int(q_offset), int(k_offset),
                _DTYPE_TAGS[q.dtype], _DTYPE_TAGS[outs[0].dtype])
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err}")
    cuda_graph.count_launch(wrapper)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, q_offset=0,
                 k_offset=0, out_dtype=torch.float32):
    """dq (b, h, sq, d) in ``out_dtype`` (float32, the ``_flash_bwd``
    contract, or q's dtype: the f32 sums rounded once to nearest even,
    bitwise the f32 result cast): the ``_bwd_dq_kernel`` counterpart.
    Launches the kernel on a CUDA tensor (or raises), else the plain
    version. ``launches`` counts kernel launches."""
    do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta, out_dtype)
    if q.device.type != "cuda":
        return _bwd_plain(q, k, v, do, lse, delta, causal, q_offset,
                          k_offset, out_dtype)[0]
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    _launch_bwd(flash_bwd_dq, "autodist_flash_bwd_dq", (dq,), q, k, v, do,
                lse, delta, causal, q_offset, k_offset)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, q_offset=0,
                  k_offset=0, out_dtype=torch.float32):
    """(dk, dv) (b, h, sk, d) in ``out_dtype`` (as :func:`flash_bwd_dq`):
    the ``_bwd_dkv_kernel`` counterpart. Launches the kernel on a CUDA
    tensor (or raises), else the plain version. ``launches`` counts kernel
    launches."""
    do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta, out_dtype)
    if q.device.type != "cuda":
        return _bwd_plain(q, k, v, do, lse, delta, causal, q_offset,
                          k_offset, out_dtype)[1:]
    dk = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    _launch_bwd(flash_bwd_dkv, "autodist_flash_bwd_dkv", (dk, dv), q, k, v,
                do, lse, delta, causal, q_offset, k_offset)
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0,
              out_dtype=torch.float32):
    """(dq, dk, dv) in ``out_dtype`` (float32 or q's dtype) from the
    forward's lse and delta = rowsum(do * o): the two backward kernels on a
    CUDA tensor, the plain version on any other."""
    if q.device.type != "cuda":
        do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta, out_dtype)
        return _bwd_plain(q, k, v, do, lse, delta, causal, q_offset,
                          k_offset, out_dtype)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, q_offset, k_offset,
                      out_dtype)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, q_offset,
                           k_offset, out_dtype)
    return dq, dk, dv


# -- ring attention's per-hop compute ---------------------------------------


def block_attn_fwd(q, k, v, causal, q_offset, k_offset):
    """One attention block: (o f32, lse f32 (b, h, sq, 1)) of the local q
    against a visiting k/v block whose rows and columns sit at the global
    offsets ``q_offset`` / ``k_offset`` (host ints: each hop is its own
    launch). The counterpart of ``autodist_tpu/ops/flash_attention.py:377``:
    the forward kernel with f32 o (one launch, counted on ``launches``) on
    a CUDA tensor, the plain version elsewhere. A row with no visible key
    gets o = 0 and lse = -1e30 (a finite sentinel :func:`combine_blocks`
    weighs as nothing), a wholly masked block included: the kernel runs it
    and writes the sentinel, it is not skipped. On the card, q/k/v the
    kernels do not take (:func:`kernel_takes`) raise, as
    :func:`flash_fwd` does; off the card they go to the plain version, as
    the JAX package sends them to its dense path."""
    if q.device.type != "cuda" and not kernel_takes(q, k, v):
        return flash_fwd_reference(q, k, v, causal, q_offset, k_offset,
                                   torch.float32)
    out = flash_fwd(q, k, v, causal, q_offset, k_offset,
                    out_dtype=torch.float32)
    if q.device.type == "cuda":
        cuda_graph.count_launch(block_attn_fwd)
    return out


def block_attn_bwd(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """One block's (dq, dk, dv) in f32 against the GLOBAL lse and delta
    (FlashAttention-2's cross-block form: p = exp(s - lse) are the true
    probabilities though the block is one hop of a longer ring), the
    counterpart of ``autodist_tpu/ops/flash_attention.py:397``: the two
    backward kernels with f32 gradients on a CUDA tensor (``launches``
    counts one per call, i.e. per hop: a dq and a dk/dv launch), the plain
    version elsewhere. A masked entry contributes exactly 0. q/k/v the
    kernels do not take raise on the card, as in :func:`block_attn_fwd`."""
    if q.device.type != "cuda" and not kernel_takes(q, k, v):
        return flash_bwd_reference(q, k, v, do.to(q.dtype), lse, delta,
                                   causal, q_offset, k_offset)
    out = flash_bwd(q, k, v, do, lse, delta, causal, q_offset, k_offset,
                    out_dtype=torch.float32)
    if q.device.type == "cuda":
        cuda_graph.count_launch(block_attn_bwd)
    return out


block_attn_fwd.launches = 0
block_attn_bwd.launches = 0


def combine_blocks(o_a, lse_a, o_b, lse_b):
    """Merge two finalized attention partials (o, lse) -> (o, lse) by
    log-sum-exp reweighting (``autodist_tpu/ops/flash_attention.py:408``).
    An empty partial (lse = -1e30) gets weight ~0 with no NaN path: the
    sentinel is finite."""
    lse = torch.logaddexp(lse_a, lse_b)
    return o_a * torch.exp(lse_a - lse) + o_b * torch.exp(lse_b - lse), lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        # The f32 output is saved for delta; the caller gets q's dtype,
        # written by the same kernel launch (no cast afterwards).
        o, lse, out = flash_fwd(q, k, v, causal, q_offset, 0,
                                out_dtype=torch.float32, with_lowp=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(do * o) outside the kernels, in f32, as the JAX
        # package's _bwd_rule, but from the f32 output: each row of ds then
        # sums to 0 to f32 accuracy, which dq and dk need (a bf16 o breaks
        # that cancellation: ROADMAP.md, Queue C).
        # do * o computes in f32 (do upcast inside the one kernel). The
        # kernels write the gradients in q's dtype (q, k and v share it):
        # no cast runs after them.
        do = do.to(q.dtype)
        delta = (do * o).sum(-1, keepdim=True)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, ctx.causal,
                               ctx.q_offset, 0, out_dtype=q.dtype)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, q_offset=0):
    """softmax(qk^T/sqrt(d) [+ causal mask]) v, fused forward and backward.
    q/k/v: (batch, heads, seq, head_dim); ``q_offset`` shifts q's global
    positions for causal masking. With no gradient to take (inference, or
    no input requiring one) this is the forward kernel alone, writing q's
    dtype directly."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset)
    return flash_fwd(q, k, v, causal, q_offset, 0)[0]


def kernel_takes(q, k, v):
    """Whether the kernels take these q/k/v: a head dim of
    ``_HEAD_DIMS`` and one dtype of float32 / bfloat16. Decided from shape
    and dtype alone, before any call."""
    return (q.shape[-1] in _HEAD_DIMS and q.dtype in _DTYPE_TAGS and
            q.dtype == k.dtype == v.dtype)


def make_flash_attn_fn(causal=False):
    """An ``attn_fn(q, k, v, mask)`` hook (``models.layers.mha``'s
    signature). An explicit boolean ``mask``, which the fused kernel does
    not consume, goes to the dense reference attention, and so do q/k/v
    the kernels do not take (:func:`kernel_takes`; a causal model then
    gets the causal mask), as the JAX package's hook sends shapes its
    kernel does not take to its dense reference. Everything else goes to
    the kernel, and a kernel that fails raises."""
    from autodist_tpu_torch.models import layers as L

    def attn_fn(q, k, v, mask=None):
        if mask is None and kernel_takes(q, k, v):
            return flash_attention(q, k, v, causal)
        if mask is None and causal:
            mask = L.causal_mask(q.shape[2], device=q.device)
        return L.dot_product_attention(q, k, v, mask)
    return attn_fn
