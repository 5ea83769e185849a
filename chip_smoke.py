"""Drive the PyTorch / CUDA port (``autodist_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no final ``ok`` line):

0. device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, turns TF32 off for float32 products;
1. build: compiles every kernel of the port from ``autodist_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) into the git-ignored ``build/``
   directory, prints the seconds and each kernel's registers and spills
   (``ptxas -v``; a TMA / wgmma kernel must spill nothing), and checks with
   ``cuobjdump -sass`` that every TMA / wgmma instantiation (the forward at
   d = 64 and 128; the backward's dq at d = 64 and 128 and dk/dv at d = 64,
   each with f32 and bf16 outputs) holds HGMMA and UTMALDG instructions;
2. kernels: each kernel against its plain PyTorch version on the card
   (the flash-attention forward, and the backward pair ``flash_bwd_dq`` /
   ``flash_bwd_dkv``), at the serving and training paths' shapes and at
   the causal / offset / ragged / float32 / d = 128 / strided cases; every
   call repeated must be bitwise identical, the training variant's bf16 o
   must be its own f32 o cast to bf16, bitwise, every backward case also
   runs with gradients in q's dtype, which must be its f32 gradients cast,
   bitwise, and rows with no visible key give exactly 0; then times each
   kernel (the backward with f32 and with bf16 outputs, each against its
   own bound), its plain version, the
   PyTorch library call that computes the same function (yardstick only,
   never called by the port; its kernels are printed) and the card's
   bound, and times the same way the routes off the main path (bf16
   d = 32 on ``mma.sync``, f32 on FMAs, the dk/dv ``mma.sync`` kernel at
   bf16 d = 128) at one shape each. Times are device time per call from
   ``torch.profiler`` over 20 back-to-back calls, with the host-inclusive
   time per call (CUDA events around 20 calls) beside them;
3. serving: the port's ``serve.Server`` on BERT-base (seeded random
   weights, full width, 12 layers, seq 512) answers concurrent requests
   from four client threads; every answer is held against the port's own
   forward with the plain attention, a repeated request must be bitwise
   identical, and the launch counts show every layer of every dispatch ran
   the forward kernel;
4. training: BERT-base MLM pretraining (full width and depth, batch 32 x
   seq 128, 20 masked positions, Adam 1e-4, bf16 compute, f32 master
   weights) takes 20 ``Runner.step``s through ``AutoDist(AllReduce())`` on
   a one-rank NCCL world. Step 1 is held against the same step with the
   plain attention; every loss is finite and the last below the first;
   every param changes in step 1; each of the three kernels launches
   exactly 12 x 20 times; a repeated attention backward at a layer's own
   inputs is bitwise identical; one training attention forward launches
   one kernel and nothing else (no cast of o), and its backward each
   backward kernel once and no cast (the kernels write the bf16
   gradients). Prints the median step time, samples/s and a profiled step
   (12 launches of each flash kernel in it; its f32 -> bf16 cast count);
5. the model zoo: ResNet-50 (batch 64 x 224 x 224 x 3, 1000 classes, SGD
   1e-3, ``AutoDist(AllReduce(chunk_size=128))``, the JAX package's
   headline benchmark) takes 20 steps of ``make_callable``'s step, once
   with the model's bf16 compute and once under ``precision="bf16"``;
   step 1 is held against the same model computing in f32, every loss is
   finite and the last below the first, every param changes. Prints the
   median step time, images/s, a profiled step (device-busy share, top
   kernels, layout-transpose kernels), ``flops_estimate()`` and the model
   FLOP/s against the bf16 peak. BiLSTM and NCF at the JAX package's
   default widths take a few steps (finite, falling losses; NCF's four
   tables sparse-access). No flash kernel launches in this phase;
6. output: one ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import copy
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Kernel vs plain version: a bf16 o at these (bf16 output rounds at 2^-8
# relative), lse at an absolute 1e-4 (both sum f32 products of the same
# inputs, in another order).
O_ATOL, O_RTOL, LSE_ATOL = 1.6e-2, 1e-2, 1e-4
# An f32 o (the training path's call) at this absolute error: bf16 inputs
# carry P into P.V as a bf16 pair (hi + residual, ~16 bits), which read
# 4.5e-6 on the card; P rounded once to bf16 reads ~1.5e-3 at the training
# shape, and the phase requires that reading above this limit.
O_F32_ATOL = 5e-5
# Served answers vs the port's forward on the request's rows alone with the
# plain attention: twelve bf16 layers, other matmul shapes (the bucket's
# padded rows) and another summation order inside attention.
SERVE_ATOL, SERVE_RTOL = 5e-2, 5e-2
# Backward kernels vs plain version, relative to the largest |gradient|.
# bf16 inputs carry ds as a bf16 pair (~2^-17) into ds.k and ds^T.q (dq,
# dk: read at most 6.6e-6 on the card; ds rounded once reads ~2e-3, which
# the phase requires above the limit) and round p once to bf16 (2^-9
# relative) before p^T.do (dv), with f32 accumulation; the plain version
# keeps everything in f32. f32 inputs differ only in summation order.
BWD_REL_DQDK_BF16, BWD_REL_DV_BF16, BWD_REL_F32 = 1e-4, 1e-2, 1e-5
# Training step 1, kernels vs the plain attention (autograd through the
# plain forward), both in the bf16-compute model: |loss difference| (the
# loss is ~10.3), the relative difference of the global grad norm, and for
# each attention q/k/v projection kernel max|grad difference| relative to
# its max |grad|. The two paths round to bf16 at different places; at this
# initialization the q/k projection gradients are ~1e-5 against ~1e-3 for
# the rest, so both bf16 paths sit a few percent (of the max) off the same
# step in an f32-compute model, which the phase prints. Hence 1e-1 for the
# two apart, and the kernel path no further from the f32 model than 1.5x
# the plain path.
TRAIN_LOSS_ATOL, TRAIN_NORM_RTOL, TRAIN_LEAF_REL = 1e-3, 5e-3, 1e-1
TRAIN_F32_RATIO = 1.5
# The H100 SXM's published peaks (NVIDIA data sheet, dense): bf16 tensor
# cores, f32 outside the tensor cores (the FMA kernels), memory.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Phase 5, step 1 of ResNet-50 (bf16 compute) against the same step of the
# model computing in f32: the loss within 1e-2 relative, and the whole
# gradient (all leaves as one vector) at cosine >= ZOO_GRAD_COS and
# |g - g_f32| / |g_f32| <= ZOO_GRAD_REL. Not leaf by leaf: through a deep
# ResNet's batch norms the bf16 gradient drifts far from the f32 one in the
# JAX package too, and the port drifts as far (the gradient-gap test in
# tests/test_torch_models.py: CIFAR ResNet-20, cosine 0.978 and relative L2
# 0.211 in the JAX package, 0.979 and 0.206 in the port). At batch 64 x
# 224^2 on an H100 80GB HBM3 (700 W) this phase read cosine 0.938 and
# relative L2 0.353, both precisions, with the median leaf 0.64 of its max
# off; the limits keep ~0.09 / ~0.15 of room.
ZOO_LOSS_RTOL, ZOO_GRAD_COS, ZOO_GRAD_REL = 1e-2, 0.85, 0.5
# cuDNN's layout-transpose kernels, as the profiler names them: one around a
# conv means its activation and kernel reached it in different formats.
TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw")
# Phase 5's profiled step by kind of kernel, first match wins (cuDNN's and
# cuBLAS's kernel names carry these; everything else is "other").
KERNEL_GROUPS = (("batch norm", ("batch_norm",)),
                 ("conv / matmul", ("conv", "xmma", "implicit_gemm", "fprop",
                                    "dgrad", "wgrad", "cudnn", "cutlass",
                                    "nvjet", "gemm", "sm90_")),
                 ("optimizer", ("multi_tensor", "foreach")),
                 ("copy / cast", ("copy", "Cat")))
# (b, h, sq, sk, d) of BERT-base's attention at the training run's batch 32
# x seq 128, and at serving's bucket 8 x seq 512.
TRAIN_SHAPE = (32, 12, 128, 128, 64)
SERVE_SHAPE = (8, 12, 512, 512, 64)
# Back-to-back calls per timing (profiler and events alike), and profiles
# taken before a window with no device time fails the run.
TIMED_CALLS = 20
PROFILE_ATTEMPTS = 3
# PyTorch's f32 -> bf16 cast kernel, as the profiler names it.
CAST_KERNEL = "bfloat16_copy_kernel"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(lines, "nvidia-smi reported no card")
    return lines[0]


def _device_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _device_events(prof):
    """The profile's device activity by name: kernels, copies and memsets.
    A ``record_function`` range mirrored on the device timeline (the
    optimizer's ``Optimizer.step#...``) spans kernels already counted, so
    it is left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0 and
            not getattr(e, "is_user_annotation", False)]


def timed(torch, fn, n=TIMED_CALLS, warmup=3):
    """Times one call of ``fn`` on the card, after ``warmup`` calls.

    ``ms``: device time, from ``torch.profiler`` over ``n`` back-to-back
    calls: for every kernel the calls launched, its mean device time per
    launch times its launches per call, summed (``kernels``: {kernel name:
    launches recorded per call}; a profile can drop events, which shows as
    a fraction there and leaves the per-launch mean intact). A run whose
    profile holds no device time is taken again (a whole window can come
    back empty), up to ``PROFILE_ATTEMPTS`` times, then fails: there is no
    fallback to host clocks. ``host_ms``: CUDA events around another ``n`` back-to-back
    calls, over ``n``; it includes what the call does on the host before
    its kernels reach the stream, and is the call's cost where the host
    cannot run ahead of the card.
    """
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        total = sum(_device_us(e) / e.count * max(1, round(e.count / n))
                    for e in events)
        if total > 0:
            break
        print(f"  (profile {attempt + 1} of {PROFILE_ATTEMPTS} held no device "
              f"time; profiling again)", flush=True)
    check(total > 0, "torch.profiler recorded no device time: the kernels "
          "cannot be timed on the device")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return {"ms": total / 1e3, "host_ms": start.elapsed_time(end) / n,
            "kernels": {e.key: e.count / n for e in events}}


def kernel_names(t):
    return ", ".join(f"{name[:70]} x{count:g}"
                     for name, count in t["kernels"].items())


def attention_work(q, k, v, *outs):
    """(operations, bytes) of one non-causal call: 4 flops per (q, k) pair
    and head-dim element; each input read once, each output (o, lse and
    any second o) written once."""
    b, h, sq, d = q.shape
    flops = 4.0 * b * h * sq * k.shape[2] * d
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, *outs))
    return flops, nbytes


def fwd_p_rounded_once(torch, q, k, v):
    """The plain forward (f32 o) with P rounded once to bf16 before P.V:
    what a kernel without P's residual term would give."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    p =torch.exp(s - s.amax(-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                        v.float()) / p.sum(-1, keepdim=True)


def bwd_ds_rounded_once(torch, q, k, v, do, lse, delta):
    """The plain (dq, dk) with ds rounded once to bf16 before ds.k and
    ds^T.q: what the kernels without ds's residual term would give."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (torch.exp(s - lse) * (dp - delta) * scale).bfloat16().float()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float()))


def kernel_phase(torch, fa):
    """Phase 2: flash_fwd vs flash_fwd_reference on the card, then its
    times beside the plain version's, SDPA's and the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, sq, sk, d, dtype):
        return [torch.randn((b, h, s, d), generator=gen, device=dev,
                            dtype=dtype) for s in (sq, sk, sk)]

    errs = {"o": 0.0, "lse": 0.0}

    def compare(name, q, k, v, causal=False, q_offset=0, k_offset=0,
                out_dtype=None, all_empty=False, with_lowp=False):
        got = fa.flash_fwd(q, k, v, causal, q_offset, k_offset, out_dtype,
                           with_lowp)
        again = fa.flash_fwd(q, k, v, causal, q_offset, k_offset, out_dtype,
                             with_lowp)
        torch.cuda.synchronize()
        o, lse = got[:2]
        ro, rl = fa.flash_fwd_reference(q, k, v, causal, q_offset, k_offset,
                                        out_dtype)
        check(o.dtype == ro.dtype and o.shape == ro.shape and
              lse.shape == rl.shape, f"{name}: output dtype/shape differ")
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite output")
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        line = (f"  {name}: max|o-o_plain| {err_o:.3e}  max|lse-lse_plain| "
                f"{err_l:.3e}, repeat bitwise")
        atol, rtol = ((O_F32_ATOL, 0.0) if o.dtype == torch.float32
                      else (O_ATOL, O_RTOL))
        check(torch.allclose(o.float(), ro.float(), atol=atol, rtol=rtol),
              f"{name}: o differs from the plain version by {err_o} "
              f"(atol {atol}, rtol {rtol})")
        check(torch.allclose(lse, rl, atol=LSE_ATOL, rtol=0),
              f"{name}: lse differs from the plain version by {err_l}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: a repeated call is not bitwise identical")
        if with_lowp:
            check(got[2].dtype == q.dtype and
                  torch.equal(got[2], o.to(q.dtype)),
                  f"{name}: the kernel's {q.dtype} o is not its f32 o cast")
            line += f"; its {str(q.dtype)[6:]} o == its f32 o cast, bitwise"
        if all_empty:
            check(bool((o == 0).all()) and bool((lse == -1e30).all()),
                  f"{name}: rows with no visible key must give o == 0 and "
                  f"lse == -1e30")
        print(line, flush=True)
        errs["o"] = max(errs["o"], err_o)
        errs["lse"] = max(errs["lse"], err_l)
        return o, lse

    bf16, f32 = torch.bfloat16, torch.float32
    print(f"phase 2: flash_fwd kernel vs its plain version (bf16 o: atol "
          f"{O_ATOL}, rtol {O_RTOL}; f32 o: atol {O_F32_ATOL}; every call "
          f"repeated)", flush=True)
    qa, ka, va = qkv(*SERVE_SHAPE, bf16)
    compare("(a) bert-base b8 h12 s512 d64 bf16", qa, ka, va)
    q, k, v = qkv(4, 16, 1024, 1024, 64, bf16)
    compare("(b) lm1b b4 h16 s1024 d64 bf16 causal", q, k, v, causal=True)
    q, k, v = qkv(2, 12, 512, 512, 64, bf16)
    compare("(c) offsets (512, 1024) causal: every row empty", q, k, v,
            causal=True, q_offset=512, k_offset=1024, all_empty=True)
    compare("(c) offsets (1024, 512) causal: every key visible", q, k, v,
            causal=True, q_offset=1024, k_offset=512)
    compare("(c) bf16 in, f32 out, causal", q, k, v, causal=True,
            out_dtype=f32)
    qt, kt, vt = qkv(*TRAIN_SHAPE, bf16)
    o_t, _ = compare("(t) training b32 h12 s128 d64 bf16 in, f32 + bf16 "
                     "out", qt, kt, vt, out_dtype=f32, with_lowp=True)
    ro_t = fa.flash_fwd_reference(qt, kt, vt, out_dtype=f32)[0]
    once = (fwd_p_rounded_once(torch, qt, kt, vt) - ro_t).abs().max().item()
    print(f"  (t) with P rounded once to bf16 the plain version reads "
          f"{once:.3e} (the kernel {(o_t - ro_t).abs().max().item():.3e}, "
          f"atol {O_F32_ATOL})", flush=True)
    check(once > O_F32_ATOL, f"the f32-output tolerance {O_F32_ATOL} would "
          f"pass a kernel rounding P once ({once})")
    del ro_t
    for d in (16, 32, 128):
        q, k, v = qkv(2, 3, 200, 200, d, f32)
        compare(f"(d) f32 s200 d{d}", q, k, v)
        compare(f"(d) f32 s200 d{d} causal", q, k, v, causal=True)
    q, k, v = qkv(2, 3, 200, 200, 128, bf16)
    compare("(e) bf16 d128 s200 causal (ragged)", q, k, v, causal=True)
    q, k, v = qkv(2, 3, 200, 333, 128, bf16)
    compare("(e) bf16 d128 sq200 sk333 causal q_offset 100", q, k, v,
            causal=True, q_offset=100)
    q, k, v = qkv(2, 4, 300, 300, 128, bf16)
    compare("(e) bf16 d128 s300 f32 + bf16 out", q, k, v, out_dtype=f32,
            with_lowp=True)
    for d in (16, 32):
        q, k, v = qkv(2, 3, 200, 200, d, bf16)
        compare(f"(e) bf16 d{d} s200 causal f32 + bf16 out (mma.sync)", q, k,
                v, causal=True, out_dtype=f32, with_lowp=True)
    x = torch.randn((4, 256, 3 * 768), generator=gen, device=dev, dtype=bf16)
    q, k, v = [t.reshape(4, 256, 12, 64).transpose(1, 2)
               for t in x.split(768, -1)]
    compare("(f) the model's layout: (b, h, s, d) views of (b, s, h, d) "
            "memory, causal", q, k, v, causal=True)
    buf = torch.randn((2, 3, 100, 65), generator=gen, device=dev, dtype=bf16)
    compare("(f) rows 65 elements apart (copied for TMA)", buf[..., 1:],
            buf[..., 1:], buf[..., 1:])

    def timings(q, k, v, label, **kw):
        out = fa.flash_fwd(q, k, v, **kw)
        flops, nbytes = attention_work(q, k, v, *out)
        bound_ms, bound_by = bound(flops, nbytes)
        kern = timed(torch, lambda: fa.flash_fwd(q, k, v, **kw))
        plain = timed(torch, lambda: fa.flash_fwd_reference(q, k, v, **kw))
        lib = timed(torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(q, k, v))
        lib2 = timed(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(q, k, v))
        check(all("flash_fwd" in name for name in kern["kernels"]),
              f"flash_fwd at {label} launched {kernel_names(kern)}")
        kinds = " + ".join(str(t.dtype)[6:] for t in (out[0], *out[2:]))
        print(f"  timing at {label} ({kinds} o), device ms per call (profiler, {TIMED_CALLS} calls) / host-"
              f"inclusive ms per call (events around {TIMED_CALLS} calls): "
              f"kernel {kern['ms']:.4f} / {kern['host_ms']:.4f}, plain "
              f"{plain['ms']:.4f} / {plain['host_ms']:.4f}, SDPA "
              f"{lib['ms']:.4f} / {lib['host_ms']:.4f} (again: "
              f"{lib2['ms']:.4f} / {lib2['host_ms']:.4f}); bound "
              f"{bound_ms:.4f} ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB); kernel / SDPA device "
              f"{kern['ms'] / lib['ms']:.2f}x, bound / kernel "
              f"{bound_ms / kern['ms']:.3f}", flush=True)
        print(f"    launches recorded per call: {kernel_names(kern)}; SDPA's: "
              f"{kernel_names(lib)}", flush=True)
        return {"ms": kern["ms"], "host_ms": kern["host_ms"],
                "plain_ms": plain["ms"], "plain_host_ms": plain["host_ms"],
                "library_ms": lib["ms"], "library_host_ms": lib["host_ms"],
                "library_ms_again": lib2["ms"],
                "library_kernels": list(lib["kernels"]),
                "bound_ms": bound_ms, "bound_by": bound_by}, out

    at_a, _ = timings(qa, ka, va, "(a)")
    # Training's call: f32 o (saved for the backward) and the model's bf16 o
    # from one launch. The cast it replaced is timed once for the record.
    at_t, out_t = timings(qt, kt, vt, "the training shape (t)",
                          out_dtype=f32, with_lowp=True)
    cast = timed(torch, lambda: out_t[0].to(bf16))
    print(f"  a separate cast of the f32 o at (t) to bf16 (no longer run): "
          f"device {cast['ms']:.4f} ms, host-inclusive {cast['host_ms']:.4f}"
          f" ms; {kernel_names(cast)}", flush=True)
    record = {"name": "flash_fwd", "route": "cuda",
              "source": "autodist_tpu_torch/csrc/flash_fwd.cu",
              "replaces": "autodist_tpu/ops/flash_attention.py:101",
              "tpu_kernel": "_fwd_kernel",
              "design": "bf16 d64/128: persistent, TMA producer warp + two "
                        "wgmma consumer warpgroups, 2-stage K/V ring",
              "shape": list(SERVE_SHAPE[:3]) + [SERVE_SHAPE[4]],
              "max_abs_err": errs["o"], "max_err_o": errs["o"],
              "max_err_lse": errs["lse"],
              "timing": f"ms: device time per call (torch.profiler, "
                        f"{TIMED_CALLS} back-to-back calls after 3 warm-ups)"
                        f"; host_ms: CUDA events around {TIMED_CALLS} "
                        f"calls, over {TIMED_CALLS}",
              "train_shape": list(TRAIN_SHAPE[:3]) + [TRAIN_SHAPE[4]],
              "train_outputs": "float32 o + bfloat16 o",
              "train_cast_ms": cast["ms"]}
    record.update(at_a)
    record.update({"train_" + key: val for key, val in at_t.items()})
    return record


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the operations at ``peak`` (the bf16 tensor-core peak unless given) vs
    the bytes at the memory rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def backward_phase(torch, fa):
    """Phase 2, backward: flash_bwd_dq / flash_bwd_dkv vs
    flash_bwd_reference on the card, with f32 and q-dtype outputs; returns
    their two records."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {"dq": 0.0, "dkv": 0.0}

    def inputs(b, h, sq, sk, d, dtype, causal=False, q_offset=0,
               k_offset=0):
        q, k, v = [torch.randn((b, h, s, d), generator=gen, device=dev,
                               dtype=dtype) for s in (sq, sk, sk)]
        do = torch.randn((b, h, sq, d), generator=gen, device=dev,
                         dtype=dtype)
        o, lse = fa.flash_fwd(q, k, v, causal, q_offset, k_offset)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        return q, k, v, do, lse, delta

    def grads(args, extra, out_dtype):
        return (fa.flash_bwd_dq(*args, *extra, out_dtype=out_dtype),
                *fa.flash_bwd_dkv(*args, *extra, out_dtype=out_dtype))

    def compare(name, shape, dtype, causal=False, q_offset=0, k_offset=0,
                all_empty=False):
        args = inputs(*shape, dtype, causal, q_offset, k_offset)
        extra = (causal, q_offset, k_offset)
        got, again = grads(args, extra, f32), grads(args, extra, f32)
        low, low_again = grads(args, extra, dtype), grads(args, extra, dtype)
        torch.cuda.synchronize()
        ref = fa.flash_bwd_reference(*args, *extra)
        line = []
        for label, g, want in zip(("dq", "dk", "dv"), got, ref):
            tol = (BWD_REL_F32 if dtype == f32 else BWD_REL_DV_BF16
                   if label == "dv" else BWD_REL_DQDK_BF16)
            check(g.dtype == torch.float32 and g.shape == want.shape,
                  f"{name}: {label} dtype/shape differ")
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite "
                  f"{label}")
            err = (g - want).abs().max().item()
            scale = want.abs().max().item()
            line.append(f"{label} {err:.3e} (max {scale:.3e})")
            check(err <= tol * scale, f"{name}: {label} differs from the "
                  f"plain version by {err} (> {tol} x {scale})")
            key = "dq" if label == "dq" else "dkv"
            errs[key] = max(errs[key], err)
        check(all(torch.equal(a, b) for a, b in zip(got, again)) and
              all(torch.equal(a, b) for a, b in zip(low, low_again)),
              f"{name}: a repeated backward is not bitwise identical")
        check(all(lo.dtype == dtype and torch.equal(lo, g.to(dtype))
                  for lo, g in zip(low, got)),
              f"{name}: the {dtype} gradients are not the f32 ones cast")
        line.append(f"{str(dtype)[6:]} outputs == f32 outputs cast, bitwise")
        if all_empty:
            check(all(bool((g == 0).all()) for g in (*got, *low)),
                  f"{name}: rows with no visible key must give exactly 0")
            line.append("all exactly 0")
        print(f"  {name}: max|kernel-plain| " + ", ".join(line), flush=True)
        return args

    print("phase 2: flash_bwd_dq / flash_bwd_dkv kernels vs their plain "
          f"version (relative to max |grad|: bf16 dq, dk {BWD_REL_DQDK_BF16},"
          f" dv {BWD_REL_DV_BF16}; f32 {BWD_REL_F32}; every case also with "
          f"outputs in q's dtype, which must be the f32 outputs cast; "
          f"repeats bitwise)", flush=True)
    a = compare("(a) bert-base b8 h12 s512 d64 bf16", SERVE_SHAPE, bf16)
    t = compare("(t) training b32 h12 s128 d64 bf16", TRAIN_SHAPE, bf16)
    ref_t = fa.flash_bwd_reference(*t)
    once = [((a - r).abs().max() / r.abs().max()).item()
            for a, r in zip(bwd_ds_rounded_once(torch, *t), ref_t)]
    print(f"  (t) with ds rounded once to bf16 the plain version reads dq "
          f"{once[0]:.3e}, dk {once[1]:.3e} of the max (limit "
          f"{BWD_REL_DQDK_BF16})", flush=True)
    check(min(once) > BWD_REL_DQDK_BF16, f"the dq/dk tolerance "
          f"{BWD_REL_DQDK_BF16} would pass kernels rounding ds once ({once})")
    del ref_t
    compare("(b) lm1b b4 h16 s1024 d64 bf16 causal", (4, 16, 1024, 1024, 64),
            bf16, causal=True)
    compare("(c) offsets (512, 1024) causal: every row empty",
            (2, 12, 512, 512, 64), bf16, True, 512, 1024, all_empty=True)
    compare("(c) offsets (1024, 512) causal: every key visible",
            (2, 12, 512, 512, 64), bf16, True, 1024, 512)
    compare("(c) offsets (0, 200) causal f32: every row empty",
            (1, 2, 100, 70, 32), f32, True, 0, 200, all_empty=True)
    compare("(c) sq 200 sk 333 causal q_offset 150, ragged, d64 bf16",
            (2, 3, 200, 333, 64), bf16, True, 150, 0)
    for d in (16, 32, 128):
        compare(f"(d) f32 s200 d{d}", (2, 3, 200, 200, d), f32)
        compare(f"(d) f32 s200 d{d} causal", (2, 3, 200, 200, d), f32,
                causal=True)
        compare(f"(d) bf16 s200 d{d} causal", (2, 3, 200, 200, d), bf16,
                causal=True)
    compare("(d) bf16 sq333 sk200 d128 (dq on the TMA route, ragged)",
            (2, 3, 333, 200, 128), bf16)

    def timings(args, label):
        q, k, v, do, lse, delta = args
        b, h, sq, d = q.shape
        pairs = float(b * h * sq * k.shape[2] * d)
        ins = sum(x.numel() * x.element_size()
                  for x in (q, k, v, do, lse, delta))
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        lib, lib2 = [timed(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True)) for _ in range(2)]
        rows = {}
        for dtype in (f32, q.dtype):
            size = torch.tensor([], dtype=dtype).element_size()
            dq = timed(torch, lambda: fa.flash_bwd_dq(*args, out_dtype=dtype))
            dkv = timed(torch, lambda: fa.flash_bwd_dkv(*args,
                                                        out_dtype=dtype))
            plain = timed(torch, lambda: [g.to(dtype) for g in
                                          fa.flash_bwd_reference(*args)])
            check(all("flash_bwd_dq_wgmma" in n for n in dq["kernels"]) and
                  all("flash_bwd_dkv_wgmma" in n for n in dkv["kernels"]),
                  f"the backward kernels at {label} launched "
                  f"{kernel_names(dq)}; {kernel_names(dkv)}")
            dq_bound = bound(6 * pairs, ins + q.numel() * size)
            dkv_bound = bound(8 * pairs, ins + 2 * k.numel() * size)
            kind = str(dtype)[6:]
            print(f"  timing at {label}, {kind} outputs, device ms per call "
                  f"(profiler, {TIMED_CALLS} calls) / host-inclusive ms per "
                  f"call (events around {TIMED_CALLS} calls): dq kernel "
                  f"{dq['ms']:.4f} / {dq['host_ms']:.4f} (bound "
                  f"{dq_bound[0]:.4f}, {dq_bound[1]}; bound / kernel "
                  f"{dq_bound[0] / dq['ms']:.3f}), dkv kernel "
                  f"{dkv['ms']:.4f} / {dkv['host_ms']:.4f} (bound "
                  f"{dkv_bound[0]:.4f}, {dkv_bound[1]}; bound / kernel "
                  f"{dkv_bound[0] / dkv['ms']:.3f}), plain backward "
                  f"{plain['ms']:.4f} / {plain['host_ms']:.4f}, SDPA "
                  f"backward (dq, dk, dv together, bf16) {lib['ms']:.4f} / "
                  f"{lib['host_ms']:.4f} (again: {lib2['ms']:.4f} / "
                  f"{lib2['host_ms']:.4f}); the pair / SDPA backward device "
                  f"{(dq['ms'] + dkv['ms']) / lib['ms']:.2f}x", flush=True)
            print(f"    launches recorded per call: {kernel_names(dq)}; "
                  f"{kernel_names(dkv)}", flush=True)
            rows[kind] = [
                {"ms": r["ms"], "host_ms": r["host_ms"],
                 "plain_ms": plain["ms"], "plain_host_ms": plain["host_ms"],
                 "library_ms": lib["ms"], "library_host_ms": lib["host_ms"],
                 "library_ms_again": lib2["ms"],
                 "bound_ms": bnd[0], "bound_by": bnd[1]}
                for r, bnd in ((dq, dq_bound), (dkv, dkv_bound))]
        print(f"    SDPA backward's launches: {kernel_names(lib)}",
              flush=True)
        for row in rows.values():
            for r in row:
                r["library_kernels"] = list(lib["kernels"])
        return rows

    at_a = timings(a, "(a)")
    at_t = timings(t, "the training shape (t)")
    records = []
    designs = (
        "bf16 d64/128: persistent, TMA producer warp, 2-stage K/V ring; "
        "items of 128 q rows, 2 wgmma consumer warpgroups x 64 rows: SS "
        "wgmma S and dP, RS wgmma dS.K (hi + lo); f32 or bf16 dq",
        "bf16 d64: persistent, items of 128 keys; TMA producer warp (K/V "
        "double-buffered, Q/dO 2-stage ring, lse/delta by cp.async); 2 "
        "wgmma consumer warpgroups x 64 keys: SS wgmma S^T and dP^T, RS "
        "wgmma P^T.dO and dS^T.Q (hi + lo); f32 or bf16 dk/dv")
    for i, (name, tpu, line) in enumerate((
            ("flash_bwd_dq", "_bwd_dq_kernel", 219),
            ("flash_bwd_dkv", "_bwd_dkv_kernel", 258))):
        key = "dq" if i == 0 else "dkv"
        record = {
            "name": name, "route": "cuda",
            "source": "autodist_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"autodist_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu, "design": designs[i],
            "shape": list(TRAIN_SHAPE[:3]) + [TRAIN_SHAPE[4]],
            "outputs": "bfloat16 (the training path's); f32_out_* fields: "
                       "float32 outputs",
            "max_abs_err": errs[key],
            "library_covers": "dq, dk and dv together"}
        record.update(at_t["bfloat16"][i])
        record.update({"f32_out_" + k: v
                       for k, v in at_t["float32"][i].items()})
        record.update({"shape_a_" + k: v
                       for k, v in at_a["bfloat16"][i].items()})
        record.update({"shape_a_f32_out_" + k: v
                       for k, v in at_a["float32"][i].items()})
        records.append(record)
    return records


def route_phase(torch, fa):
    """Phase 2, the routes off the main path: each timed at one shape like
    the main routes (device and host-inclusive ms, plain version, SDPA, the
    bound at the peak of the inputs' type). Their results were held to the
    plain version above (cases (d), (e)). Returns {wrapper name: [rows]}."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}

    def inputs(shape, dtype):
        q, k, v, do = [torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(4)]
        o, lse = fa.flash_fwd(q, k, v)
        return q, k, v, do, lse, (do.float() * o.float()).sum(-1,
                                                             keepdim=True)

    def row(kernel, label, t, plain, lib, bnd):
        check(t["kernels"] and all(kernel in n for n in t["kernels"]),
              f"{kernel} at {label} launched {kernel_names(t)}")
        print(f"  route {kernel} at {label}: device ms per call {t['ms']:.4f}"
              f" / host-inclusive {t['host_ms']:.4f}, plain {plain['ms']:.4f}"
              f", SDPA {lib['ms']:.4f}; bound {bnd[0]:.4f} ({bnd[1]}); "
              f"bound / kernel {bnd[0] / t['ms']:.3f}", flush=True)
        return {"kernel": kernel, "shape": label, "ms": t["ms"],
                "host_ms": t["host_ms"], "plain_ms": plain["ms"],
                "library_ms": lib["ms"], "bound_ms": bnd[0],
                "bound_by": bnd[1]}

    print("phase 2: the routes off the main path, timed (b8 h12 s512)",
          flush=True)
    for dtype, d, kernel in ((bf16, 32, "flash_fwd_mma_kernel"),
                             (f32, 64, "flash_fwd_simt_kernel")):
        q, k, v = inputs((8, 12, 512, d), dtype)[:3]
        label = f"b8 h12 s512 d{d} {str(dtype)[6:]}"
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        bnd = bound(*attention_work(q, k, v, *fa.flash_fwd(q, k, v)), peak)
        rows["flash_fwd"].append(row(
            kernel, label, timed(torch, lambda: fa.flash_fwd(q, k, v)),
            timed(torch, lambda: fa.flash_fwd_reference(q, k, v)),
            timed(torch, lambda: sdpa(q, k, v)), bnd))
    for dtype, d, kernels in (
            (bf16, 32, ("flash_bwd_dq_mma_kernel",
                        "flash_bwd_dkv_mma_kernel")),
            (bf16, 128, ("flash_bwd_dq_wgmma_kernel",
                         "flash_bwd_dkv_mma_kernel")),
            (f32, 64, ("flash_bwd_dq_simt_kernel",
                       "flash_bwd_dkv_simt_kernel"))):
        args = inputs((8, 12, 512, d), dtype)
        q, k = args[:2]
        label = f"b8 h12 s512 d{d} {str(dtype)[6:]}, {str(dtype)[6:]} out"
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        pairs = float(8 * 12 * 512 * 512 * d)
        ins = sum(x.numel() * x.element_size() for x in args)
        size = q.element_size()
        leaves = [x.detach().clone().requires_grad_() for x in args[:3]]
        out = sdpa(*leaves)
        lib = timed(torch, lambda: torch.autograd.grad(
            out, leaves, args[3], retain_graph=True))
        plain = timed(torch, lambda: [g.to(dtype) for g in
                                      fa.flash_bwd_reference(*args)])
        rows["flash_bwd_dq"].append(row(
            kernels[0], label, timed(torch, lambda: fa.flash_bwd_dq(
                *args, out_dtype=dtype)), plain, lib,
            bound(6 * pairs, ins + q.numel() * size, peak)))
        rows["flash_bwd_dkv"].append(row(
            kernels[1], label, timed(torch, lambda: fa.flash_bwd_dkv(
                *args, out_dtype=dtype)), plain, lib,
            bound(8 * pairs, ins + 2 * k.numel() * size, peak)))
    return rows


def profile_dispatches(torch, srv, batch, n=6):
    """Where a dispatch's time goes: ``n`` sequential full-bucket requests
    under ``torch.profiler``; device time by kernel and the device's busy
    share of the wall time (kernels summed; the copy stream overlaps)."""
    from torch.profiler import ProfilerActivity, profile
    srv.infer(batch, timeout=300)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.infer(batch, timeout=300)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    total = sum(_device_us(e) for e in events)
    if not total:
        print("  profile: no device time in the trace (not measured)",
              flush=True)
        return
    flash = sum(_device_us(e) for e in events if "flash_fwd" in e.key)
    print(f"  profile, {n} requests of {batch[0].shape[0]} rows: wall "
          f"{wall_us / n / 1e3:.3f} ms/request, device busy "
          f"{total / n / 1e3:.3f} ms/request ({100 * total / wall_us:.1f}% "
          f"of wall), flash_fwd {flash / n / 1e3:.3f} ms/request "
          f"({100 * flash / total:.1f}% of device time)", flush=True)
    for e in sorted(events, key=_device_us, reverse=True)[:6]:
        print(f"    {_device_us(e) / n / 1e3:8.3f} ms/request  "
              f"x{e.count // n:<3d} {e.key[:90]}", flush=True)


def serve_phase(torch, fa, card, cfg, device):
    """Phase 3: the port's Server on ``cfg`` (BERT-base) on ``device``;
    returns the kernel's launches on the main path."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.utils.tree import leaves

    seq = cfg.max_len
    print(f"phase 3: serve.Server on a {cfg.num_layers}-layer, width "
          f"{cfg.dim} BERT at seq {seq}, buckets (4, 8)", flush=True)
    t0 = time.perf_counter()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    print(f"  init: {sum(t.numel() for t in leaves(params)) / 1e6:.1f}M "
          f"params in {time.perf_counter() - t0:.1f}s", flush=True)
    before = [t.clone() for t in leaves(params)]

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()

    ids, seg, _, _ = bert.synthetic_batch(cfg, 8, seq, seed=0)
    rng = np.random.RandomState(1)
    requests = []
    for _ in range(16):
        rows = int(rng.randint(1, 9))
        requests.append((rng.randint(0, cfg.vocab, (rows, seq)).astype(np.int32),
                         rng.randint(0, 2, (rows, seq)).astype(np.int32)))
    answers = [None] * len(requests)
    latencies = [None] * len(requests)

    fa.flash_fwd.launches = 0  # main path: engine build (warm-ups) + serving
    t0 = time.perf_counter()
    srv = serve.Server(apply_fn, params, (ids, seg), buckets=(4, 8),
                       max_wait_ms=5, device=device)
    try:
        warmups = len(srv.engine.buckets)
        print(f"  engine built (capture, strategy, placement, {warmups} "
              f"bucket warm-ups) in {time.perf_counter() - t0:.1f}s",
              flush=True)

        def client(c):
            for i in range(c, len(requests), 4):
                t = time.perf_counter()
                answers[i] = srv.submit(requests[i]).result(timeout=300)
                latencies[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "clients hung")
        check(all(a is not None for a in answers), "a request got no answer")
        repeat = [srv.infer(requests[0], timeout=300) for _ in range(2)]
        stats = srv.stats()
        launches = fa.flash_fwd.launches
        if device == "cuda":
            profile_dispatches(torch, srv, (ids, seg))
    finally:
        srv.close()
    dispatches = sum(r["dispatches"] for r in stats["replicas"])
    print(f"  {stats['completed']} requests in {stats['batches']} batches, "
          f"{dispatches} dispatches + {warmups} warm-ups; flash_fwd "
          f"launches {launches}", flush=True)
    check(stats["completed"] == len(requests) + 2, "requests lost")
    check(launches == cfg.num_layers * (dispatches + warmups),
          f"flash_fwd launched {launches} times, expected "
          f"{cfg.num_layers} x ({dispatches} dispatches + {warmups} "
          f"warm-ups): some attention did not run the kernel")
    check(torch.equal(repeat[0], repeat[1]),
          "a repeated request is not bitwise identical")
    check(all(torch.equal(a, b) for a, b in zip(before, leaves(params))),
          "serving changed the params")

    def plain_attn(q, k, v, mask=None):
        return fa.flash_fwd_reference(q, k, v, cfg.causal)[0]

    worst = 0.0
    with torch.inference_mode():
        for (rid, rseg), out in zip(requests, answers):
            ref = T.encode(params, cfg, torch.as_tensor(rid, device=device),
                           segment_ids=torch.as_tensor(rseg, device=device),
                           attn_fn=plain_attn).float().cpu()
            check(out.shape == (rid.shape[0], seq, cfg.dim),
                  f"answer shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "non-finite answer")
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            check(torch.allclose(out, ref, atol=SERVE_ATOL, rtol=SERVE_RTOL),
                  f"served answer differs from the plain forward by {err}")
    p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
    print(f"  answers vs plain forward: max abs err {worst:.3e} "
          f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL})", flush=True)
    print(f"  request latency (client, 4 threads, rows 1-8, seq {seq}): "
          f"p50 {p50:.3f} ms, p99 {p99:.3f} ms on {card}", flush=True)
    return launches


def _profile_step(torch, step, n=1):
    """Device time by kernel over ``n`` calls of ``step`` under
    ``torch.profiler``: (wall us, device-busy us, [(us, count, name)])."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    return wall_us, sum(_device_us(e) for e in events), sorted(
        ((_device_us(e), e.count, e.key) for e in events), reverse=True)


def train_phase(torch, fa, card, cfg, device, steps=20, batch_size=32,
                seq=128, num_masked=20):
    """Phase 4: BERT MLM pretraining through AutoDist -> Runner.step on a
    one-rank world; returns {kernel name: launches on the main path}."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

    print(f"phase 4: training a {cfg.num_layers}-layer, width {cfg.dim} BERT "
          f"(MLM, batch {batch_size} x seq {seq}, {num_masked} masked, Adam "
          f"1e-4) for {steps} Runner.steps through AutoDist(AllReduce())",
          flush=True)
    t0 = time.perf_counter()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    try:
        item = ad.capture(bert.make_loss_fn(cfg), params,
                          functools.partial(torch.optim.Adam, lr=1e-4),
                          example_batch=batch)
        runner = ad.create_distributed_session(item)
        state = runner.create_state()
        backend = torch.distributed.get_backend()
        mesh = dict(runner.program.mesh.shape)
        print(f"  set-up (init, capture, world, strategy, transform, state) "
              f"{time.perf_counter() - t0:.1f}s: {backend} world of "
              f"{torch.distributed.get_world_size()}, mesh {mesh}, "
              f"{len(runner.bucket_plan())} gradient bucket(s)", flush=True)
        if device == "cuda":
            check(backend == "nccl", f"the world's backend is {backend}")
        dbatch = runner.remapper.shard_batch(batch)
        named = [(path_to_name(p), t)
                 for p, t in flatten_with_path(state.params)[0]]
        leaves = [t for _, t in named]

        def grads_at(attn_fn, c=cfg):
            loss = bert.make_loss_fn(c, attn_fn=attn_fn)(state.params, dbatch)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        def plain_attn(q, k, v, mask=None):
            return fa.flash_fwd_reference(q, k, v, cfg.causal)[0]

        # Step 1 against the plain attention, before the run, and both
        # against the same model computing in f32.
        loss_k, grads_k = grads_at(None)
        loss_p, grads_p = grads_at(plain_attn)
        cfg32 = copy.copy(cfg)
        cfg32.dtype = torch.float32
        _, grads_t = grads_at(plain_attn, cfg32)
        norm_k = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads_k])).item()
        norm_p = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads_p])).item()
        dloss = abs(loss_k.item() - loss_p.item())
        proj = [i for i, (n, _) in enumerate(named)
                if "/attn/" in n and n.endswith(("query/kernel", "key/kernel",
                                                 "value/kernel"))]

        def worst(a, b):  # max over the projections, relative to b's max
            return max(((a[i] - b[i]).abs().max() / b[i].abs().max()).item()
                       for i in proj)
        apart, k_f32, p_f32 = (worst(grads_k, grads_p),
                               worst(grads_k, grads_t),
                               worst(grads_p, grads_t))
        print(f"  step 1 vs plain attention: loss {loss_k.item():.6f} vs "
              f"{loss_p.item():.6f} (|diff| {dloss:.3e}, atol "
              f"{TRAIN_LOSS_ATOL}); grad norm {norm_k:.6f} vs {norm_p:.6f} "
              f"(rel {abs(norm_k - norm_p) / norm_p:.3e}, rtol "
              f"{TRAIN_NORM_RTOL}); attention q/k/v kernels' grads, max "
              f"|diff| / max |grad|: kernels vs plain {apart:.3e} (tol "
              f"{TRAIN_LEAF_REL}), vs the f32 model: kernels {k_f32:.3e}, "
              f"plain {p_f32:.3e} (kernels within {TRAIN_F32_RATIO}x plain)",
              flush=True)
        check(dloss <= TRAIN_LOSS_ATOL, f"step-1 loss differs by {dloss}")
        check(abs(norm_k - norm_p) <= TRAIN_NORM_RTOL * norm_p,
              f"step-1 grad norm {norm_k} vs {norm_p}")
        check(apart <= TRAIN_LEAF_REL, f"attention projection grads differ "
              f"by {apart} of their max")
        check(k_f32 <= TRAIN_F32_RATIO * p_f32, f"attention projection "
              f"grads are {k_f32} off the f32 model, the plain path {p_f32}")
        del grads_k, grads_p, grads_t

        # A repeated attention backward at layer 0's own inputs: bitwise.
        seen = {}

        def recording_attn(q, k, v, mask=None):
            seen.setdefault("qkv", (q.detach(), k.detach(), v.detach()))
            return fa.flash_attention(q, k, v, cfg.causal)
        with torch.no_grad():
            bert.make_loss_fn(cfg, attn_fn=recording_attn)(state.params,
                                                           dbatch)
        qkv = [t.clone().requires_grad_() for t in seen["qkv"]]
        out = fa.flash_attention(*qkv, cfg.causal)
        do = torch.randn(out.shape, generator=torch.Generator(
            device=device).manual_seed(2), device=device, dtype=out.dtype)
        first = torch.autograd.grad(out, qkv, do, retain_graph=True)
        second = torch.autograd.grad(out, qkv, do, retain_graph=True)
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              "a repeated attention backward is not bitwise identical")
        print(f"  repeated attention backward at layer 0's inputs "
              f"{tuple(out.shape)}: bitwise identical", flush=True)
        if device == "cuda":
            # The training forward of one attention: one kernel writes the
            # saved f32 o and the model's bf16 o; no cast follows it.
            fwd = timed(torch, lambda: fa.flash_attention(*qkv, cfg.causal),
                        n=5, warmup=1)
            check(len(fwd["kernels"]) == 1 and
                  all("flash_fwd" in n and 0 < c <= 1
                      for n, c in fwd["kernels"].items()),
                  f"one training attention forward launched "
                  f"{kernel_names(fwd)}, not one flash_fwd kernel")
            print(f"  one training attention forward (_FlashAttention."
                  f"forward) launches {kernel_names(fwd)} and nothing else",
                  flush=True)
            # Its backward: delta = rowsum(do * o) (PyTorch), then each
            # backward kernel once, writing the bf16 gradients: no cast.
            bwd = timed(torch, lambda: torch.autograd.grad(
                out, qkv, do, retain_graph=True), n=5, warmup=1)
            for kernel in ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
                hits = [c for n, c in bwd["kernels"].items() if kernel in n]
                check(len(hits) == 1 and 0 < hits[0] <= 1,
                      f"one training attention backward launched "
                      f"{kernel_names(bwd)}: not one {kernel}")
            check(not any(CAST_KERNEL in n for n in bwd["kernels"]),
                  f"one training attention backward casts: "
                  f"{kernel_names(bwd)}")
            print(f"  one training attention backward (_FlashAttention."
                  f"backward under torch.autograd.grad) launches "
                  f"{kernel_names(bwd)}", flush=True)

        before = [t.detach().clone() for t in leaves]
        kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        for k in kernels:  # the main path: 20 steps
            k.launches = 0
        sync = torch.cuda.synchronize if device == "cuda" else (
            lambda: None)
        losses, times = [], []
        for i in range(steps):
            t = time.perf_counter()
            state, metrics = runner.step(state, batch)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(metrics["loss"])
            if i == 0:
                unchanged = [n for (n, _), b, (_, now) in zip(
                    named, before, flatten_with_path(state.params)[0])
                    if torch.equal(b, now.detach())]
        launches = {k.__name__: k.launches for k in kernels}
        losses = [float(x) for x in losses]
        print(f"  losses: {losses[0]:.6f} (step 1) ... {losses[-1]:.6f} "
              f"(step {steps}); all: " +
              ", ".join(f"{x:.4f}" for x in losses), flush=True)
        check(all(np.isfinite(losses)), "a loss is not finite")
        check(losses[-1] < losses[0], "the loss did not fall")
        check(not unchanged, f"step 1 left params unchanged: {unchanged}")
        print(f"  launches over {steps} steps: {launches}", flush=True)
        for name, n in launches.items():
            check(n == cfg.num_layers * steps,
                  f"{name} launched {n} times, expected {cfg.num_layers} x "
                  f"{steps}: some attention did not run the kernel")
        steady = times[4:]
        med = float(np.median(steady))
        print(f"  step time, median of steps 5-{steps}: {med:.3f} ms "
              f"(min {min(steady):.3f}, max {max(steady):.3f}; step 1 "
              f"{times[0]:.3f} ms), {batch_size / med * 1e3:.1f} samples/s "
              f"on {card}", flush=True)

        if device != "cuda":
            return launches

        def one_step():
            nonlocal state
            state, _ = runner.step(state, batch)
        wall, busy, rows = _profile_step(torch, one_step)
        flash = sum(us for us, _, name in rows if "flash_" in name)
        by_kernel = {k: (sum(us for us, _, name in rows if k in name),
                         sum(n for _, n, name in rows if k in name))
                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        for k, (_, n) in by_kernel.items():
            check(n == cfg.num_layers, f"the profiled step launched {k} {n} "
                  f"times, not {cfg.num_layers}")
        casts = sum(n for _, n, name in rows if CAST_KERNEL in name)
        print(f"  profiled step: wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall), "
              f"flash kernels {flash / 1e3:.3f} ms ({100 * flash / busy:.1f}%"
              f" of device time: " + ", ".join(
                  f"{k} {us / 1e3:.3f} ms x{n}"
                  for k, (us, n) in by_kernel.items()) +
              f") on {card}", flush=True)
        print(f"  f32 -> bf16 cast kernels ({CAST_KERNEL}) in the step: "
              f"{casts}; a backward writing f32 gradients adds one per "
              f"gradient and layer, {3 * cfg.num_layers}", flush=True)
        for us, count, name in rows[:8]:
            print(f"    {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}",
                  flush=True)
    finally:
        autodist_mod._reset_default()
    return launches


def _zoo_world(torch, device):
    """A fresh AutoDist(AllReduce(chunk_size=128)) on ``device`` (the
    previous one, with its world, reset first)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    autodist_mod._reset_default()
    return AutoDist(strategy_builder=AllReduce(chunk_size=128), device=device)


def _flash_counts(fa, reset=False):
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def _run_steps(torch, fa, step_fn, state, batch, steps, device, named=()):
    """``steps`` calls of the bare step on ``batch``: (state, losses, host
    ms per step, flash launches). Checks finite, falling losses, no flash
    launch, and that step 1 changed every param of ``named`` ((name,
    tensor) pairs of the state, which the step updates in place)."""
    before = [t.detach().clone() for _, t in named]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    _flash_counts(fa, reset=True)  # the main path of this run
    losses, times, unchanged = [], [], []
    for i in range(steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
        if i == 0:
            unchanged = [n for (n, t), b in zip(named, before)
                         if torch.equal(b, t.detach())]
    launches = _flash_counts(fa)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(not unchanged, f"step 1 left params unchanged: {unchanged}")
    check(not any(launches.values()), f"flash kernels launched in a model "
          f"without attention: {launches}")
    return state, losses, times, launches


def flatten_params(params):
    from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
    return {path_to_name(p): t for p, t in flatten_with_path(params)[0]}


def resnet_run(torch, fa, card, cfg, batch, device, precision, steps):
    """One ResNet training run of phase 5 through AutoDist -> make_callable;
    returns (step-1 loss, flash launches)."""
    from autodist_tpu_torch.models import resnet
    label = f"precision={precision!r}"
    t0 = time.perf_counter()
    params = resnet.init(cfg, torch.Generator().manual_seed(0), device=device)
    ad = _zoo_world(torch, device)
    item = ad.capture(resnet.make_loss_fn(cfg), params,
                      functools.partial(torch.optim.SGD, lr=1e-3),
                      example_batch=batch, precision=precision)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    try:
        runner.make_callable(batch, aot=True)  # bench.py's call
        check(False, "make_callable(aot=True) did not raise")
    except NotImplementedError:
        pass
    step_fn = runner.make_callable(batch)
    dbatch = runner.remapper.shard_batch(batch)  # placed once
    if device == "cuda":
        check(torch.distributed.get_backend() == "nccl", "not an NCCL world")
    print(f"  ResNet {label}: set-up (init, capture, world, strategy, "
          f"transform, state) {time.perf_counter() - t0:.1f}s, "
          f"{len(runner.bucket_plan())} gradient bucket(s) on {card}",
          flush=True)

    # Step 1 against the same model computing in f32 (TF32 off).
    named = sorted(flatten_params(state.params).items())
    leaves = [t for _, t in named]
    loss = item.loss_fn(state.params, dbatch)
    grads = torch.autograd.grad(loss, leaves)
    cfg32 = copy.copy(cfg)
    cfg32.dtype = torch.float32
    loss32 = resnet.make_loss_fn(cfg32)(state.params, dbatch)
    grads32 = torch.autograd.grad(loss32, leaves)
    rel = {n: ((g - g32).abs().max() / g32.abs().max()).item()
           for (n, _), g, g32 in zip(named, grads, grads32)}
    worst = max(rel, key=rel.get)
    flat, flat32 = (torch.cat([g.flatten() for g in gs])
                    for gs in (grads, grads32))
    cos = torch.nn.functional.cosine_similarity(flat, flat32, dim=0).item()
    rel_l2 = ((flat - flat32).norm() / flat32.norm()).item()
    dloss = abs(loss.item() - loss32.item()) / abs(loss32.item())
    print(f"  step 1 vs the f32 model: loss {loss.item():.6f} vs "
          f"{loss32.item():.6f} (rel {dloss:.3e}, rtol {ZOO_LOSS_RTOL}); "
          f"whole gradient: cosine {cos:.4f} (>= {ZOO_GRAD_COS}), relative "
          f"L2 {rel_l2:.4f} (<= {ZOO_GRAD_REL}); per leaf, max |diff| / max "
          f"|grad|: median {float(np.median(list(rel.values()))):.3e}, worst "
          f"{rel[worst]:.3e} ({worst}) on {card}", flush=True)
    check(loss.dtype == torch.float32, f"the loss is {loss.dtype}")
    check(all(g.dtype == torch.float32 for g in grads),
          "a gradient is not float32")
    check(dloss <= ZOO_LOSS_RTOL, f"step-1 loss {loss.item()} vs the f32 "
          f"model's {loss32.item()}")
    check(cos >= ZOO_GRAD_COS and rel_l2 <= ZOO_GRAD_REL, f"step-1 "
          f"gradient vs the f32 model's: cosine {cos}, relative L2 {rel_l2}")
    first = loss.item()
    del loss, grads, loss32, grads32, flat, flat32

    state, losses, times, launches = _run_steps(
        torch, fa, step_fn, state, dbatch, steps, device, named)
    n = dbatch[0].shape[0]
    steady = times[4:] if len(times) > 4 else times
    med = float(np.median(steady))
    print(f"  losses {losses[0]:.6f} (step 1) ... {losses[-1]:.6f} (step "
          f"{steps}); all: " + ", ".join(f"{x:.4f}" for x in losses) +
          f"; flash launches over the {steps} steps: {launches} on {card}",
          flush=True)
    flops = item.flops_estimate()
    print(f"  step time, median of steps 5-{steps}: {med:.3f} ms (min "
          f"{min(steady):.3f}, max {max(steady):.3f}; step 1 {times[0]:.3f} "
          f"ms), {n / med * 1e3:.1f} images/s on {card}", flush=True)
    model_flops = 3 * flops / (med / 1e3)
    print(f"  flops_estimate() {flops / 1e9:.3f} GFLOP per forward at batch "
          f"{n}; model FLOP/s (3 x forward / step time) "
          f"{model_flops / 1e12:.2f} TFLOP/s, "
          f"{100 * model_flops / PEAK_BF16_FLOPS:.2f}% of the dense bf16 "
          f"peak on {card}", flush=True)
    if device == "cuda":
        def one_step():
            nonlocal state
            state, _ = step_fn(state, dbatch)
        wall, busy, rows = _profile_step(torch, one_step)
        transposes = sum(c for _, c, name in rows
                         if any(t in name for t in TRANSPOSE_KERNELS))
        groups = {}
        for us, count, name in rows:
            group = next((g for g, keys in KERNEL_GROUPS if any(
                k in name for k in keys)), "other")
            total, n_k = groups.get(group, (0.0, 0))
            groups[group] = (total + us, n_k + count)
        print(f"  profiled step: wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall); "
              f"layout-transpose kernels ({', '.join(TRANSPOSE_KERNELS)}): "
              f"{transposes}; by kind: " + ", ".join(
                  f"{g} {us / 1e3:.3f} ms x{n_k}" for g, (us, n_k) in
                  sorted(groups.items(), key=lambda kv: -kv[1][0])) +
              f" on {card}", flush=True)
        for us, count, name in rows[:12]:
            print(f"    {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}",
                  flush=True)
    return first, launches


def zoo_phase(torch, fa, card, device, resnet_cfg=None, image=224,
              batch_size=64, steps=20, bilstm_cfg=None, ncf_cfg=None,
              rnn_steps=5):
    """Phase 5: ResNet-50 with the model's bf16 compute and under
    ``precision="bf16"``, then BiLSTM and NCF, each through AutoDist ->
    make_callable on a one-rank world; returns {path: flash launches}."""
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bilstm, ncf, resnet
    cfg = resnet_cfg or resnet.resnet50()
    batch = resnet.synthetic_batch(batch_size, image, cfg.num_classes)
    print(f"phase 5: the model zoo; ResNet (stages {cfg.stage_sizes}, "
          f"{cfg.num_classes} classes, batch {batch_size} x {image} x {image}"
          f" x 3, SGD 1e-3) for {steps} steps through AutoDist(AllReduce("
          f"chunk_size=128)) -> make_callable", flush=True)
    paths = {}
    try:
        first, paths["zoo_resnet"] = resnet_run(
            torch, fa, card, cfg, batch, device, None, steps)
        first16, paths["zoo_resnet_bf16"] = resnet_run(
            torch, fa, card, cfg, batch, device, "bf16", steps)
        drift = abs(first16 - first) / abs(first)
        print(f"  step-1 loss under precision='bf16' {first16:.6f} vs the "
              f"model's bf16 compute {first:.6f} (rel {drift:.3e}, rtol "
              f"{ZOO_LOSS_RTOL}) on {card}", flush=True)
        check(drift <= ZOO_LOSS_RTOL, "the precision='bf16' step-1 loss is "
              f"{drift} off the model's own")

        for name, mod, mcfg in (
                ("bilstm", bilstm, bilstm_cfg or bilstm.BiLSTMConfig()),
                ("ncf", ncf, ncf_cfg or ncf.NCFConfig())):
            mbatch = (mod.synthetic_batch(mcfg, 64, 128) if name == "bilstm"
                      else mod.synthetic_batch(mcfg, 1024))
            t0 = time.perf_counter()
            params = mod.init(mcfg, torch.Generator().manual_seed(0),
                              device=device)
            ad = _zoo_world(torch, device)
            item = ad.capture(mod.make_loss_fn(mcfg), params,
                              functools.partial(torch.optim.Adam, lr=1e-3),
                              example_batch=mbatch)
            runner = ad.create_distributed_session(item)
            state = runner.create_state()
            sparse = sorted(v.name for v in item.variables
                            if v.sparse_access)
            want = (["embed/embedding"] if name == "bilstm" else
                    sorted(f"embed_{w}_{t}/embedding" for w in ("user", "item")
                           for t in ("gmf", "mlp")))
            check(sparse == want, f"{name}: sparse-access {sparse}")
            dbatch = runner.remapper.shard_batch(mbatch)
            state, losses, times, paths["zoo_" + name] = _run_steps(
                torch, fa, runner.make_callable(mbatch), state, dbatch,
                rnn_steps, device)
            warm = float(np.median(times[1:]))
            print(f"  {name} (batch {tuple(mbatch[0].shape)}, Adam 1e-3): "
                  f"set-up {time.perf_counter() - t0 - sum(times) / 1e3:.1f}"
                  f"s; losses " + ", ".join(f"{x:.4f}" for x in losses) +
                  f"; step ms, median of steps 2-{rnn_steps}: {warm:.3f} "
                  f"(step 1 {times[0]:.3f}); flops_estimate() "
                  f"{item.flops_estimate() / 1e9:.4f} GFLOP; sparse-access "
                  f"{sparse}; flash launches {paths['zoo_' + name]} on "
                  f"{card}", flush=True)
    finally:
        autodist_mod._reset_default()
    return paths


def short_kernel(mangled):
    """``flash_fwd_wgmma_kernel<d=64, f32 + bf16 out>`` from a mangled
    kernel name."""
    m = re.search(r"(flash_[a-z_]+_kernel)I(.*)EEv", mangled)
    if m is None:
        return mangled
    args = m.group(2)
    out = ("bf16 out, " if "bfloat16" in args or "Lb0E" in args
           else "f32 + bf16 out, " if "Lb1E" in args
           else "f32 out, " if args[:1] == "f" else "")
    dims = ",".join(re.findall(r"Li(\d+)E", args + "E"))
    return f"{m.group(1)}<{out}d={dims}>"


# Every TMA / wgmma instantiation, by library: {kernel: [(d, output)]}.
# The forward's template is <d, f32 out>, the backward's <output type, d>.
WGMMA_KERNELS = {
    "flash_fwd": {"flash_fwd_wgmma_kernel": [
        (d, out) for d in (64, 128) for out in ("bf16", "f32 + bf16")]},
    "flash_bwd": {
        "flash_bwd_dq_wgmma_kernel": [
            (d, out) for d in (64, 128) for out in ("f32", "bf16")],
        "flash_bwd_dkv_wgmma_kernel": [(64, "f32"), (64, "bf16")]},
}


def _wgmma_instance(name):
    """(kernel, d, output) of a TMA / wgmma kernel's mangled name, or None."""
    m = re.search(r"(flash_fwd_wgmma_kernel)ILi(\d+)ELb([01])E", name)
    if m:
        return (m.group(1), int(m.group(2)),
                "f32 + bf16" if m.group(3) == "1" else "bf16")
    m = re.search(r"(flash_bwd_d(?:q|kv)_wgmma_kernel)I(f|13__nv_bfloat16)"
                  r"Li(\d+)E", name)
    if m:
        return (m.group(1), int(m.group(3)),
                "f32" if m.group(2) == "f" else "bf16")
    return None


def sass_check(build):
    """Phase 1: every TMA / wgmma instantiation (the forward at d = 64 and
    128, bf16 and f32 + bf16 output; the backward's dq at d = 64 and 128 and
    dk/dv at d = 64, f32 and bf16 output) holds wgmma (HGMMA) and TMA load
    (UTMALDG) instructions in its SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for lib in WGMMA_KERNELS:
        sass = subprocess.run([tool, "-sass", build.library_path(lib)[1]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for body in sass.split("Function : ")[1:]:
            key = _wgmma_instance(body.split("\n", 1)[0])
            if key:
                found[key] = (body.count("HGMMA"), body.count("UTMALDG"))
    for kernels in WGMMA_KERNELS.values():
        for kernel, variants in kernels.items():
            for d, out in variants:
                hgmma, utmaldg = found.get((kernel, d, out), (0, 0))
                check(hgmma > 0 and utmaldg > 0,
                      f"{kernel}<d={d}, {out} out> has {hgmma} HGMMA and "
                      f"{utmaldg} UTMALDG instructions")
    print("  SASS (cuobjdump -sass): " + ", ".join(
        f"{k.replace('_wgmma_kernel', '')} d={d} {out} out: {h} HGMMA, "
        f"{u} UTMALDG"
        for (k, d, out), (h, u) in sorted(found.items())), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.load_all()
    print(f"phase 1: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(nvcc: {json.dumps(build.build_seconds)})", flush=True)
    for name, log in build.build_logs.items():
        for kernel, regs, spill in build.register_report(log):
            print(f"  {name}: {short_kernel(kernel)} {regs} registers, "
                  f"{spill} bytes spilled", flush=True)
            check(spill == 0 or _wgmma_instance(kernel) is None,
                  f"{short_kernel(kernel)} spills {spill} bytes")
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)
    sass_check(build)

    fwd = kernel_phase(torch, fa)
    bwd = backward_phase(torch, fa)
    routes = route_phase(torch, fa)
    from autodist_tpu_torch.models import bert
    served = serve_phase(torch, fa, card, bert.bert_base(max_len=512), "cuda")
    trained = train_phase(torch, fa, card, bert.bert_base(max_len=128),
                          "cuda")
    zoo = zoo_phase(torch, fa, card, "cuda")
    fwd["launches"] = served + trained["flash_fwd"]
    fwd["launches_by_path"] = {"serve": served,
                               "train": trained["flash_fwd"]}
    for record in bwd:
        record["launches"] = trained[record["name"]]
        record["launches_by_path"] = {"serve": 0,
                                      "train": trained[record["name"]]}
    for record in [fwd] + bwd:
        record["launches_by_path"].update(
            {path: counts[record["name"]] for path, counts in zoo.items()})
        record["other_routes"] = routes[record["name"]]
    print(card, flush=True)
    print(json.dumps({"kernels": [fwd] + bwd}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
