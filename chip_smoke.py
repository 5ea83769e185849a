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
   the causal / offset / ragged / float32 / d = 128 / strided cases, and
   (g) batch x heads past 65535 on every route; every
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
   identical, every dispatch replays its bucket's CUDA graph, and the
   launch counts show every layer of every dispatch ran the forward kernel;
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
6. decode: lm1b (vocab 32000, width 1024, 16 heads and layers, bf16
   compute, seeded random weights) generates through ``serve.DecodeServer``
   with buckets (8, 256) and (32, 1024), each lane's step one CUDA graph:
   64 requests from four closed-loop clients (prompts of 16-128 tokens,
   32-128 new tokens). Every request completes exactly once with its token
   count; 4 requests' teacher-forced logits are held against the port's
   full-prefix recompute (the count of greedy tokens that agree is
   printed); a reused slot's logits are bitwise those over a zeroed cache;
   each lane's graph replay is bitwise its eager step and its ids
   ``np.argmax`` of its logits; no flash kernel launches on the path; the
   params are unchanged. Prints tokens/s, request p50 / p99, and per lane
   the step's device and host-inclusive ms (graph and eager), its bound,
   and the device-busy share of a window of steps. (The flash kernels at
   batch x heads past 65535, which BERT-base serving reaches at buckets
   over 5461 rows, are phase 2's case (g), on every route.);
7. the host-side step as CUDA graphs: BERT-base MLM (batch 32 x 128, Adam
   1e-4, ``AllReduce()``) from one initial state 20 steps eagerly, 20
   through ``make_callable(batch, aot=True)`` and 20 through
   ``run(..., 20, unroll=4)``; ResNet-50 (batch 64 x 224^2, SGD 1e-3,
   ``AllReduce(chunk_size=128)``) eagerly and through ``aot=True``, with
   the model's bf16 compute and under ``precision="bf16"``. Each graph
   path: step 1's loss bitwise the eager step's, every loss within 1e-2
   relative of the eager path's, its graph captured and replayed once per
   later call (dispatch), and a replay's loss bitwise an eager step's from
   the same state; flash launches 12 x 20 per BERT path (the eager
   warm-up's plus the replays'), 0 for ResNet. Prints the median step
   time, samples (images) / s, model FLOP/s, and the device-busy share of
   5 unprofiled steps, eager and graph. Then serving BERT-base at seq 512,
   buckets (4, 8), phase 3's traffic on bucket graphs: every dispatch's
   answer bitwise the eager forward of its padded batch, every answer
   unchanged after later dispatches, replays == dispatches, flash launches
   12 x (replays + warm-ups); client p50 / p99, and the wall, device time
   and ``Memcpy DtoH`` of a full-bucket request before (eager forward,
   pageable copy) and after (graph replay, pinned fetch);
8. the strategy builders: BERT-base MLM (batch 32 x 128, Adam 1e-4) on a
   one-rank NCCL world from one seeded init, 4 eager steps each under
   ``AutoDist()`` (its default builder, ``PS()``), ``PSLoadBalancing()``,
   ``PartitionedPS()``, ``UnevenPartitionedPS()``, ``PartitionedAR()``,
   ``RandomAxisPartitionAR()`` and ``PS(staleness=2)``, each held to
   ``AllReduce()``'s 4 eager steps (step 1 bitwise, then within
   ``STRATEGY_LOSS_RTOL``), and 20 steps of ``Parallax()`` (BASELINE's
   BERT configuration) through ``make_callable(aot=True)``, held to
   ``AllReduce()``'s aot steps; every run lowers as the JAX package does
   on one device (each variable the replicated update, a stale one the
   local update), with finite falling losses, every param changed, and
   12 launches of each flash kernel a step; each loss tolerance must lie
   between ``AllReduce()`` read again from the same init and at twice the
   learning rate (a planted fault). Prints the Parallax and AllReduce aot
   step times (host-inclusive and device busy). Then the two-rank
   sub-phase: a 2-layer BERT-base-width model (SGD 0.1) under
   ``Parallax()``, ``PartitionedPS()`` and ``PS()`` on two gloo ranks on
   the one card (the split-parameter and ZeRO-1 lowerings beside the
   kernels), losses and each param's update held to one rank's
   ``AllReduce()`` steps (a doubled gradient must read above the update
   tolerance), the ranks' params bitwise equal;
9. training that survives (``checkpoint/``, ``resilience/``): (a) BERT-base
   (max_len 512, batch 32 x 128, Adam 1e-4, the MLM loss scaled by the
   float masked-LM weights, all 1) takes 12 steps under
   ``CheckpointManager.run(unroll=2)`` (a CUDA graph of 2 steps), a
   checkpoint every 4 steps, ``StepGuard(check_every=2)`` and
   ``AUTODIST_CHAOS=nan_at=5`` set for this part only: exactly one
   rollback, into the graph's own tensors (no new capture), no retained
   step with non-finite params, finite falling losses, the newest step's
   every leaf (Adam's device ``step`` included) bitwise the live state's;
   the checkpoint's bytes and its save / restore ms (host-inclusive,
   GB/s), BERT and ResNet-50; the guard's cost (graph step ms with no
   guard, ``check_every`` 1 and 10). An uninterrupted 16-step graph run
   over distinct batches saves step 8; (d) its newest step truncated,
   ``restore_or_init`` in a fresh Runner falls back to step 8 (every leaf
   bitwise) and resumes to 16: losses and the update held to the
   uninterrupted run, each tolerance between the same run again (floor)
   and a resume with Adam's moments zeroed (planted fault), all printed;
   (b) the same for ResNet-50 (64 x 224^2, SGD 1e-3), bitwise; (c) a child
   process (this script) trains BERT-base eagerly under
   ``CheckpointManager.run(preemption=True)``, takes a real SIGTERM, saves
   its emergency step 4 and exits with 128 + 15; this process resumes from
   it for 4 more steps; (e) the params restored from the checkpoint serve
   through ``serve.Server`` (bucket 8 x 512), bitwise the trained params'
   eager forward; (f) the graph step around an asynchronous
   ``CheckpointManager.save`` (the save call, the graphs after it,
   ``wait_until_finished``) beside a synchronous ``Saver.save``, the saved
   step bitwise the state at the save. Flash launches: 12 a layer's step
   on every BERT path;
10. sequence parallelism: (a) in one process, a causal ring of 4 hops of
   4096 over a global sequence of 16384 at lm1b's attention width (b 2,
   h 16, d 64, bf16): every hop's ``block_attn_fwd`` / ``block_attn_bwd``
   against its plain version (wholly masked hops exactly o = 0, lse =
   -1e30, gradients 0), the ring's o, dq, dk and dv against one
   ``flash_attention`` call over the whole sequence (the tolerance between
   the ring's reading and a dropped hop's), and the hop kernels timed at
   the diagonal and at a fully visible hop beside their plain versions,
   SDPA (causal / non-causal) and the bound; (b) two gloo ranks on the
   card train an LM at lm1b's widths (2 layers, max_len 4096, batch 2 x
   4096, SGD 0.1) under ``SequenceParallel("ring")`` and ``("ulysses")``
   through ``AutoDist`` -> ``Runner.step``, each rank its half of the
   sequence: losses and the update held to one rank's ``AllReduce()``
   steps over the whole sequence, each tolerance between that run again
   and a block-diagonal fault, the ranks' params bitwise equal, and each
   layer's launches of the hop and flash kernels counted;
11. output: one ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import copy
import functools
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

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
# Phase 6, lm1b decode: the lanes' (slots, cache_len) buckets, the traffic,
# and the requests whose teacher-forced logits are held against the port's
# full-prefix recompute (encode with the dense attention, padded to the
# lane's cache length). Both paths compute in bf16 but in other matmul
# shapes (one row per slot against the whole padded sequence), so their bf16
# roundings part by an ulp here and there through 16 layers; the tolerance is
# max |diff| relative to the largest |logit|.
DECODE_BUCKETS = ((8, 256), (32, 1024))
DECODE_REQUESTS, DECODE_CLIENTS, DECODE_CHECKED = 64, 4, 4
DECODE_LOGIT_RTOL = 5e-2
# Phase 7, the training step as CUDA graphs: each graph path's per-step
# losses against the eager path's, relative. The paths start from the same
# state, but not every gradient is bitwise between runs (the MLM gather's
# backward and the embedding lookup's scatter-add atomics), so the
# trajectories part after step 1. The unrolled path fuses this many steps
# per graph, and the busy share is read over this many unprofiled steps.
GRAPH_LOSS_RTOL = 1e-2
GRAPH_UNROLL = 4
BUSY_WINDOW = 5
# Phase 8, the strategy builders on one rank: every builder lowers to the
# replicated update there (a stale one to the local update, whose average
# over one rank is the identity), so each computes AllReduce's step. Step
# 1's loss (before any update) is bitwise AllReduce's; later ones part only
# through gradients that are not bitwise between runs (the MLM gather's and
# the embedding lookup's scatter-add atomics), which four steps of Adam
# carry into the loss far below this relative tolerance. Parallax's 20
# aot steps are held to AllReduce's aot steps (the same capturable Adam)
# at STRATEGY_GRAPH_RTOL. Each tolerance is checked to lie between two
# readings of the same run: AllReduce() again from the same init (the
# floor the atomics leave) and AllReduce() at twice the learning rate (a
# planted fault, the update doubled), which the check must see. Read on
# an H100: eager floor 1.8e-5 and 3.1e-5, fault 2.5e-2; aot floor 8.7e-4
# and 1.4e-3 (Parallax, which computes AllReduce's step on one rank, read
# up to 2.5e-3 from it), fault 5.8e-2.
STRATEGY_STEPS = 4
STRATEGY_GRAPH_STEPS = 20
STRATEGY_LOSS_RTOL = 1e-3
STRATEGY_GRAPH_RTOL = 1e-2
# Phase 9, training that survives: BERT's graph step (K = RESIL_UNROLL
# steps a CUDA graph) under CheckpointManager.run with a checkpoint every
# RESIL_INTERVAL steps and a StepGuard reading the flag every RESIL_CHECK,
# a NaN batch at step RESIL_NAN_AT (the first step of a K-block: a block's
# batch is poisoned when nan_at names its first step, as in the JAX
# package's CheckpointManager.run); then an uninterrupted run of
# RESIL_RESUME_STEPS steps over distinct batches against a resume from its
# step RESIL_RESUME_FROM in a fresh Runner. The resumed losses are held at
# RESUME_RTOL (max relative difference) and the resumed update at
# RESUME_UPDATE_RTOL (``update_error`` over the resumed steps); each must
# lie between two uninterrupted runs of the program (the floor: the
# gradients' atomics) and a planted fault (the resume with Adam's moments
# zeroed). Read on an H100 (distinct random batches: the loss moves little):
# losses floor 3.0e-5, fault 1.3e-3, resumed 1.4e-5; update floor 2.6e-2,
# fault 0.93, resumed 2.5e-3. A preempted child process gets its
# SIGTERM while it fetches batch PREEMPT_AT; the guard's cost is read over
# GUARD_COST_STEPS graph steps.
RESIL_STEPS, RESIL_RESUME_STEPS, RESIL_RESUME_FROM = 12, 16, 8
RESIL_INTERVAL, RESIL_CHECK, RESIL_NAN_AT, RESIL_UNROLL = 4, 2, 5, 2
RESUME_RTOL, RESUME_UPDATE_RTOL = 2e-4, 0.2
PREEMPT_AT = 4
GUARD_COST_STEPS = 20
# (f), the save stall: K-step graphs timed before and after a save.
SAVE_STALL_STEPS = 5

# Phase 10, sequence parallelism. (a) One process emulates a ring of
# SP_HOPS ranks over a global causal sequence at lm1b's attention width
# (b, h, s, d = SP_SHAPE, bf16): every hop's block_attn_fwd / _bwd against
# its plain version (the phase 2 tolerances: f32 o at O_F32_ATOL, lse at
# LSE_ATOL, dq / dk at BWD_REL_DQDK_BF16 and dv at BWD_REL_DV_BF16 of the
# max), then the ring's o, dq, dk and dv against one flash_attention call
# over the whole sequence, relative to each one's max |value|: both round
# to bf16 once at the end (2^-8 relative), the ring summing its hops in
# f32 in another order. SP_RING_REL must lie between the ring's reading
# and a planted fault (one hop dropped). (b) SP_WORLD gloo ranks (processes
# of this script) on the one card train lm1b's widths at SP_LAYERS layers
# and max_len SP_MAX_LEN on SP_BATCH x SP_MAX_LEN tokens, SGD SP_LR, under
# SequenceParallel("ring") and ("ulysses"), each rank its half of the
# sequence; their losses and update are held to one rank's AllReduce()
# steps over the whole sequence at SP_LOSS_RTOL / SP_UPDATE_RTOL, each
# between the floor (that run again) and a planted fault (each rank's
# attention local to its chunk: block-diagonal).
SP_SHAPE, SP_HOPS = (2, 16, 16384, 64), 4
SP_RING_REL = 1e-2
SP_WORLD, SP_LAYERS, SP_MAX_LEN, SP_BATCH = 2, 2, 4096, 2
SP_STEPS, SP_LR = 3, 0.1
SP_LOSS_RTOL, SP_UPDATE_RTOL = 2e-4, 5e-2


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
    # batch x heads past grid.y's 65535 on every route (BERT-base serving
    # at a bucket over 5461 rows): the persistent TMA / wgmma kernel, and the
    # tiled mma.sync and FMA kernels on their 1-D grid.
    for (b, h, s, d), dtype in (((5462, 12, 128, 64), bf16),
                                ((5462, 12, 64, 32), bf16),
                                ((5462, 12, 32, 16), f32)):
        q, k, v = qkv(b, h, s, s, d, dtype)
        compare(f"(g) b{b} h{h} (b*h {b * h}) s{s} d{d} {str(dtype)[6:]} "
                f"causal", q, k, v, causal=True)
        del q, k, v

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
    for shape, dtype in (((5462, 12, 64, 64, 64), bf16),
                         ((5462, 12, 64, 64, 32), bf16),
                         ((5462, 12, 32, 32, 16), f32)):
        compare(f"(g) b*h {shape[0] * shape[1]} s{shape[2]} d{shape[4]} "
                f"{str(dtype)[6:]} causal (past grid.y's 65535)", shape,
                dtype, causal=True)

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
        replays = sum(g.replays for g in srv.engine.replicas[0].graphs.values())
        if device == "cuda":
            profile_dispatches(torch, srv, (ids, seg))
    finally:
        srv.close()
    dispatches = sum(r["dispatches"] for r in stats["replicas"])
    print(f"  {stats['completed']} requests in {stats['batches']} batches, "
          f"{dispatches} dispatches + {warmups} warm-ups; flash_fwd "
          f"launches {launches}", flush=True)
    check(stats["completed"] == len(requests) + 2, "requests lost")
    if device == "cuda":
        check(replays == dispatches, f"{dispatches} dispatches but "
              f"{replays} bucket graph replays")
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


def _lane_inputs(lane, seed):
    """Host (tokens, positions) that fill every slot of ``lane``: random
    tokens at positions spread over the cache."""
    rng = np.random.RandomState(seed)
    vocab = lane.replica.params["embed"]["embedding"].shape[0]
    return (rng.randint(1, vocab, lane.slots).astype(np.int64),
            rng.randint(0, lane.cache_len, lane.slots).astype(np.int64))


def _eager_step(torch, lane):
    """The lane's step without its graph, on the card: the same copies in,
    the step's kernels launched one by one, the ids to the host."""
    def step(tok, pos):
        lane.tokens.copy_(torch.from_numpy(tok))
        lane.pos.copy_(torch.from_numpy(pos))
        ids = lane._compute()[1].cpu()
        torch.cuda.synchronize()
        return ids
    return step


def _teacher_forced(torch, lane, streams):
    """Feed each stream (token list) through its own slot of ``lane``, one
    position per step, from a zeroed cache; returns each stream's logits
    (len, vocab) on the device, rows as the lane computed them."""
    from autodist_tpu_torch.utils.tree import leaves
    for t in leaves(lane.cache):
        t.zero_()
    vocab = lane.replica.params["embed"]["embedding"].shape[0]
    out = [torch.empty((len(st), vocab), device=lane.device)
           for st in streams]
    for s in range(max(len(st) for st in streams)):
        tok = np.zeros(lane.slots, np.int64)
        pos = np.zeros(lane.slots, np.int64)
        for i, st in enumerate(streams):
            if s < len(st):
                tok[i], pos[i] = st[s], s
        lane._run(tok, pos)
        for i, st in enumerate(streams):
            if s < len(st):
                out[i][s] = lane.logits[i]
    return out


def decode_phase(torch, fa, card, cfg, device, buckets=DECODE_BUCKETS,
                 requests=DECODE_REQUESTS, clients=DECODE_CLIENTS,
                 prompt_len=(16, 128), new_tokens=(32, 128)):
    """Phase 6: lm1b decode through serve.DecodeServer, one CUDA graph per
    (slots, cache_len) lane; returns {kernel name: launches on the path}."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import layers as L
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.utils.tree import leaves

    print(f"phase 6: serve.DecodeServer on a {cfg.num_layers}-layer, width "
          f"{cfg.dim}, vocab {cfg.vocab} causal LM ({str(cfg.dtype)[6:]} "
          f"compute), buckets {list(buckets)}; {requests} requests from "
          f"{clients} closed-loop clients, prompts {prompt_len[0]}-"
          f"{prompt_len[1]} tokens, max_new_tokens {new_tokens[0]}-"
          f"{new_tokens[1]}", flush=True)
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = sum(t.numel() for t in leaves(params))
    before = [t.clone() for t in leaves(params)]

    def apply_fn(p, batch):
        (tokens,) = batch
        return T.logits(p, cfg, T.encode(p, cfg, tokens))

    rng = np.random.RandomState(1)
    work = [(rng.randint(1, cfg.vocab, int(rng.randint(prompt_len[0],
                                                      prompt_len[1] + 1))),
             int(rng.randint(new_tokens[0], new_tokens[1] + 1)))
            for _ in range(requests)]
    outputs, latencies = [None] * requests, [None] * requests
    _flash_counts(fa, reset=True)  # the main path: server build + traffic
    srv = serve.DecodeServer(
        apply_fn, lm.make_decode_fn(cfg),
        functools.partial(lm.init_decode_cache, cfg), params,
        (np.zeros((8, 16), np.int32),), buckets=buckets, device=device)
    try:
        lanes = srv.engine.replicas[0].lanes
        graphs = [lane.graph is not None for lane in lanes]
        print(f"  init {n_params / 1e6:.1f}M params + server build (capture, "
              f"strategy, placement, {len(lanes)} lanes: caches "
              f"{sum(srv.engine.cache_bytes(*b) for b in buckets) / 1e9:.3f} "
              f"GB, CUDA graphs {graphs}) {time.perf_counter() - t0:.1f}s",
              flush=True)
        if device == "cuda":
            check(all(graphs), "a lane on the card has no CUDA graph")

        def client(c):
            for i in range(c, requests, clients):
                t = time.perf_counter()
                prompt, n_new = work[i]
                outputs[i] = srv.submit(prompt, max_new_tokens=n_new).result(
                    timeout=600)
                latencies[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "decode clients hung")
        stats = srv.stats()
        launches = _flash_counts(fa)
        steps = {f"{ln.slots}x{ln.cache_len}": ln.steps for ln in lanes}
        srv.engine._stop_threads()  # the lanes are driven directly below
        tokens = sum(len(o) for o in outputs)
        check(all(o is not None and len(o) == n for o, (_, n) in
                  zip(outputs, work)), "a request got no answer or the wrong "
              "number of tokens")
        check(stats["completed"] == stats["requests"] == requests and
              stats["tokens"] == tokens and stats["in_flight"] == 0 and
              stats["queue_depth"] == 0,
              f"requests did not complete exactly once: {stats}")
        check(all(0 <= int(x) < cfg.vocab for o in outputs for x in o),
              "a generated token is outside the vocabulary")
        check(not any(launches.values()), f"the decode path launched flash "
              f"kernels: {launches}")
        p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
        print(f"  {requests} requests, each completed once, {tokens} tokens "
              f"generated in {wall:.3f} s: {tokens / wall:.1f} tokens/s; "
              f"request latency (client) p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
              f"lane steps {steps}; flash launches {launches} on {card}",
              flush=True)

        # Teacher-forced logits vs the port's full-prefix recompute.
        small = lanes[0]
        order = sorted(range(requests), key=lambda i: -len(work[i][0]) -
                       len(outputs[i]))[:DECODE_CHECKED]
        streams = [list(work[i][0]) + [int(x) for x in outputs[i]]
                   for i in order]
        fit = [st[:small.cache_len] for st in streams]
        forced = _teacher_forced(torch, small, fit)
        worst, agree, agree_lane, total = 0.0, 0, 0, 0
        with torch.inference_mode():
            for i, st, got in zip(order, fit, forced):
                ids = torch.zeros((1, small.cache_len), dtype=torch.long,
                                  device=small.device)
                ids[0, :len(st)] = torch.as_tensor(st, device=small.device)
                ref = T.logits(params, cfg, T.encode(
                    params, cfg, ids, attn_fn=L.dot_product_attention))[0]
                ref = ref[:len(st)]
                worst = max(worst, ((got - ref).abs().max() /
                                    ref.abs().max()).item())
                gen = range(len(work[i][0]) - 1, len(st) - 1)
                nxt = torch.as_tensor(st, device=small.device)
                total += len(gen)
                agree += int((ref[gen.start:gen.stop].argmax(-1) ==
                              nxt[gen.start + 1:gen.stop + 1]).sum())
                agree_lane += int((got[gen.start:gen.stop].argmax(-1) ==
                                   nxt[gen.start + 1:gen.stop + 1]).sum())
        print(f"  teacher-forced logits of {len(order)} requests (lengths "
              f"{[len(st) for st in fit]}) vs the full-prefix recompute "
              f"(encode, dense attention, padded to {small.cache_len}): max "
              f"|diff| / max |logit| {worst:.3e} (tol {DECODE_LOGIT_RTOL}); "
              f"served tokens that the recompute's greedy choice agrees "
              f"with: {agree} of {total} (the lane's own teacher-forced "
              f"choice: {agree_lane} of {total})", flush=True)
        check(worst <= DECODE_LOGIT_RTOL, f"decode logits are {worst} of "
              f"their max off the full-prefix recompute")

        # Stale-slot reuse: slot 0 over zeros, and over another request.
        probe, filler = fit[-1][:40], streams[0]
        clean = _teacher_forced(torch, small, [probe])[0].clone()
        for s, t in enumerate(filler[:small.cache_len]):
            tok = np.zeros(small.slots, np.int64)
            pos = np.zeros(small.slots, np.int64)
            tok[0], pos[0] = t, s
            small._run(tok, pos)
        stale = torch.empty_like(clean)
        for s, t in enumerate(probe):
            tok = np.zeros(small.slots, np.int64)
            pos = np.zeros(small.slots, np.int64)
            tok[0], pos[0] = t, s
            small._run(tok, pos)
            stale[s] = small.logits[0]
        check(torch.equal(clean, stale), "a reused slot's logits depend on "
              "the stale rows of its previous occupant")
        print(f"  stale-slot reuse: slot 0's logits over {len(probe)} "
              f"positions bitwise equal over a zeroed cache and over "
              f"{min(len(filler), small.cache_len)} rows of another "
              f"request", flush=True)

        if device == "cuda":
            for lane in lanes:
                decode_lane_timing(torch, card, cfg, lane, n_params)
    finally:
        srv.close()
    check(all(torch.equal(a, b) for a, b in zip(before, leaves(params))),
          "decoding changed the params")
    return launches


def decode_lane_timing(torch, card, cfg, lane, n_params):
    """Phase 6 on the card, one lane: graph replay vs the eager step
    (bitwise, then timed), its bound, and a profiled window of steps."""
    from autodist_tpu_torch.serve.decode import DecodeRequest
    from autodist_tpu_torch.utils.tree import leaves
    label = f"lane {lane.slots}x{lane.cache_len}"
    tok, pos = _lane_inputs(lane, seed=lane.slots)
    eager = _eager_step(torch, lane)
    snapshot = [t.clone() for t in leaves(lane.cache)]
    ids_g = torch.from_numpy(lane._run(tok, pos).copy())
    logits_g = lane.logits.clone()
    cache_g = [t.clone() for t in leaves(lane.cache)]
    for t, s in zip(leaves(lane.cache), snapshot):
        t.copy_(s)
    ids_e = eager(tok, pos)
    check(torch.equal(lane.logits, logits_g) and torch.equal(ids_e, ids_g) and
          all(torch.equal(a, b) for a, b in zip(leaves(lane.cache), cache_g)),
          f"{label}: the graph replay is not bitwise the eager step")
    check(torch.equal(ids_g, torch.from_numpy(
        lane.logits.float().cpu().numpy().argmax(-1))),
          f"{label}: the ids are not np.argmax of the logits")
    del snapshot, cache_g
    print(f"  {label}: graph replay == eager step, bitwise (logits, ids, "
          f"cache); ids == np.argmax(logits)", flush=True)
    # Bound: the params (f32, read once) and the whole cache (read once),
    # against 2 flops per param and token plus attention over the cache.
    hd = cfg.dim // cfg.num_heads
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(lane.cache))
    flops = (2.0 * n_params * lane.slots + 4.0 * lane.slots * cfg.num_layers *
             cfg.num_heads * lane.cache_len * hd)
    bound_ms, bound_by = bound(flops, 4.0 * n_params + cache_bytes)
    graph = timed(torch, lambda: lane._run(tok, pos))
    plain = timed(torch, lambda: eager(tok, pos))
    print(f"  {label}, all {lane.slots} slots busy: device ms per step "
          f"(profiler, {TIMED_CALLS} steps) / host-inclusive ms per step "
          f"(events): graph {graph['ms']:.4f} / {graph['host_ms']:.4f}, eager "
          f"{plain['ms']:.4f} / {plain['host_ms']:.4f}; bound {bound_ms:.4f} "
          f"({bound_by}: {4.0 * n_params / 1e9:.3f} GB f32 params + "
          f"{cache_bytes / 1e9:.3f} GB cache, {flops / 1e9:.1f} GFLOP); bound "
          f"/ graph device {bound_ms / graph['ms']:.3f}; "
          f"{lane.slots / graph['host_ms'] * 1e3:.1f} tokens/s at the graph's "
          f"host-inclusive step on {card}", flush=True)
    print(f"    kernels per graph step: {sum(graph['kernels'].values()):.0f}"
          f", per eager step: {sum(plain['kernels'].values()):.0f}",
          flush=True)
    # A window of 30 steps through lane.step (slot bookkeeping included).
    rng = np.random.RandomState(2)
    for i in range(lane.slots):
        lane.place(DecodeRequest(-1 - i, rng.randint(1, cfg.vocab, 8),
                                 lane.cache_len - 8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        lane.step()
    plain_wall = (time.perf_counter() - t0) * 1e6  # us, as the profile's
    wall, busy, rows = _profile_step(torch, lane.step, n=30)
    lane.evict_all()
    print(f"  {label}: 30 steps through the lane (all slots busy, slot "
          f"bookkeeping included): wall {plain_wall / 30e3:.4f} ms/step "
          f"unprofiled, {wall / 30e3:.4f} profiled; device busy "
          f"{busy / 30e3:.4f} ms/step ({100 * busy / plain_wall:.1f}% of the "
          f"unprofiled wall, {100 * busy / wall:.1f}% of the profiled) on "
          f"{card}", flush=True)
    for us, count, name in rows[:6]:
        print(f"    {us / 30e3:8.4f} ms/step  x{count / 30:<5.1f} "
              f"{name[:90]}", flush=True)


def _state_tensors(torch, state):
    """Every tensor a step updates in place: the params and the
    optimizer's state."""
    from autodist_tpu_torch.utils.tree import leaves
    out = list(leaves(state.params))
    for st in state.opt_state.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _busy_window(torch, step, n=BUSY_WINDOW):
    """(unprofiled wall ms per step, device-busy ms per step) over ``n``
    calls of ``step``: the wall with no profiler (a profiler's own cost on
    a replayed graph distorts it), the busy time from a profiled window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    _, busy, rows = _profile_step(torch, step, n=n)
    return wall, busy / 1e3 / n, rows


def _drive(torch, fa, step_fn, state, batch, steps, device, first=None):
    """``steps`` calls of ``step_fn`` from ``state``: (state, losses, host
    ms per step, flash launches counted over the calls, the params after
    step 1 as clones). ``first`` (the eager path's params after step 1)
    is compared, and only then are this path's kept."""
    from autodist_tpu_torch.utils.tree import leaves
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    _flash_counts(fa, reset=True)  # this path's run
    losses, times, after1 = [], [], None
    for i in range(steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
        if i == 0:
            now = [t.detach() for t in leaves(state.params)]
            after1 = (max((a - b).abs().max().item()
                          for a, b in zip(now, first)) if first is not None
                      else [t.clone() for t in now])
    launches = _flash_counts(fa)
    return state, [float(x) for x in losses], times, launches, after1


def graph_train_run(torch, fa, card, label, runner, batch, steps, device,
                    per_step, flops=None, unroll=None):
    """Phase 7 for one model: the same initial state stepped ``steps``
    times eagerly (``make_callable(batch)``), through
    ``make_callable(batch, aot=True)`` and, with ``unroll``, through
    ``run(..., steps, unroll=unroll)``. Checks the graph paths against the
    eager one and that they replayed their graphs; returns {path: flash
    launches}."""
    dbatch = runner.remapper.shard_batch(batch)  # placed once
    out = {}
    state, eager, times_e, out["eager"], first = _drive(
        torch, fa, runner.make_callable(batch), runner.create_state(),
        dbatch, steps, device)
    check(all(np.isfinite(eager)) and eager[-1] < eager[0],
          f"{label}: eager losses {eager}")
    del state
    aot = runner.make_callable(batch, aot=True)
    state, graphed, times_g, out["aot"], diff1 = _drive(
        torch, fa, aot, runner.create_state(), dbatch, steps, device,
        first=first)
    del first
    rel = [abs(g - e) / abs(e) for g, e in zip(graphed, eager)]
    print(f"  {label}: losses eager {eager[0]:.6f} ... {eager[-1]:.6f}, "
          f"make_callable(aot=True) {graphed[0]:.6f} ... {graphed[-1]:.6f}; "
          f"step 1 loss bitwise equal: {graphed[0] == eager[0]}; max |param "
          f"difference| after step 1 {diff1:.3e}; per-step loss rel. diff "
          f"max {max(rel):.3e} (tol {GRAPH_LOSS_RTOL})", flush=True)
    check(graphed[0] == eager[0], f"{label}: step-1 loss {graphed[0]} vs "
          f"the eager step's {eager[0]}")
    check(max(rel) <= GRAPH_LOSS_RTOL, f"{label}: the aot losses {graphed} "
          f"are off the eager ones {eager}")
    if device == "cuda":
        check(aot.graph.captured and aot.graph.replays == steps - 1,
              f"{label}: make_callable(aot=True) replayed its graph "
              f"{aot.graph.replays} times in {steps} calls")

    # A replay and an eager step from the same state: the loss (computed
    # before the update) bitwise; the params' difference printed.
    tensors = _state_tensors(torch, state)
    snap = [t.detach().clone() for t in tensors]
    state, m_g = aot(state, dbatch)
    after_g = [t.detach().clone() for t in tensors]
    with torch.no_grad():
        for t, v in zip(tensors, snap):
            t.copy_(v)
    state, m_e = runner.make_callable(batch)(state, dbatch)
    pdiff = max((a - t).abs().max().item() for a, t in zip(after_g, tensors))
    print(f"  {label}: one graph replay vs one eager step from the same "
          f"state: loss {float(m_g['loss']):.6f} vs {float(m_e['loss']):.6f}"
          f" (bitwise equal: {bool(torch.equal(m_g['loss'], m_e['loss']))})"
          f", max |state difference| after it {pdiff:.3e}", flush=True)
    check(torch.equal(m_g["loss"], m_e["loss"]), f"{label}: a replay's loss "
          f"is not bitwise the eager step's from the same state")
    del snap, after_g, tensors

    def rate(times):
        steady = times[4:] if len(times) > 4 else times
        med = float(np.median(steady))
        return med, per_step / med * 1e3
    for name, times in (("eager", times_e), ("aot", times_g)):
        med, r = rate(times)
        extra = ""
        if flops:
            tf = 3 * flops / (med / 1e3)
            extra = (f", model FLOP/s {tf / 1e12:.2f} TFLOP/s = "
                     f"{100 * tf / PEAK_BF16_FLOPS:.2f}% of the dense bf16 "
                     f"peak")
        print(f"  {label} {name}: step time, median of steps 5-{steps}: "
              f"{med:.3f} ms (min {min(times[4:]):.3f}, max "
              f"{max(times[4:]):.3f}; step 1 {times[0]:.3f} ms), {r:.1f} "
              f"{'images' if flops else 'samples'}/s{extra} on {card}",
              flush=True)
    if device == "cuda":
        fns = {"eager": runner.make_callable(batch), "aot": aot}
        for name, fn in fns.items():
            def one_step(fn=fn):
                nonlocal state
                state, _ = fn(state, dbatch)
            wall, busy, rows = _busy_window(torch, one_step)
            print(f"  {label} {name}: {BUSY_WINDOW} steps unprofiled "
                  f"{wall:.3f} ms/step, device busy {busy:.3f} ms/step "
                  f"({100 * busy / wall:.1f}% of the unprofiled wall); "
                  f"kernels per step {sum(c for _, c, _ in rows) / BUSY_WINDOW:.0f}"
                  f" on {card}", flush=True)
            for us, count, kname in rows[:5]:
                print(f"    {us / 1e3 / BUSY_WINDOW:8.3f} ms/step  "
                      f"x{count / BUSY_WINDOW:<5.1f} {kname[:90]}",
                      flush=True)
    del state

    if unroll:
        state = runner.create_state()
        _flash_counts(fa, reset=True)  # this path's run
        t = time.perf_counter()
        state, m = runner.run(state, iter([dbatch] * steps), steps,
                              unroll=unroll)
        losses = [float(x) for x in m["loss"]]
        out[f"unroll{unroll}"] = _flash_counts(fa)
        first_ms = (time.perf_counter() - t) * 1e3
        graph = next(iter(runner._graphs.values())).graph
        rel = [abs(g - e) / abs(e) for g, e in zip(losses,
                                                   eager[-unroll:])]
        check(int(state.step) == steps and tuple(m["loss"].shape) ==
              (unroll,) and not bool(m["notfinite"]),
              f"{label}: run(unroll={unroll}) ended at step "
              f"{int(state.step)} with metrics {m}")
        check(max(rel) <= GRAPH_LOSS_RTOL, f"{label}: run(unroll={unroll})'s "
              f"last losses {losses} are off the eager ones "
              f"{eager[-unroll:]}")
        if device == "cuda":
            check(graph.captured and graph.replays == steps // unroll - 1,
                  f"{label}: run(unroll={unroll}) replayed its graph "
                  f"{graph.replays} times in {steps // unroll} dispatches")
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = runner.run(state, iter([dbatch] * steps), steps,
                              unroll=unroll)
        if device == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
        print(f"  {label} run({steps} steps, unroll={unroll}): last losses "
              f"{', '.join(f'{x:.4f}' for x in losses)} (eager steps "
              f"{steps - unroll + 1}-{steps} rel. diff max {max(rel):.3e}); "
              f"{first_ms:.1f} ms with its capture; again, all graphs: "
              f"{ms:.3f} ms/step, {per_step / ms * 1e3:.1f} "
              f"{'images' if flops else 'samples'}/s on {card}", flush=True)
        del state
    return out


def graph_phase(torch, fa, card, bert_cfg, resnet_cfg, device, image=224,
                bert_batch=32, seq=128, num_masked=20, resnet_batch=64,
                steps=20, unroll=GRAPH_UNROLL):
    """Phase 7: the training step as CUDA graphs: BERT MLM (Adam 1e-4,
    ``AllReduce()``) eager / ``make_callable(aot=True)`` / ``run(unroll)``,
    then ResNet (SGD 1e-3, ``AllReduce(chunk_size=128)``) eager / aot with
    the model's bf16 compute and under ``precision="bf16"``; returns
    {path: flash launches}."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert, resnet
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    print(f"phase 7: the step as CUDA graphs; a {bert_cfg.num_layers}-layer "
          f"BERT (MLM, batch {bert_batch} x {seq}, Adam 1e-4) and ResNet "
          f"(stages {resnet_cfg.stage_sizes}, batch {resnet_batch} x {image}"
          f"^2, SGD 1e-3), {steps} steps a path", flush=True)
    paths = {}
    try:
        autodist_mod._reset_default()
        t0 = time.perf_counter()
        params = bert.init(bert_cfg, torch.Generator().manual_seed(0),
                           device=device)
        batch = bert.synthetic_batch(bert_cfg, bert_batch, seq, num_masked,
                                     seed=0)
        ad = AutoDist(strategy_builder=AllReduce(), device=device)
        runner = ad.create_distributed_session(ad.capture(
            bert.make_loss_fn(bert_cfg), params,
            functools.partial(torch.optim.Adam, lr=1e-4),
            example_batch=batch))
        del params
        if device == "cuda":
            check(torch.distributed.get_backend() == "nccl",
                  "not an NCCL world")
        print(f"  BERT set-up {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        got = graph_train_run(torch, fa, card, "BERT", runner, batch, steps,
                              device, bert_batch, unroll=unroll)
        print(f"  BERT paths {time.perf_counter() - t0:.1f}s", flush=True)
        for path, counts in got.items():
            for name, n in counts.items():
                check(n == bert_cfg.num_layers * steps,
                      f"BERT {path}: {name} launched {n} times, expected "
                      f"{bert_cfg.num_layers} x {steps}")
            paths["graph_bert_" + path] = counts
        print(f"  BERT flash launches by path (eager warm-up + replays on "
              f"the graph paths): {got}", flush=True)
        del runner
        for precision in (None, "bf16"):
            ad = _zoo_world(torch, device)
            rbatch = resnet.synthetic_batch(resnet_batch, image,
                                            resnet_cfg.num_classes)
            item = ad.capture(resnet.make_loss_fn(resnet_cfg),
                              resnet.init(resnet_cfg,
                                          torch.Generator().manual_seed(0),
                                          device=device),
                              functools.partial(torch.optim.SGD, lr=1e-3),
                              example_batch=rbatch, precision=precision)
            runner = ad.create_distributed_session(item)
            label = f"ResNet precision={precision!r}"
            t0 = time.perf_counter()
            got = graph_train_run(torch, fa, card, label, runner, rbatch,
                                  steps, device, resnet_batch,
                                  flops=item.flops_estimate())
            print(f"  {label} paths {time.perf_counter() - t0:.1f}s",
                  flush=True)
            for path, counts in got.items():
                check(not any(counts.values()), f"{label} {path}: flash "
                      f"kernels launched in a model without attention: "
                      f"{counts}")
                paths[f"graph_resnet{'_bf16' if precision else ''}_"
                      f"{path}"] = counts
            del runner, item
    finally:
        autodist_mod._reset_default()
    return paths


def strategy_run(torch, fa, cfg, device, label, builder, batch, steps,
                 aot=False, kinds=("ar",), backend="nccl", optimizer="Adam",
                 lr=1e-4):
    """``steps`` steps of BERT under one builder, eagerly or through
    ``make_callable(aot=True)``: checks the lowering (the set of variable
    kinds: on one rank every variable takes the replicated update, a stale
    one the local update), finite falling losses, every param changed and
    a launch of each flash kernel per layer and step; returns the losses,
    flash launches, host ms per step, runner, state, step function, and
    the initial and final logical params by name. The world is a fresh
    one-rank world unless the caller started one; BERT MLM (``optimizer``
    of ``torch.optim`` at ``lr``) from the seeded init; ``builder`` None
    is ``AutoDist()``'s default."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    autodist_mod._reset_default()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    ad = AutoDist(strategy_builder=builder, device=device)
    runner = ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(cfg), params,
        functools.partial(getattr(torch.optim, optimizer), lr=lr),
        example_batch=batch))
    if device == "cuda":
        world = torch.distributed.get_backend()
        check(world == backend, f"{label}: a {world} world, not {backend}")
    init = flatten_params(params)
    del params
    got = {k for k, _ in runner.var_kinds.values()}
    check(got == set(kinds), f"{label}: variable kinds {got}, expected "
          f"{set(kinds)}")
    if runner.program.data_axis_size == 1:
        check(not runner.program.paddings(), f"{label}: padded storage on "
              f"a one-rank world")
    dbatch = runner.remapper.shard_batch(batch)
    step_fn = runner.make_callable(batch, aot=aot)
    state, losses, times, launches, _ = _drive(
        torch, fa, step_fn, runner.create_state(), dbatch, steps, device)
    after = flatten_params(runner.logical_params(state))
    unchanged = [n for n, t in init.items() if torch.equal(t, after[n])]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: losses {losses}")
    check(not unchanged, f"{label}: params unchanged: {unchanged}")
    for name, n in launches.items():
        check(n == cfg.num_layers * steps, f"{label}: {name} launched {n} "
              f"times, expected {cfg.num_layers} x {steps}")
    if aot and device == "cuda":
        check(step_fn.graph.captured and step_fn.graph.replays == steps - 1,
              f"{label}: the aot step replayed {step_fn.graph.replays} "
              f"times in {steps} calls")
    return types.SimpleNamespace(
        losses=losses, launches=launches, times=times, runner=runner,
        state=state, step_fn=step_fn, init=init, params=after)


def update_error(torch, got, ref, init):
    """The relative L2 error of a run's whole update, ||got - ref|| /
    ||ref - init|| over all params (by name) together. Unlike the loss
    under Adam, it sees a gradient off by a constant factor under SGD.
    Not per param: some gradients are zero but for roundings (the
    attention key bias shifts each score row by a constant, which the
    softmax cancels), and their updates are all noise."""
    diff = sum(float((got[n].float() - ref[n].float()).square().sum())
               for n in ref)
    step = sum(float((ref[n].float() - init[n].float()).square().sum())
               for n in ref)
    return (diff / step) ** 0.5


def strategy_phase(torch, fa, card, cfg, device, batch_size=32, seq=128,
                   num_masked=20, steps=STRATEGY_STEPS,
                   graph_steps=STRATEGY_GRAPH_STEPS):
    """Phase 8: BERT MLM under every ported strategy builder on a one-rank
    world, each run from the seeded init on the same batch: eagerly under
    ``AutoDist()`` (PS) and the other builders, held to ``AllReduce()``'s
    eager steps; ``Parallax()`` (BASELINE's BERT configuration) through
    ``make_callable(aot=True)``, held to ``AllReduce()``'s aot steps, and
    both timed. Returns {path: flash launches}."""
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    print(f"phase 8: strategy builders; a {cfg.num_layers}-layer, width "
          f"{cfg.dim} BERT (MLM, batch {batch_size} x {seq}, Adam 1e-4) on "
          f"a one-rank world, {steps} eager steps a builder, {graph_steps} "
          f"aot steps for AllReduce and Parallax", flush=True)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    env = os.environ.pop("AUTODIST_STRATEGY", None)  # AutoDist() -> PS()
    paths = {}

    def rel_diff(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))

    def held(label, losses, ref, rtol):
        rel = rel_diff(losses, ref)
        print(f"  {label}: losses {', '.join(f'{x:.6f}' for x in losses)}; "
              f"step 1 bitwise AllReduce's: {losses[0] == ref[0]}, max rel. "
              f"diff {rel:.3e} (tol {rtol})", flush=True)
        check(losses[0] == ref[0], f"{label}: step-1 loss {losses[0]} vs "
              f"AllReduce's {ref[0]}")
        check(rel <= rtol, f"{label}: losses {losses} vs AllReduce's {ref}")

    def bracket(label, ref, aot, rtol):
        """AllReduce() again (the floor: two runs of one program) and at
        twice the learning rate (a planted fault: the update doubled),
        both against ``ref``: the tolerance must lie between them."""
        runs = [strategy_run(torch, fa, cfg, device, f"AllReduce() {label}"
                             f"{tag}", S.AllReduce(), batch,
                             len(ref), aot=aot, lr=lr).losses
                for tag, lr in (("", 1e-4), (" at lr 2e-4", 2e-4))]
        floor, fault = (rel_diff(r, ref) for r in runs)
        print(f"  AllReduce() {label}: again from the same init max rel. "
              f"diff {floor:.3e}, at lr 2e-4 (the update doubled) "
              f"{fault:.3e}; tol {rtol}", flush=True)
        check(floor <= rtol < fault, f"AllReduce() {label}: the tolerance "
              f"{rtol} does not lie between the floor {floor} and the "
              f"planted fault {fault}")
    try:
        t0 = time.perf_counter()
        run = strategy_run(torch, fa, cfg, device, "AllReduce()",
                           S.AllReduce(), batch, steps)
        ref, paths["strategy_allreduce"] = run.losses, run.launches
        del run
        print(f"  AllReduce(): losses {', '.join(f'{x:.6f}' for x in ref)}"
              f" ({time.perf_counter() - t0:.1f}s with set-up)", flush=True)
        bracket("eager", ref, False, STRATEGY_LOSS_RTOL)
        for key, label, builder, kinds in (
                ("ps", "AutoDist() = PS()", None, ("ar",)),
                ("ps_lb", "PSLoadBalancing()", S.PSLoadBalancing(), ("ar",)),
                ("partitioned_ps", "PartitionedPS()", S.PartitionedPS(),
                 ("ar",)),
                ("uneven_ps", "UnevenPartitionedPS()",
                 S.UnevenPartitionedPS(), ("ar",)),
                ("partitioned_ar", "PartitionedAR()", S.PartitionedAR(),
                 ("ar",)),
                ("random_axis_ar", "RandomAxisPartitionAR()",
                 S.RandomAxisPartitionAR(), ("ar",)),
                ("ps_stale2", "PS(staleness=2)", S.PS(staleness=2),
                 ("stale",))):
            run = strategy_run(torch, fa, cfg, device, label, builder, batch,
                               steps, kinds=kinds)
            if builder is None:
                check(all(n.WhichOneof("synchronizer") == "ps_synchronizer"
                          for n in run.runner.program.strategy.node_config),
                      "AutoDist() did not build PS()")
            held(label, run.losses, ref, STRATEGY_LOSS_RTOL)
            paths["strategy_" + key] = run.launches
            del run
        timings = {}
        for key, label, builder in (("allreduce", "AllReduce()",
                                     S.AllReduce()),
                                    ("parallax", "Parallax()",
                                     S.Parallax())):
            run = strategy_run(torch, fa, cfg, device, label + " aot",
                               builder, batch, graph_steps, aot=True)
            if label == "AllReduce()":
                graph_ref = run.losses
                bracket("aot", graph_ref, True, STRATEGY_GRAPH_RTOL)
            else:
                node = run.runner.program.strategy.node_by_name(
                    "embed/embedding")
                check(node.WhichOneof("synchronizer") == "ps_synchronizer",
                      "Parallax() did not send the embedding table to PS")
                held("Parallax() aot vs AllReduce() aot", run.losses,
                     graph_ref, STRATEGY_GRAPH_RTOL)
            paths[f"strategy_{key}_aot"] = run.launches
            med = float(np.median(run.times[4:]))
            line = (f"  {label} make_callable(aot=True): median host step "
                    f"(steps 5-{graph_steps}) {med:.3f} ms")
            if device == "cuda":
                dbatch = run.runner.remapper.shard_batch(batch)
                state = run.state

                def one_step(fn=run.step_fn):
                    nonlocal state
                    state, _ = fn(state, dbatch)
                wall, busy, rows = _busy_window(torch, one_step)
                timings[label] = (wall, busy)
                line += (f"; {BUSY_WINDOW} steps unprofiled {wall:.3f} "
                         f"ms/step (host-inclusive), device busy {busy:.3f} "
                         f"ms/step ({100 * busy / wall:.1f}%), "
                         f"{batch_size / wall * 1e3:.1f} samples/s")
                del state
            print(line + f" on {card}", flush=True)
            del run
        if timings:
            (w_ar, b_ar), (w_px, b_px) = (timings["AllReduce()"],
                                          timings["Parallax()"])
            print(f"  Parallax() / AllReduce() aot step: host-inclusive "
                  f"{w_px:.3f} / {w_ar:.3f} ms ({w_px / w_ar:.3f}x), device "
                  f"{b_px:.3f} / {b_ar:.3f} ms ({b_px / b_ar:.3f}x) on {card}",
                  flush=True)
    finally:
        autodist_mod._reset_default()
        if env is not None:
            os.environ["AUTODIST_STRATEGY"] = env
    return paths


def graph_serve_phase(torch, fa, card, cfg, device, requests=16, clients=4):
    """Phase 7, serving: phase 3's traffic on the port's Server, whose
    warmed buckets (4, 8) are CUDA graphs; returns the flash launches."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T

    seq = cfg.max_len
    print(f"phase 7: serve.Server on a {cfg.num_layers}-layer BERT at seq "
          f"{seq}, buckets (4, 8), one CUDA graph each", flush=True)
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()

    ids, seg, _, _ = bert.synthetic_batch(cfg, 8, seq, seed=0)
    rng = np.random.RandomState(1)  # phase 3's requests
    work = []
    for _ in range(requests):
        rows = int(rng.randint(1, 9))
        work.append((rng.randint(0, cfg.vocab, (rows, seq)).astype(np.int32),
                     rng.randint(0, 2, (rows, seq)).astype(np.int32)))
    answers, kept, latencies = ([None] * requests for _ in range(3))
    fa.flash_fwd.launches = 0  # main path: engine build + traffic
    srv = serve.Server(apply_fn, params, (ids, seg), buckets=(4, 8),
                       max_wait_ms=5, device=device)
    try:
        replica = srv.engine.replicas[0]
        graphs = replica.graphs
        warmups = len(graphs)
        if device == "cuda":
            check(all(g.captured for g in graphs.values()),
                  f"a warmed bucket has no CUDA graph: {graphs}")
        dispatched = []
        run_bucket = replica.run_bucket

        def recording(batch):
            host = run_bucket(batch)
            dispatched.append(([t.clone() for t in batch], host))
            return host
        replica.run_bucket = recording

        def client(c):
            for i in range(c, requests, clients):
                t = time.perf_counter()
                answers[i] = srv.submit(work[i]).result(timeout=300)
                latencies[i] = (time.perf_counter() - t) * 1e3
                kept[i] = answers[i].clone()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "clients hung")
        check(all(a is not None for a in answers), "a request got no answer")
        replica.run_bucket = run_bucket
        launches = fa.flash_fwd.launches
        replays = sum(g.replays for g in graphs.values())
        stats = srv.stats()
        dispatches = sum(r["dispatches"] for r in stats["replicas"])
        print(f"  {stats['completed']} requests in {dispatches} dispatches, "
              f"{replays} graph replays + {warmups} warm-ups; flash_fwd "
              f"launches {launches}", flush=True)
        check(stats["completed"] == requests, "requests lost")
        if device == "cuda":
            check(replays == dispatches == len(dispatched),
                  f"{dispatches} dispatches but {replays} graph replays")
        check(launches == cfg.num_layers * (dispatches + warmups),
              f"flash_fwd launched {launches} times, expected "
              f"{cfg.num_layers} x ({dispatches} replays + {warmups} "
              f"warm-ups)")
        with torch.inference_mode():
            for batch, host in dispatched:
                eager = replica._forward(batch).cpu()
                check(torch.equal(host, eager), "a bucket graph's answer is "
                      "not bitwise the eager forward of the same padded "
                      "batch")
        check(all(torch.equal(a, k) for a, k in zip(answers, kept)),
              "an answer changed after later dispatches")
        p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
        print(f"  every dispatch's answer bitwise the eager forward of its "
              f"padded batch ({len(dispatched)} dispatches); every answer "
              f"unchanged after later dispatches; client p50 {p50:.3f} ms, "
              f"p99 {p99:.3f} ms (4 threads, rows 1-8) on {card}",
              flush=True)
        if device == "cuda":
            _dtoh_before_after(torch, card, srv, replica, (ids, seg))
    finally:
        srv.close()
    return launches


def _dtoh_before_after(torch, card, srv, replica, batch, n=6):
    """Wall and device time per full-bucket request, and its ``Memcpy
    DtoH``: the eager forward with a pageable ``.cpu()`` (before) against
    the Server's graph replay and pinned fetch (after)."""
    from torch.profiler import ProfilerActivity, profile
    placed = replica.remapper.shard_batch(batch)

    def before():
        with torch.inference_mode():
            replica._forward(placed).cpu()

    def after():
        srv.infer(batch, timeout=300)
    for label, fn in (("before: eager forward, pageable .cpu()", before),
                      ("after: Server, graph replay, pinned fetch", after)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        events = _device_events(prof)
        busy = sum(_device_us(e) for e in events) / 1e3 / n
        dtoh = sum(_device_us(e) for e in events
                   if "Memcpy DtoH" in e.key) / 1e3 / n
        kinds = sorted({e.key for e in events if "Memcpy DtoH" in e.key})
        print(f"  {label}, 8 x {batch[0].shape[1]}: wall {wall:.3f} "
              f"ms/request (profiled), device {busy:.3f} ms/request, "
              f"Memcpy DtoH {dtoh:.3f} ms/request ({', '.join(kinds)}) on "
              f"{card}", flush=True)


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


# Phase 8's two-rank sub-phase: gloo ranks on the one card (NCCL refuses
# two ranks on one device; gloo takes CUDA tensors for all_reduce,
# reduce_scatter_tensor and all_gather_into_tensor, PERF.md) train BERT at
# BERT-base width and bert_tiny's depth under builders that split
# variables over the data axis, each rank on its half of the batch, held
# to one rank's AllReduce steps on the whole batch. SGD, not Adam: Adam's
# update does not see a gradient off by a constant factor (a missing / n
# in the reduce-scatter), SGD's does. Both the losses and the params'
# update are held: the update's relative L2 error (``update_error``) at
# GLOO_UPDATE_RTOL, which one rank's AllReduce at twice the learning rate
# (the gradient doubled, a missing / 2) must exceed. The model computes in
# bf16: each rank's weight gradients are rounded to bf16 over its half of
# the tokens before the f32 mean, where one rank rounds once over all of
# them, so the runs part by bf16 roundings. Read on an H100: losses within
# 5.7e-5, update errors 3.9e-3 to 4.8e-3; the doubled gradient 2.2e-2 and
# 0.94.
GLOO_WORLD, GLOO_LAYERS, GLOO_LR = 2, 2, 0.1
GLOO_UPDATE_RTOL = 5e-2
GLOO_BUILDERS = (("parallax", "Parallax", ("ar", "fsdp")),
                 ("partitioned_ps", "PartitionedPS", ("fsdp",)),
                 ("ps", "PS", ("zero1",)))


def _gloo_cfg(cfg):
    small = copy.copy(cfg)
    small.num_layers = GLOO_LAYERS
    return small


def gloo_train_rank(rank, world, port, spec):
    """One rank of :func:`gloo_strategy_phase`: a gloo world over
    ``localhost`` on device 0 (``spec``: device, config, batch, steps and
    the one-rank reference's final params' file as JSON); for each builder
    of ``GLOO_BUILDERS`` ``steps`` eager SGD steps on this rank's rows.
    Prints {builder: losses, launches, mesh, the update's error against the
    reference, a digest of the logical params}."""
    import datetime
    import hashlib
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    fields = dict(spec["config"], dtype=getattr(torch, spec["dtype"]))
    cfg = T.TransformerConfig(**fields)
    batch = bert.synthetic_batch(cfg, spec["batch"], spec["seq"],
                                 spec["masked"], seed=0)
    ref = torch.load(spec["ref"], map_location=device)
    local = spec["batch"] // world
    mine = tuple(a[rank * local:(rank + 1) * local] for a in batch)
    out = {"rank": rank}
    for key, builder, kinds in GLOO_BUILDERS:
        run = strategy_run(torch, fa, cfg, device, f"rank {rank} {builder}()",
                           getattr(S, builder)(), mine, spec["steps"],
                           kinds=kinds, backend="gloo", optimizer="SGD",
                           lr=GLOO_LR)
        digest = hashlib.sha256()
        for name, t in sorted(run.params.items()):
            digest.update(t.detach().float().cpu().numpy().tobytes())
        err = update_error(torch, run.params, ref, run.init)
        out[key] = {"losses": run.losses, "launches": run.launches,
                    "mesh": dict(run.runner.program.mesh.shape),
                    "update_error": err,
                    "digest": digest.hexdigest()}
        del run
    autodist_mod._reset_default()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def gloo_strategy_phase(torch, fa, card, cfg, device, batch_size=32,
                        seq=128, num_masked=20, steps=STRATEGY_STEPS):
    """Phase 8, two ranks: ``GLOO_WORLD`` gloo ranks (processes of this
    script) on the one card train ``cfg`` at ``GLOO_LAYERS`` layers under
    ``GLOO_BUILDERS``, so the ZeRO-1 and split-parameter lowerings run
    beside the kernels on the device; each builder's losses and updates
    are held to one rank's ``AllReduce()`` run on the whole batch, the
    ranks' params must agree bitwise, and each rank's flash kernels launch
    once per layer and step. Returns {path: flash launches, summed over
    the ranks}."""
    import socket
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.ops import build
    small = _gloo_cfg(cfg)
    print(f"phase 8, {GLOO_WORLD} gloo ranks on one device: a "
          f"{small.num_layers}-layer, width {small.dim} BERT (batch "
          f"{batch_size} x {seq}, {batch_size // GLOO_WORLD} rows a rank, "
          f"SGD {GLOO_LR}), {steps} eager steps under " +
          ", ".join(f"{b}()" for _, b, _ in GLOO_BUILDERS), flush=True)
    batch = bert.synthetic_batch(small, batch_size, seq, num_masked, seed=0)
    try:
        ref = strategy_run(torch, fa, small, device, "one rank AllReduce()",
                           S.AllReduce(), batch, steps, optimizer="SGD",
                           lr=GLOO_LR)
        fault = strategy_run(torch, fa, small, device,
                             "one rank AllReduce() at twice the lr",
                             S.AllReduce(), batch, steps, optimizer="SGD",
                             lr=2 * GLOO_LR)
    finally:
        autodist_mod._reset_default()
    fault_err = update_error(torch, fault.params, ref.params, ref.init)
    fault_rel = max(abs(a - b) / abs(b)
                    for a, b in zip(fault.losses, ref.losses))
    print(f"  one rank AllReduce() at lr {2 * GLOO_LR} (the gradient "
          f"doubled) vs at {GLOO_LR}: max rel. loss diff {fault_rel:.3e}, "
          f"update error {fault_err:.3e} (tol {GLOO_UPDATE_RTOL})",
          flush=True)
    check(fault_err > GLOO_UPDATE_RTOL and fault_rel > STRATEGY_LOSS_RTOL,
          f"a doubled gradient reads within the tolerances: update error "
          f"{fault_err}, loss {fault_rel}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    torch.save({n: t.detach().cpu() for n, t in ref.params.items()},
               ref_path)
    ref_losses = ref.losses
    del ref, fault
    fields = {k: v for k, v in vars(small).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(small.dtype).split(".")[-1], "seq": seq,
                       "batch": batch_size, "masked": num_masked,
                       "steps": steps, "ref": ref_path})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-train", str(r),
         str(GLOO_WORLD), str(port), spec], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(GLOO_WORLD)]
    ranks = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"a gloo rank exited with "
                  f"{p.returncode}: {err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        tmp.cleanup()
    paths = {}
    for key, builder, kinds in GLOO_BUILDERS:
        expr = f"{builder}()"
        got = [r[key] for r in ranks]
        losses = got[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        print(f"  {expr} on {GLOO_WORLD} ranks (mesh {got[0]['mesh']}, kinds "
              f"{'/'.join(kinds)}): losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}; one rank "
              f"AllReduce() {', '.join(f'{x:.6f}' for x in ref_losses)}; max "
              f"rel. diff {rel:.3e} (tol {STRATEGY_LOSS_RTOL}); update error "
              f"{got[0]['update_error']:.3e} (tol {GLOO_UPDATE_RTOL}); params "
              f"equal on every rank: "
              f"{len({g['digest'] for g in got}) == 1}; flash launches per "
              f"rank {got[0]['launches']}", flush=True)
        check(all(g["losses"] == losses for g in got),
              f"{expr}: the ranks' losses differ: {got}")
        check(rel <= STRATEGY_LOSS_RTOL, f"{expr}: losses {losses} vs "
              f"one rank's {ref_losses}")
        check(got[0]["update_error"] <= GLOO_UPDATE_RTOL,
              f"{expr}: update error {got[0]['update_error']}")
        check(len({g["digest"] for g in got}) == 1,
              f"{expr}: the ranks' params differ")
        check(all(g["mesh"] == {"data": GLOO_WORLD} for g in got),
              f"{expr}: mesh {got[0]['mesh']}")
        paths[f"strategy_gloo{GLOO_WORLD}_{key}"] = {
            k: sum(g["launches"][k] for g in got) for k in got[0]["launches"]}
    return paths


# Phase 9: training that survives (checkpoint/ and resilience/).

def weighted_mlm_loss(cfg):
    """BERT's MLM loss times the mean of the batch's float masked-LM
    weights (BERT's pretraining input carries them; all 1 here, so the loss
    is bitwise the plain one): the float leaf ``AUTODIST_CHAOS=nan_at``
    poisons (it poisons only float leaves, and token ids are ints)."""
    from autodist_tpu_torch.models import bert
    base = bert.make_loss_fn(cfg)

    def loss_fn(params, batch):
        return base(params, tuple(batch[:4])) * batch[4].mean()
    return loss_fn


def weighted_batches(cfg, seeds, batch_size, seq, num_masked):
    """BERT's synthetic batches (one per seed) with MLM weights of 1."""
    from autodist_tpu_torch.models import bert
    return [bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=s) +
            (np.ones((batch_size, num_masked), np.float32),) for s in seeds]


def _bert_runner(torch, cfg, device, batch, params=None):
    """A fresh one-rank AllReduce() world training BERT (MLM weighted as
    above, Adam 1e-4) from ``params`` (default: the seeded init; a runner
    copies them and never writes them)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    if params is None:
        params = bert.init(cfg, torch.Generator().manual_seed(0),
                           device=device)
    return ad.create_distributed_session(ad.capture(
        weighted_mlm_loss(cfg), params,
        functools.partial(torch.optim.Adam, lr=1e-4), example_batch=batch))


def _resnet_runner(torch, cfg, device, batch):
    """A fresh ResNet world (SGD 1e-3, AllReduce(chunk_size=128)) from the
    seeded init."""
    from autodist_tpu_torch.models import resnet
    ad = _zoo_world(torch, device)
    return ad.create_distributed_session(ad.capture(
        resnet.make_loss_fn(cfg),
        resnet.init(cfg, torch.Generator().manual_seed(0), device=device),
        functools.partial(torch.optim.SGD, lr=1e-3), example_batch=batch))


def _blocks(run, state, start, end, unroll):
    """Drive ``run(state, n)`` (a call that takes the state to step ``n``)
    one K-step block at a time from ``start`` to ``end``: (state, the
    per-step losses)."""
    losses = []
    for n in range(start + unroll, end + 1, unroll):
        state, metrics = run(state, n)
        losses += [float(x) for x in metrics["loss"].reshape(-1)]
    return state, losses


def _logical_named(runner, state):
    """The checkpoint form by name, on the host."""
    from autodist_tpu_torch.checkpoint.manifest import state_tree
    return {k: t.detach().cpu() for k, t in
            flatten_params(state_tree(runner.to_logical(state))).items()}


def _raw_named(path):
    from autodist_tpu_torch.checkpoint.saver import read_tree
    return flatten_params(read_tree(path))


def _same(torch, got, want):
    """Names whose tensors differ (dtype or bits)."""
    return sorted(set(got) ^ set(want)) + [
        n for n in want if n in got and (got[n].dtype != want[n].dtype or
                                         not torch.equal(got[n], want[n]))]


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _graph_of(runner):
    """The runner's one megastep graph (its phase-0 Graph)."""
    (step,) = runner._graphs.values()
    return step.graphs[0]


def _timed(torch, device, fn):
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _save_restore_rates(torch, card, label, runner, state, directory, device):
    """Host-inclusive save and restore (into the live state) of one
    checkpoint: prints bytes, ms and GB/s; returns the state."""
    from autodist_tpu_torch.checkpoint import Saver
    path = os.path.join(directory, f"{label}-timed")
    _, save_ms = _timed(torch, device, lambda: Saver(runner).save(state, path))
    nbytes = os.path.getsize(os.path.join(path, "arrays.bin"))
    state, restore_ms = _timed(
        torch, device, lambda: Saver(runner).restore(path, into=state))
    print(f"  {label} checkpoint: {nbytes} bytes ({nbytes / 1e9:.3f} GB); "
          f"save {save_ms:.1f} ms ({nbytes / save_ms / 1e6:.2f} GB/s), "
          f"restore into the live state {restore_ms:.1f} ms "
          f"({nbytes / restore_ms / 1e6:.2f} GB/s), host-inclusive, on "
          f"{card}", flush=True)
    shutil.rmtree(path)
    return state


def resilience_guard_run(torch, fa, card, cfg, device, batch, directory,
                         init):
    """(a) BERT's graph step under ``CheckpointManager.run`` with a
    ``StepGuard`` and ``AUTODIST_CHAOS=nan_at``: exactly one rollback
    (into the graph's own tensors, no new capture), no retained step with
    non-finite params, finite falling losses, every leaf of the newest
    step (Adam's ``step`` included) bitwise the live state's. Returns
    (runner, state, flash launches)."""
    from autodist_tpu_torch import resilience
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.resilience import StepGuard, chaos
    runner = _bert_runner(torch, cfg, device, batch, init)
    dbatch = runner.remapper.shard_batch(batch)
    mgr = CheckpointManager(runner, directory,
                            save_interval_steps=RESIL_INTERVAL, max_to_keep=3)
    guard = StepGuard(check_every=RESIL_CHECK, max_strikes=3)
    resilience.clear_events()
    chaos.reset()
    os.environ["AUTODIST_CHAOS"] = f"nan_at={RESIL_NAN_AT}"
    _flash_counts(fa, reset=True)  # this path's run
    try:
        data = iter(lambda: dbatch, None)
        state, first = mgr.run(mgr.restore_or_init(), data, RESIL_UNROLL,
                               step_guard=guard, unroll=RESIL_UNROLL)
        graph = _graph_of(runner)
        state, last = mgr.run(state, data, RESIL_STEPS, step_guard=guard,
                              unroll=RESIL_UNROLL)
    finally:
        del os.environ["AUTODIST_CHAOS"]
        chaos.reset()
    launches = _flash_counts(fa)
    events = [(k, d) for _, k, d in resilience.events()]
    first, last = ([float(x) for x in m["loss"]] for m in (first, last))
    print(f"  (a) {RESIL_STEPS} steps, {RESIL_UNROLL} a CUDA graph, save "
          f"every {RESIL_INTERVAL}, guard every {RESIL_CHECK}, nan_at="
          f"{RESIL_NAN_AT}: rollbacks {guard.rollbacks}, events {events}; "
          f"retained steps {mgr.all_steps()}; losses first block "
          f"{first}, last {last}; graph captured once, replays "
          f"{graph.replays}; flash launches {launches}", flush=True)
    dispatched = RESIL_STEPS // RESIL_UNROLL + 1  # + the poisoned block
    check(guard.rollbacks == 1 and ("chaos:nan", f"poisoned batch at step "
          f"{RESIL_NAN_AT}") in events,
          f"(a): {guard.rollbacks} rollbacks, events {events}")
    seen = -(-RESIL_NAN_AT // RESIL_UNROLL) * RESIL_UNROLL  # block's end
    check(("rollback", f"divergence at step {seen}: restored step "
           f"{(seen - 1) // RESIL_INTERVAL * RESIL_INTERVAL} (strike 1/3)")
          in events, f"(a): rollback events {events}")
    check(int(state.step) == RESIL_STEPS, f"(a) ended at {int(state.step)}")
    check(all(np.isfinite(first + last)) and max(last) < min(first),
          f"(a): losses {first} ... {last}")
    check(_graph_of(runner) is graph and len(runner._graphs) == 1 and
          (device != "cuda" or graph.replays == dispatched - 1),
          f"(a): the rollback recaptured: {runner._graphs}")
    for name, n in launches.items():
        check(n == cfg.num_layers * dispatched * RESIL_UNROLL,
              f"(a): {name} launched {n} times, expected {cfg.num_layers} "
              f"x {dispatched * RESIL_UNROLL}")
    steps = mgr.all_steps()
    check(steps == list(range(RESIL_STEPS - 2 * RESIL_INTERVAL,
                              RESIL_STEPS + 1, RESIL_INTERVAL)),
          f"(a): retained steps {steps}")
    for step in steps:
        raw = _raw_named(os.path.join(directory, str(step)))
        bad = [n for n, t in raw.items() if n.startswith("params/")
               and not torch.isfinite(t).all()]
        check(not bad, f"(a): retained step {step} holds non-finite {bad}")
    diff = _same(torch, _raw_named(os.path.join(directory, str(steps[-1]))),
                 _logical_named(runner, state))
    check(not diff, f"(a): the saved step {steps[-1]} differs from the live "
          f"state at {diff[:5]}")
    adam = next(iter(state.opt_state.state.values()))["step"]
    print(f"  (a) step {steps[-1]}: every leaf bitwise the live state's "
          f"({len(raw)} leaves; Adam's step {float(adam)} on "
          f"{adam.device})", flush=True)
    if device == "cuda":
        check(adam.device.type == "cuda", f"(a): Adam's step on {adam.device}")
    return runner, state, launches


def resilience_resume(torch, fa, card, label, make_runner, batches,
                      directory, device, fault=None):
    """(a) / (b): an uninterrupted run of ``RESIL_RESUME_STEPS`` graph steps
    (K a graph) under ``CheckpointManager.run`` saving every
    ``RESIL_RESUME_FROM``, the same again (the floor), then (d) its newest
    step truncated, a fresh Runner's ``restore_or_init`` falling back to
    step ``RESIL_RESUME_FROM`` (every leaf bitwise the saved one) and
    resuming to the end, and with ``fault`` (a function of the restored
    state) the planted fault from the same step. Returns {"floor",
    "resume", "fault": max rel. loss differences over the resumed steps,
    "launches": the resumed run's flash launches, "params": bitwise or
    not}."""
    from autodist_tpu_torch import resilience
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.resilience import chaos
    n, k, at = RESIL_RESUME_STEPS, RESIL_UNROLL, RESIL_RESUME_FROM
    runner = make_runner()
    dbatches = [runner.remapper.shard_batch(b) for b in batches]

    def stream(start):
        return iter(dbatches[i % len(dbatches)] for i in range(start, n))

    mgr = CheckpointManager(runner, directory, save_interval_steps=at,
                            max_to_keep=3)
    data = stream(0)
    state, ref = _blocks(lambda s, m: mgr.run(s, data, m, unroll=k),
                         mgr.restore_or_init(), 0, n, k)
    ref_params = flatten_params(runner.logical_params(state))
    ref_params = {name: t.detach().clone() for name, t in ref_params.items()}
    data = stream(0)
    state, again = _blocks(lambda s, m: runner.run(s, data, k, unroll=k),
                           runner.create_state(), 0, n, k)
    floor = _rel(again[at:], ref[at:])
    # Update errors over the resumed steps: ||p - p_ref|| / ||p_ref - p_at||.
    at_params = {name[len("params/"):]: t for name, t in _raw_named(
        os.path.join(directory, str(at))).items() if name.startswith(
            "params/")}

    def update(params):
        return update_error(torch, {name: t.detach().cpu() for name, t in
                                    flatten_params(params).items()},
                            {name: t.cpu() for name, t in ref_params.items()},
                            at_params)
    floor_update = update(runner.logical_params(state))
    del state
    check(mgr.all_steps() == [k, at, n], f"{label}: steps {mgr.all_steps()}")
    check(chaos.truncate_checkpoint(directory) == n, f"{label}: truncation")
    runner = make_runner()  # a fresh Runner in a fresh world
    resilience.clear_events()
    mgr = CheckpointManager(runner, directory, save_interval_steps=at,
                            max_to_keep=3)
    state = mgr.restore_or_init()
    fell = [d for _, kind, d in resilience.events() if kind == "ckpt-fallback"]
    check(int(state.step) == at and len(fell) == 1,
          f"{label}: restore_or_init gave step {int(state.step)}, fallbacks "
          f"{fell}")
    diff = _same(torch, _logical_named(runner, state),
                 _raw_named(os.path.join(directory, str(at))))
    check(not diff, f"{label}: restored leaves differ from step {at}'s: "
          f"{diff[:5]}")
    dbatches = [runner.remapper.shard_batch(b) for b in batches]
    _flash_counts(fa, reset=True)  # the resumed run
    data = stream(at)
    state, resumed = _blocks(lambda s, m: mgr.run(s, data, m, unroll=k),
                             state, at, n, k)
    launches = _flash_counts(fa)
    got = flatten_params(runner.logical_params(state))
    params_equal = all(torch.equal(got[name], t)
                       for name, t in ref_params.items())
    out = {"floor": floor, "resume": _rel(resumed, ref[at:]),
           "launches": launches, "params": params_equal,
           "floor_update": floor_update,
           "resume_update": update(runner.logical_params(state))}
    print(f"  {label}: uninterrupted losses {ref[0]:.6f} ... {ref[-1]:.6f}; "
          f"(d) newest step {n} truncated -> restore_or_init fell back to "
          f"step {at} (every leaf bitwise); resumed steps {at + 1}-{n} vs "
          f"the uninterrupted run: max rel. loss diff {out['resume']:.3e} "
          f"(bitwise: {resumed == ref[at:]}), final params bitwise: "
          f"{params_equal}; floor (the same program again) {floor:.3e}; "
          f"update error over steps {at + 1}-{n}: resumed "
          f"{out['resume_update']:.3e}, floor {floor_update:.3e}",
          flush=True)
    if fault is not None:
        state = mgr.restore_or_init(into=state)
        graph = _graph_of(runner)
        fault(state)
        data = stream(at)
        state, faulty = _blocks(lambda s, m: mgr.run(s, data, m, unroll=k),
                                state, at, n, k)
        out["fault"] = _rel(faulty, ref[at:])
        out["fault_update"] = update(runner.logical_params(state))
        check(_graph_of(runner) is graph, f"{label}: the restore into the "
              f"live state recaptured")
        print(f"  {label}: planted fault (resume with Adam's moments zeroed) "
              f"max rel. loss diff {out['fault']:.3e}, update error "
              f"{out['fault_update']:.3e}", flush=True)
    del state
    return out


def preempt_train_child(directory, spec):
    """(c)'s child: BERT's eager step under ``CheckpointManager.run(
    preemption=True)``. Prints {"batch": n} as it hands out batch n, and
    at batch ``PREEMPT_AT`` waits for the SIGTERM; the emergency save and
    ``Preempted`` (exit code 128 + 15) follow. Prints what it saved."""
    import torch
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.resilience import Preempted
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    (batch,) = weighted_batches(cfg, [0], spec["batch"], spec["seq"],
                                spec["masked"])
    runner = _bert_runner(torch, cfg, device, batch)
    mgr = CheckpointManager(runner, directory, save_interval_steps=100)
    dbatch = runner.remapper.shard_batch(batch)

    def batches():
        n = 0
        while True:
            n += 1
            print(json.dumps({"batch": n}), flush=True)
            if n == PREEMPT_AT:  # the loop's handler is installed
                handler = signal.getsignal(signal.SIGTERM).__self__
                deadline = time.monotonic() + 300
                while not handler.preempted and time.monotonic() < deadline:
                    time.sleep(0.01)
            yield dbatch

    _flash_counts(fa, reset=True)
    try:
        mgr.run(mgr.restore_or_init(), batches(), 10 ** 6, preemption=True)
    except Preempted as e:
        print(json.dumps({"saved_step": e.saved_step, "code": e.code,
                          "steps": mgr.all_steps(),
                          "launches": _flash_counts(fa)}), flush=True)
        raise
    return 1  # not preempted


def preempt_start(cfg, device, directory, batch_size, seq, num_masked):
    """(c), first half: start the child (this script, ``--preempt-train``)
    and a thread that sends it SIGTERM when it asks for batch
    ``PREEMPT_AT``. Returns (child, thread, log path, start time)."""
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch_size, "masked": num_masked})
    log = directory + "-child.log"
    with open(log, "w") as err:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--preempt-train",
             directory, spec], stdout=subprocess.PIPE, stderr=err, text=True)
    lines = []

    def watch():
        for line in child.stdout:
            lines.append(line)
            if line.startswith("{") and \
                    json.loads(line).get("batch") == PREEMPT_AT:
                child.send_signal(signal.SIGTERM)
        child.wait()
    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    return types.SimpleNamespace(child=child, thread=thread, log=log,
                                 lines=lines, t0=time.perf_counter(),
                                 directory=directory)


def preempt_finish(torch, fa, cfg, device, batch, job, init):
    """(c), second half: the child exited with 128 + 15 after saving step
    ``PREEMPT_AT``; this process resumes from that step and takes 4 more.
    Returns the flash launches (child + resume)."""
    from autodist_tpu_torch.checkpoint import CheckpointManager
    job.thread.join(timeout=600)
    if job.child.poll() is None:
        job.child.kill()
        job.child.wait()
    child_s = time.perf_counter() - job.t0
    with open(job.log) as f:
        tail = f.read()[-3000:]
    check(job.child.returncode == 128 + signal.SIGTERM,
          f"(c): the child exited with {job.child.returncode}: {tail}")
    report = json.loads(job.lines[-1])
    check(report.get("saved_step") == PREEMPT_AT and
          report["code"] == 128 + signal.SIGTERM and
          report["steps"] == [1, PREEMPT_AT],
          f"(c): the child reported {report}")
    runner = _bert_runner(torch, cfg, device, batch, init)
    mgr = CheckpointManager(runner, job.directory, save_interval_steps=100)
    _flash_counts(fa, reset=True)  # the resume
    state = mgr.restore_or_init()
    check(int(state.step) == PREEMPT_AT, f"(c): resumed at {int(state.step)}")
    dbatch = runner.remapper.shard_batch(batch)
    losses = []
    for n in range(PREEMPT_AT + 1, PREEMPT_AT + 5):
        state, metrics = mgr.run(state, iter([dbatch]), n)
        losses.append(float(metrics["loss"]))
    launches = _flash_counts(fa)
    check(int(state.step) == PREEMPT_AT + 4 and all(np.isfinite(losses)),
          f"(c): resumed to {int(state.step)}, losses {losses}")
    total = {k: report["launches"][k] + launches[k] for k in launches}
    for name, n in total.items():
        check(n == cfg.num_layers * (PREEMPT_AT + 4),
              f"(c): {name} launched {n} times, expected {cfg.num_layers} x "
              f"{PREEMPT_AT + 4}")
    print(f"  (c) child (BERT eager, preemption=True) got SIGTERM at batch "
          f"{PREEMPT_AT}: exit code {job.child.returncode}, emergency step "
          f"{report['saved_step']} (retained {report['steps']}), "
          f"{child_s:.1f} s from its start (beside the other parts); "
          f"resumed here from step {PREEMPT_AT}: losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; flash launches (child "
          f"+ resume) {total}", flush=True)
    return total


def guard_cost(torch, card, runner, batches, device):
    """The guard's cost on the graph step: ``Runner.run(unroll=K)`` over
    ``GUARD_COST_STEPS`` steps with no guard, a ``StepGuard`` at
    ``check_every`` 1 (every block: a flag read and a refresh of the
    device snapshot) and at 10, and no guard again; host-inclusive ms per
    step. Each guard is warmed first (its snapshot allocated and copied
    by one ``mark_good``, timed on its own), so a reading is the steady
    per-check cost."""
    from autodist_tpu_torch.resilience import StepGuard
    state = runner.create_state()
    dbatches = [runner.remapper.shard_batch(b) for b in batches]

    def run(guard):
        nonlocal state
        data = iter(dbatches[i % len(dbatches)]
                    for i in range(GUARD_COST_STEPS))
        (state, _), ms = _timed(torch, device, lambda: runner.run(
            state, data, GUARD_COST_STEPS, step_guard=guard,
            unroll=RESIL_UNROLL))
        return ms / GUARD_COST_STEPS

    def guarded(check_every):
        guard = StepGuard(check_every)
        _, alloc_ms = _timed(torch, device, lambda: guard.mark_good(0, state))
        alloc.append(alloc_ms)
        return run(guard)
    alloc = []
    run(None)  # capture
    rows = [("none", run(None)), ("check_every=1", guarded(1)),
            ("check_every=10", guarded(10)), ("none", run(None))]
    nbytes = sum(t.numel() * t.element_size()
                 for t in _state_tensors(torch, state))
    print(f"  guard cost, BERT graph step (unroll={RESIL_UNROLL}), "
          f"{GUARD_COST_STEPS} steps a reading, host-inclusive ms/step: " +
          ", ".join(f"{k} {v:.3f}" for k, v in rows) +
          f"; the snapshot holds {nbytes} bytes ({nbytes / 1e9:.3f} GB) on "
          f"the device, its allocation and first copy took " +
          " / ".join(f"{ms:.3f}" for ms in alloc) + f" ms; on {card}",
          flush=True)
    return rows


def save_stall(torch, card, runner, batches, device, directory):
    """(f) The graph step around an asynchronous save. A K-step graph's
    median over ``SAVE_STALL_STEPS``; then twice (the first save allocates
    the pinned staging buffer, the second reuses it) the host-inclusive
    time of ``CheckpointManager.save`` (it returns once the copy into
    pinned memory is queued) followed by one graph, which waits on the
    device for that copy: its excess over the median is the stall. The
    graphs after it run while the writer thread writes, and
    ``wait_until_finished`` is timed at the end; beside them a synchronous
    ``Saver.save`` of the same state. Each saved step must be bitwise the
    state as it was at its save, though the state took steps during the
    write."""
    from autodist_tpu_torch.checkpoint import CheckpointManager, Saver
    state = runner.create_state()
    data = itertools.cycle([runner.remapper.shard_batch(b) for b in batches])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def graph():
        nonlocal state
        state, _ = runner.megastep(state, runner._next_block(
            data, RESIL_UNROLL))

    def timed_graph():
        return _timed(torch, device, graph)[1]
    for _ in range(2):
        graph()  # capture, then one replay
    median = float(np.median([timed_graph()
                              for _ in range(SAVE_STALL_STEPS)]))
    mgr = CheckpointManager(runner, os.path.join(directory, "stall"),
                            save_interval_steps=None)
    rows = []
    for _ in range(2):
        want = {k: t.clone() for k, t in
                _logical_named(runner, state).items()}
        step = int(state.step)
        sync()
        t0 = time.perf_counter()
        mgr.save(step, state, force=True)
        t1 = time.perf_counter()
        graph()
        sync()
        t2 = time.perf_counter()
        after = [timed_graph() for _ in range(SAVE_STALL_STEPS)]
        _, wait_ms = _timed(torch, device, mgr.wait_until_finished)
        diff = _same(torch, _raw_named(os.path.join(directory, "stall",
                                                    str(step))), want)
        check(not diff, f"(f): the async save of step {step} differs from "
              f"the state at the save in {diff[:5]}")
        rows.append({"save_ms": (t1 - t0) * 1e3,
                     "stall_ms": (t2 - t0) * 1e3 - median,
                     "after_ms": after, "wait_ms": wait_ms})
    path = os.path.join(directory, "stall-sync")
    _, sync_ms = _timed(torch, device, lambda: Saver(runner).save(state,
                                                                  path))
    print(f"  (f) save stall, BERT graph step (unroll={RESIL_UNROLL}), "
          f"host-inclusive ms: a graph {median:.3f} (median of "
          f"{SAVE_STALL_STEPS}); " + "; ".join(
              f"save {i + 1}"
              f"{' (allocates the pinned buffer)' if i == 0 else ''}: "
              f"CheckpointManager.save returned in {r['save_ms']:.3f}, "
              f"with the graph after it {r['stall_ms']:.3f} over the median"
              f" (the stall), the next graphs "
              f"{', '.join(f'{x:.3f}' for x in r['after_ms'])}, then "
              f"wait_until_finished {r['wait_ms']:.3f}"
              for i, r in enumerate(rows)) +
          f"; a synchronous Saver.save {sync_ms:.3f}; each step read back "
          f"bitwise the state at its save; on {card}", flush=True)
    check(device != "cuda" or max(r["stall_ms"] for r in rows) < sync_ms,
          f"(f): a save stalls the step {rows}, a synchronous save takes "
          f"{sync_ms} ms")
    shutil.rmtree(os.path.join(directory, "stall"))
    shutil.rmtree(path)
    return {"graph_ms": median, "saves": rows, "sync_save_ms": sync_ms}


def resilience_serve(torch, fa, card, cfg, device, params, want, request):
    """(e): params restored from a checkpoint serve through
    ``serve.Server`` (bucket 8 x seq): the answer bitwise the eager
    forward of the trained params (``want``). Returns the flash launches
    (warm-up + replays)."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import transformer as T

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()
    rows = request[0].shape[0]
    _flash_counts(fa, reset=True)  # the serving path
    with serve.Server(apply_fn, params, request, buckets=(rows,),
                      max_wait_ms=1, device=device) as srv:
        got = srv.infer(request, timeout=300)
        graphs = srv.engine.replicas[0].graphs
        dispatches = sum(r["dispatches"] for r in srv.stats()["replicas"])
    launches = _flash_counts(fa)["flash_fwd"]
    check(torch.equal(got, want), f"(e): the served answer is not bitwise "
          f"the trained params' eager forward (max diff "
          f"{(got - want).abs().max().item()})")
    replays = sum(g.replays for g in graphs.values())
    check(launches == cfg.num_layers * (len(graphs) + dispatches) and
          (device != "cuda" or replays == dispatches),
          f"(e): flash_fwd launched {launches} times, {replays} replays in "
          f"{dispatches} dispatches")
    print(f"  (e) restored params served (bucket {rows} x "
          f"{request[0].shape[1]}): the answer bitwise the trained params' "
          f"eager forward; flash_fwd launches {launches} ({len(graphs)} "
          f"warm-up + {dispatches} dispatches, {replays} graph replays)",
          flush=True)
    return launches


def resilience_phase(torch, fa, card, cfg, resnet_cfg, device, batch_size=32,
                     seq=128, num_masked=20, image=224, resnet_batch=64,
                     serve_rows=8):
    """Phase 9: checkpoint/ and resilience/ on BERT (a, c, d, e: graph and
    eager steps through the flash kernels) and ResNet (b). The timed parts
    run first; then the preempted child (c) runs beside (e), the resumes
    and (b). Returns {path: flash launches}."""
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import bert, resnet
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    print(f"phase 9: training that survives; a {cfg.num_layers}-layer, width "
          f"{cfg.dim} BERT (MLM, batch {batch_size} x {seq}, Adam 1e-4) and "
          f"ResNet (stages {resnet_cfg.stage_sizes}, batch {resnet_batch} x "
          f"{image}^2, SGD 1e-3)", flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    guard_dir = os.path.join(tmp.name, "guard")
    paths, job = {}, None
    try:
        init = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
        (batch,) = weighted_batches(cfg, [0], batch_size, seq, num_masked)
        batches = weighted_batches(cfg, range(RESIL_RESUME_STEPS), batch_size,
                                   seq, num_masked)
        runner, state, paths["resilience_bert_guard"] = resilience_guard_run(
            torch, fa, card, cfg, device, batch, guard_dir, init)
        state = _save_restore_rates(torch, card, "BERT", runner, state,
                                    tmp.name, device)
        # (e)'s reference: the trained params' eager forward, on a request
        # of a full bucket at seq = the model's max_len.
        ids, seg, _, _ = bert.synthetic_batch(cfg, serve_rows, cfg.max_len,
                                              seed=1)
        with torch.inference_mode():
            want = T.encode(runner.logical_params(state), cfg,
                            torch.as_tensor(ids, device=device),
                            segment_ids=torch.as_tensor(
                                seg, device=device)).float().cpu()
        del state
        guard_cost(torch, card, runner, batches, device)
        save_stall(torch, card, runner, batches, device, tmp.name)
        runner = None
        rbatches = [resnet.synthetic_batch(resnet_batch, image,
                                           resnet_cfg.num_classes, seed=s)
                    for s in range(4)]
        runner = _resnet_runner(torch, resnet_cfg, device, rbatches[0])
        _save_restore_rates(torch, card, "ResNet", runner,
                            runner.create_state(), tmp.name, device)
        runner = None
        autodist_mod._reset_default()

        job = preempt_start(cfg, device, os.path.join(tmp.name, "preempt"),
                            batch_size, seq, num_masked)
        params = CheckpointManager(None, guard_dir).restore_params()
        paths["resilience_serve"] = {
            "flash_fwd": resilience_serve(torch, fa, card, cfg, device,
                                          params, want, (ids, seg)),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        del params
        shutil.rmtree(guard_dir)

        def zero_moments(state):
            with torch.no_grad():
                for st in state.opt_state.state.values():
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].zero_()
        got = resilience_resume(
            torch, fa, card, "(a) BERT resume",
            lambda: _bert_runner(torch, cfg, device, batches[0], init),
            batches, os.path.join(tmp.name, "bert"), device,
            fault=zero_moments)
        for what, tol, key in (("losses", RESUME_RTOL, ""),
                               ("update", RESUME_UPDATE_RTOL, "_update")):
            floor, fault, resumed = (got[k + key] for k in
                                     ("floor", "fault", "resume"))
            print(f"  (a) BERT resume, {what}: floor {floor:.3e} < "
                  f"tolerance {tol} < planted fault {fault:.3e}; resumed "
                  f"{resumed:.3e}", flush=True)
            check(floor < tol < fault, f"(a): the {what} tolerance {tol} "
                  f"does not lie between the floor {floor} and the fault "
                  f"{fault}")
            check(resumed <= tol, f"(a): the resumed {what} are {resumed} "
                  f"off the uninterrupted run's")
        for name, n in got["launches"].items():
            check(n == cfg.num_layers * (RESIL_RESUME_STEPS -
                                         RESIL_RESUME_FROM),
                  f"(a) resume: {name} launched {n} times")
        paths["resilience_bert_resume"] = got["launches"]
        shutil.rmtree(os.path.join(tmp.name, "bert"))

        got = resilience_resume(
            torch, fa, card, "(b) ResNet resume",
            lambda: _resnet_runner(torch, resnet_cfg, device, rbatches[0]),
            rbatches, os.path.join(tmp.name, "resnet"), device)
        check(not any(got["launches"].values()), f"(b): flash launches "
              f"{got['launches']} in a model without attention")
        check(got["floor"] == got["resume"] == 0 and got["params"],
              f"(b): the resumed run is not bitwise the uninterrupted one "
              f"({got})")
        paths["resilience_resnet_resume"] = got["launches"]
        shutil.rmtree(os.path.join(tmp.name, "resnet"))

        paths["resilience_bert_preempted"] = preempt_finish(
            torch, fa, cfg, device, batch, job, init)
    finally:
        if job is not None and job.child.poll() is None:
            job.child.kill()
            job.child.wait()
        autodist_mod._reset_default()
        tmp.cleanup()
    return paths


# Phase 10: sequence parallelism.

def _ring_counts(fa, reset=False):
    """Launch counts of the flash kernels and of the hop wrappers."""
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
               fa.block_attn_fwd, fa.block_attn_bwd)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def ring_emulated(torch, fa, q, k, v, do, hops, drop=None):
    """The ring of ``hops`` ranks over q/k/v/do (b, h, s, d), in one
    process: rank r holds chunk r; at hop t it attends to chunk r - t
    (``block_attn_fwd`` at the global offsets, merged by
    ``combine_blocks``), and the backward accumulates each chunk's dk / dv
    in the order the ring carries it (hop by hop). ``drop`` = (r, t) skips
    that hop of rank r, forward and backward (the planted fault). Returns
    (o, dq, dk, dv) in q's dtype."""
    s = q.shape[2] // hops
    qs, ks, vs, dos = (x.split(s, dim=2) for x in (q, k, v, do))
    o = [torch.zeros(qs[0].shape, dtype=torch.float32, device=q.device)
         for _ in range(hops)]
    lse = [torch.full(qs[0].shape[:3] + (1,), -1e30, device=q.device)
           for _ in range(hops)]
    for t in range(hops):
        for r in range(hops):
            j = (r - t) % hops
            if (r, t) != drop:
                ob, lb = fa.block_attn_fwd(qs[r], ks[j], vs[j], True, r * s,
                                           j * s)
                o[r], lse[r] = fa.combine_blocks(o[r], lse[r], ob, lb)
    delta = [(d * x).sum(-1, keepdim=True) for d, x in zip(dos, o)]
    dq = [torch.zeros_like(x) for x in o]
    dk = [torch.zeros_like(x) for x in o]
    dv = [torch.zeros_like(x) for x in o]
    for t in range(hops):
        for r in range(hops):
            j = (r - t) % hops
            if (r, t) != drop:
                g = fa.block_attn_bwd(qs[r], ks[j], vs[j], dos[r], lse[r],
                                      delta[r], True, r * s, j * s)
                dq[r] += g[0]
                dk[j] += g[1]
                dv[j] += g[2]
    return [torch.cat(x, dim=2).to(q.dtype) for x in (o, dq, dk, dv)]


def ring_kernel_phase(torch, fa):
    """Phase 10 (a): the hop functions on the card at lm1b's width, each
    hop against its plain version, the emulated ring against one
    whole-sequence flash_attention call (forward and backward), between
    its reading and a dropped hop; then the hop kernels timed at the
    diagonal hop and at a fully visible one. Returns the two records."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, seq, d = SP_SHAPE
    s = seq // SP_HOPS
    q, k, v, do = (torch.randn(SP_SHAPE, generator=gen, device=dev,
                               dtype=bf16) for _ in range(4))
    print(f"phase 10 (a): ring attention's hops, b{b} h{h} d{d} bf16 causal,"
          f" a global sequence of {seq} as {SP_HOPS} hops of {s}", flush=True)
    errs = {"block_attn_fwd": 0.0, "block_attn_bwd": 0.0}
    qs, ks, vs, dos = (x.split(s, dim=2) for x in (q, k, v, do))
    # Every (rank, chunk) block, with the global lse and delta the ring
    # would hold: the whole sequence's, from one forward.
    o_all, lse_all = fa.flash_fwd(q, k, v, True, out_dtype=f32)
    delta_all = (do * o_all).sum(-1, keepdim=True)
    lses = [x.contiguous() for x in lse_all.split(s, dim=2)]
    deltas = [x.contiguous() for x in delta_all.split(s, dim=2)]
    for r in range(SP_HOPS):
        for j in range(SP_HOPS):
            masked = j > r
            args = (qs[r], ks[j], vs[j], True, r * s, j * s)
            o_b, lse_b = fa.block_attn_fwd(*args)
            o_p, lse_p = fa.flash_fwd_reference(*args, out_dtype=f32)
            err_o = (o_b - o_p).abs().max().item()
            err_l = (lse_b - lse_p).abs().max().item()
            check(bool(torch.isfinite(o_b).all()) and err_o <= O_F32_ATOL
                  and err_l <= LSE_ATOL, f"(a) block ({r}, {j}): o off by "
                  f"{err_o}, lse by {err_l}")
            bargs = (qs[r], ks[j], vs[j], dos[r], lses[r], deltas[r], True,
                     r * s, j * s)
            got = fa.block_attn_bwd(*bargs)
            ref = fa.flash_bwd_reference(*bargs)
            line = []
            for label, g, want in zip(("dq", "dk", "dv"), got, ref):
                tol = BWD_REL_DV_BF16 if label == "dv" else BWD_REL_DQDK_BF16
                err = (g - want).abs().max().item()
                scale = want.abs().max().item()
                check(bool(torch.isfinite(g).all()) and
                      err <= tol * max(scale, 1e-30), f"(a) block ({r}, "
                      f"{j}): {label} off by {err} (max {scale})")
                line.append(f"{label} {err:.2e}")
                errs["block_attn_bwd"] = max(errs["block_attn_bwd"], err)
            errs["block_attn_fwd"] = max(errs["block_attn_fwd"], err_o)
            if masked:
                check(not o_b.any() and bool((lse_b == -1e30).all()) and
                      not any(g.any() for g in got), f"(a) the wholly "
                      f"masked block ({r}, {j}) is not o = 0, lse = -1e30, "
                      f"gradients 0")
            print(f"  block (q chunk {r}, k chunk {j})"
                  f"{' wholly masked' if masked else ''}: max|kernel-plain| "
                  f"o {err_o:.2e}, lse {err_l:.2e}, " + ", ".join(line),
                  flush=True)
            del o_p, lse_p, ref
    del o_all, lse_all, delta_all
    # The ring against one whole-sequence call of the kernels.
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    whole_o = fa.flash_attention(*leaves, causal=True)
    whole = [whole_o] + list(torch.autograd.grad(whole_o, leaves, do))
    ring = ring_emulated(torch, fa, q, k, v, do, SP_HOPS)
    fault = ring_emulated(torch, fa, q, k, v, do, SP_HOPS, drop=(2, 1))

    def rel(a, w):
        return ((a.float() - w.float()).abs().max() /
                w.float().abs().max()).item()
    names = ("o", "dq", "dk", "dv")
    reading = {n: rel(a, w) for n, a, w in zip(names, ring, whole)}
    planted = {n: rel(a, w) for n, a, w in zip(names, fault, whole)}
    for n in names:
        print(f"  the ring's {n} vs one flash_attention call over the whole "
              f"sequence: {reading[n]:.3e} of the max < tolerance "
              f"{SP_RING_REL} < the ring with hop 1 of rank 2 dropped "
              f"{planted[n]:.3e}", flush=True)
        check(reading[n] <= SP_RING_REL < planted[n], f"(a) the ring's {n}:"
              f" reading {reading[n]}, fault {planted[n]}, tolerance "
              f"{SP_RING_REL}")
    del whole, ring, fault, leaves, whole_o

    records = []
    for name, tpu_line, source in (
            ("block_attn_fwd", 377, "autodist_tpu_torch/csrc/flash_fwd.cu"),
            ("block_attn_bwd", 397, "autodist_tpu_torch/csrc/flash_bwd.cu")):
        record = {"name": name, "route": "cuda", "source": source,
                  "replaces": f"autodist_tpu/ops/flash_attention.py:"
                              f"{tpu_line}",
                  "tpu_kernel": name,
                  "design": "a wrapper over the flash kernels with f32 "
                            "outputs at the hop's global offsets (one hop a "
                            "launch; the backward a dq and a dk/dv launch)",
                  "shape": [b, h, s, d], "max_abs_err": errs[name]}
        for hop, (r, j) in (("diagonal", (1, 1)), ("visible", (2, 0))):
            frac = (s + 1) / (2 * s) if r == j else 1.0
            pairs = float(b * h * s * s) * frac
            if name == "block_attn_fwd":
                args = (qs[r], ks[j], vs[j], True, r * s, j * s)
                kern = timed(torch, lambda: fa.block_attn_fwd(*args))
                plain = timed(torch, lambda: fa.flash_fwd_reference(
                    *args, out_dtype=f32))
                lib = timed(torch, lambda: sdpa(qs[r], ks[j], vs[j],
                                                is_causal=r == j))
                flops = 4.0 * pairs * d
                nbytes = 3 * qs[r].numel() * 2 + qs[r].numel() * 4 + \
                    b * h * s * 4
            else:
                bargs = (qs[r], ks[j], vs[j], dos[r], lses[r], deltas[r],
                         True, r * s, j * s)
                kern = timed(torch, lambda: fa.block_attn_bwd(*bargs))
                plain = timed(torch, lambda: fa.flash_bwd_reference(*bargs))
                sl = [x.detach().clone().requires_grad_()
                      for x in (qs[r], ks[j], vs[j])]
                out = sdpa(*sl, is_causal=r == j)
                lib = timed(torch, lambda: torch.autograd.grad(
                    out, sl, dos[r], retain_graph=True))
                # The function's work: five GEMMs a (q, k) pair (S
                # recomputed once, dP, dV, dQ, dK). The split kernels
                # recompute S and dP in each (6 + 8): that is not charged.
                flops = 10.0 * pairs * d
                nbytes = 4 * qs[r].numel() * 2 + 2 * b * h * s * 4 + \
                    3 * qs[r].numel() * 4
            bnd = bound(flops, nbytes)
            print(f"  {name}, the {hop} hop (q chunk {r}, k chunk {j}): "
                  f"device ms per call {kern['ms']:.4f}, host-inclusive "
                  f"{kern['host_ms']:.4f}; plain {plain['ms']:.4f}; SDPA "
                  f"({'causal' if r == j else 'non-causal'}"
                  f"{', backward' if name == 'block_attn_bwd' else ''}) "
                  f"{lib['ms']:.4f}; bound {bnd[0]:.4f} ({bnd[1]}: "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); bound / "
                  f"kernel {bnd[0] / kern['ms']:.3f}; launches per call: "
                  f"{kernel_names(kern)}", flush=True)
            key = "" if hop == "diagonal" else "visible_"
            record.update({key + "ms": kern["ms"],
                           key + "host_ms": kern["host_ms"],
                           key + "plain_ms": plain["ms"],
                           key + "library_ms": lib["ms"],
                           key + "bound_ms": bnd[0],
                           key + "bound_by": bnd[1]})
        record["library"] = ("scaled_dot_product_attention, causal for the "
                             "diagonal hop, non-causal for visible_*")
        records.append(record)
    return records


def sp_train_rank(rank, world, port, spec):
    """One rank of :func:`sp_phase`: a gloo world over ``localhost`` on
    device 0; the LM of ``spec`` trains ``SP_STEPS`` eager SGD steps under
    SequenceParallel("ring"), ("ulysses") and the ring with each rank's
    attention local to its chunk (the planted fault). Prints {run: losses,
    launches, mesh, update error against the reference, ms per step,
    params digest}."""
    import datetime
    import hashlib
    import importlib
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    ra = importlib.import_module("autodist_tpu_torch.parallel.ring_attention")
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    params, init = _lm_init(torch, cfg, device)
    tokens = sp_tokens(cfg, spec["batch"], spec["seq"])
    ref = torch.load(spec["ref"], map_location=device)
    out = {"rank": rank}
    real = ra.ring_attention
    for key, attn in (("ring", "ring"), ("ulysses", "ulysses"),
                      ("local", "ring")):
        if key == "local":  # each rank attends within its own chunk
            ra.ring_attention = (lambda q, k, v, group=None, causal=False:
                                 fa.flash_attention(q, k, v, causal))
        try:
            losses, times, launches, mesh, final = _lm_train(
                torch, fa, cfg, device,
                S.SequenceParallel(attn=attn, seq_axis=world), params,
                tokens, spec["steps"], spec["lr"])
        finally:
            ra.ring_attention = real
        digest = hashlib.sha256()
        for name, t in sorted(final.items()):
            digest.update(t.detach().float().cpu().numpy().tobytes())
        out[key] = {"losses": losses, "launches": launches, "ms": times,
                    "mesh": mesh,
                    "update_error": update_error(torch, final, ref, init),
                    "digest": digest.hexdigest()}
        del final
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def sp_tokens(cfg, batch, seq):
    """The seeded (batch, seq + 1) token ids every run of phase 10 (b)
    trains on."""
    import torch
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randint(0, cfg.vocab, (batch, seq + 1)))


def _lm_train(torch, fa, cfg, device, builder, params, tokens, steps, lr):
    """``steps`` eager SGD steps of the LM under ``builder`` from
    ``params`` (the runner copies them): (losses, host ms per step,
    launches of the flash kernels and hop wrappers over the steps, the
    runner's program mesh, the final logical params by name)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import lm
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device=device)
    runner = ad.create_distributed_session(ad.capture(
        lm.make_loss_fn(cfg), params,
        functools.partial(torch.optim.SGD, lr=lr), example_batch=(tokens,)))
    state = runner.create_state()
    _ring_counts(fa, reset=True)  # this run's main path
    losses, times = [], []
    for _ in range(steps):
        (state, m), ms = _timed(torch, device, lambda: runner.step(
            state, (tokens,)))
        losses.append(float(m["loss"]))
        times.append(ms)
    launches = _ring_counts(fa)
    final = flatten_params(runner.logical_params(state))
    mesh = dict(runner.program.mesh.shape)
    autodist_mod._reset_default()
    return losses, times, launches, mesh, final


def _lm_init(torch, cfg, device):
    """The LM's seeded params, and a copy of them by name."""
    from autodist_tpu_torch.models import lm
    params = lm.init(cfg, torch.Generator().manual_seed(0), device=device)
    return params, {n: t.detach().clone()
                    for n, t in flatten_params(params).items()}


def sp_phase(torch, fa, card, device, vocab=32000, dim=1024, heads=16,
             layers=SP_LAYERS, max_len=SP_MAX_LEN, batch=SP_BATCH,
             steps=SP_STEPS):
    """Phase 10 (b): ``SP_WORLD`` gloo ranks (processes of this script) on
    the one card train the LM under SequenceParallel("ring") and
    ("ulysses") through AutoDist -> Runner.step, each rank its chunk of the
    sequence; losses and the whole update are held to one rank's
    AllReduce() steps over the whole sequence (tolerances between that run
    again and the block-diagonal fault), the ranks' params must agree
    bitwise, and every layer launches the kernels its attention needs.
    Returns {path: launches summed over the ranks}."""
    import socket
    import tempfile
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    cfg = T.TransformerConfig(vocab=vocab, dim=dim, num_heads=heads,
                              num_layers=layers, max_len=max_len,
                              causal=True, dtype=torch.bfloat16)
    seq = max_len
    tokens = sp_tokens(cfg, batch, seq)
    print(f"phase 10 (b): {SP_WORLD} gloo ranks on one device, an LM at "
          f"lm1b's widths (vocab {vocab}, dim {dim}, {heads} heads), "
          f"{layers} layers, batch {batch} x {seq} tokens ({seq // SP_WORLD}"
          f" a rank), SGD {SP_LR}, {steps} eager steps under "
          f"SequenceParallel('ring') and ('ulysses') vs one rank's "
          f"AllReduce() over the whole sequence", flush=True)
    params, init = _lm_init(torch, cfg, device)
    ref = _lm_train(torch, fa, cfg, device, S.AllReduce(), params, tokens,
                    steps, SP_LR)
    again = _lm_train(torch, fa, cfg, device, S.AllReduce(), params, tokens,
                      steps, SP_LR)
    del params
    for name, n in ref[2].items():
        want = 0 if name.startswith("block") else layers * steps
        check(n == want, f"(b) one rank: {name} launched {n} times")
    floor_loss = _rel(again[0], ref[0])
    floor_update = update_error(torch, again[4], ref[4], init)
    check(all(np.isfinite(ref[0])) and ref[0][-1] < ref[0][0],
          f"(b) one rank's losses {ref[0]}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    torch.save({n: t.detach().cpu() for n, t in ref[4].items()}, ref_path)
    ref_losses, ref_ms = ref[0], ref[1]
    del ref, again, init
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch, "steps": steps, "lr": SP_LR,
                       "ref": ref_path})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sp-train", str(r),
         str(SP_WORLD), str(port), spec], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(SP_WORLD)]
    ranks = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"an SP rank exited with "
                  f"{p.returncode}: {err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        tmp.cleanup()
    got = {key: [r[key] for r in ranks] for key in ("ring", "ulysses",
                                                     "local")}
    fault_loss = _rel(got["local"][0]["losses"], ref_losses)
    fault_update = got["local"][0]["update_error"]
    print(f"  one rank AllReduce() over the whole sequence: losses "
          f"{', '.join(f'{x:.6f}' for x in ref_losses)}, ms per step "
          f"{', '.join(f'{x:.1f}' for x in ref_ms)}; floor (the run again): "
          f"loss {floor_loss:.3e}, update {floor_update:.3e}; planted "
          f"fault (attention local to each rank's chunk): loss "
          f"{fault_loss:.3e}, update {fault_update:.3e}", flush=True)
    paths, readings = {}, {}
    for key in ("ring", "ulysses"):
        runs = got[key]
        losses = runs[0]["losses"]
        rel = _rel(losses, ref_losses)
        err = runs[0]["update_error"]
        print(f"  SequenceParallel('{key}') on {SP_WORLD} ranks (mesh "
              f"{runs[0]['mesh']}): losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}; max rel. diff "
              f"{rel:.3e} (tol {SP_LOSS_RTOL}); update error {err:.3e} (tol "
              f"{SP_UPDATE_RTOL}); ms per step "
              f"{', '.join(f'{x:.1f}' for x in runs[0]['ms'])}; params "
              f"equal on every rank: "
              f"{len({r['digest'] for r in runs}) == 1}; launches per rank "
              f"{runs[0]['launches']}", flush=True)
        readings[key] = (rel, err)
    for what, tol, floor, fault, i in (
            ("loss", SP_LOSS_RTOL, floor_loss, fault_loss, 0),
            ("update", SP_UPDATE_RTOL, floor_update, fault_update, 1)):
        check(floor < tol < fault, f"(b) the {what} tolerance {tol} does not"
              f" lie between the floor {floor} and the fault {fault}")
        for key, got_key in readings.items():
            check(got_key[i] <= tol, f"(b) {key}: the {what} reads "
                  f"{got_key[i]} (tolerance {tol})")
    for key, per_layer in (("ring", SP_WORLD), ("ulysses", 1)):
        runs = got[key]
        losses = runs[0]["losses"]
        check(all(r["losses"] == losses for r in runs),
              f"{key}: the ranks' losses differ")
        check(len({r["digest"] for r in runs}) == 1,
              f"{key}: the ranks' params differ")
        check(all(r["mesh"] == {"data": 1, "seq": SP_WORLD} for r in runs),
              f"{key}: mesh {runs[0]['mesh']}")
        want = {"flash_fwd": layers * steps * per_layer,
                "flash_bwd_dq": layers * steps * per_layer,
                "flash_bwd_dkv": layers * steps * per_layer,
                "block_attn_fwd": layers * steps * SP_WORLD * (key == "ring"),
                "block_attn_bwd": layers * steps * SP_WORLD * (key == "ring")}
        for r in runs:
            check(r["launches"] == want, f"{key}: launches {r['launches']}, "
                  f"expected {want}")
        paths[f"sp_gloo{SP_WORLD}_{key}"] = {
            k: sum(r["launches"][k] for r in runs) for k in want}
    return paths


def main():
    import torch
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo-train":
        return gloo_train_rank(*(int(a) for a in sys.argv[2:5]),
                               sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--preempt-train":
        return preempt_train_child(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "--sp-train":
        return sp_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa

    start = time.perf_counter()
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
    from autodist_tpu_torch.models import lm, resnet
    zoo["decode"] = decode_phase(torch, fa, card, lm.lm1b(), "cuda")
    zoo.update(graph_phase(torch, fa, card, bert.bert_base(max_len=128),
                           resnet.resnet50(), "cuda"))
    served_graph = graph_serve_phase(torch, fa, card,
                                     bert.bert_base(max_len=512), "cuda")
    zoo.update(strategy_phase(torch, fa, card, bert.bert_base(max_len=128),
                              "cuda"))
    zoo.update(gloo_strategy_phase(torch, fa, card,
                                   bert.bert_base(max_len=128), "cuda"))
    zoo.update(resilience_phase(torch, fa, card, bert.bert_base(max_len=512),
                                resnet.resnet50(), "cuda"))
    hops = ring_kernel_phase(torch, fa)
    zoo.update(sp_phase(torch, fa, card, "cuda"))
    fwd["launches"] = served + trained["flash_fwd"]
    fwd["launches_by_path"] = {"serve": served,
                               "train": trained["flash_fwd"],
                               "graph_serve": served_graph}
    for record in bwd:
        record["launches"] = trained[record["name"]]
        record["launches_by_path"] = {"serve": 0,
                                      "train": trained[record["name"]],
                                      "graph_serve": 0}
    for record in [fwd] + bwd:
        record["launches_by_path"].update(
            {path: counts[record["name"]] for path, counts in zoo.items()})
        record["other_routes"] = routes[record["name"]]
    for record in hops:  # their main path: the ring's steps in phase 10
        record["launches"] = zoo[f"sp_gloo{SP_WORLD}_ring"][record["name"]]
        record["launches_by_path"] = {
            path: counts.get(record["name"], 0)
            for path, counts in zoo.items()}
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - start:.1f}s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [fwd] + bwd + hops}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
