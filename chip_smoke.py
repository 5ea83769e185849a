"""Drive the PyTorch / CUDA port (``autodist_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no final ``ok`` line):

0. device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, turns TF32 off for float32 products;
1. build: compiles every kernel of the port from ``autodist_tpu_torch/csrc``
   into the git-ignored ``build/`` directory and prints the seconds;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shape and at the causal / offset / ragged / float32
   cases later slices rely on; then times the kernel, its plain version,
   the PyTorch library call that computes the same function (yardstick
   only, never called by the port) and the card's bound;
3. the slice: the port's ``serve.Server`` on BERT-base (seeded random
   weights, full width, 12 layers, seq 512) answers concurrent requests
   from four client threads; every answer is held against the port's own
   forward with the plain attention, a repeated request must be bitwise
   identical, and the launch counts show every layer of every dispatch ran
   the kernel;
4. output: one ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Kernel vs plain version: o in f32 at these (bf16 output rounds at 2^-8
# relative), lse at an absolute 1e-4 (both sum f32 products of the same
# inputs, in another order).
O_ATOL, O_RTOL, LSE_ATOL = 1.6e-2, 1e-2, 1e-4
# Served answers vs the port's forward on the request's rows alone with the
# plain attention: twelve bf16 layers, other matmul shapes (the bucket's
# padded rows) and another summation order inside attention.
SERVE_ATOL, SERVE_RTOL = 5e-2, 5e-2
# The H100 SXM's published peaks (NVIDIA data sheet, dense).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


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


def time_ms(fn, warmup=3, iters=20):
    """Median of ``iters`` CUDA-event timings of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def attention_work(q, k, v, o, lse):
    """(operations, bytes) of one non-causal call: 4 flops per (q, k) pair
    and head-dim element; each input read once, each output written once."""
    b, h, sq, d = q.shape
    flops = 4.0 * b * h * sq * k.shape[2] * d
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o, lse))
    return flops, nbytes


def kernel_phase(torch, fa):
    """Phase 2: flash_fwd vs flash_fwd_reference on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, sq, sk, d, dtype):
        return [torch.randn((b, h, s, d), generator=gen, device=dev,
                            dtype=dtype) for s in (sq, sk, sk)]

    errs = {"o": 0.0, "lse": 0.0}

    def compare(name, q, k, v, causal=False, q_offset=0, k_offset=0,
                out_dtype=None, all_empty=False):
        o, lse = fa.flash_fwd(q, k, v, causal, q_offset, k_offset, out_dtype)
        torch.cuda.synchronize()
        ro, rl = fa.flash_fwd_reference(q, k, v, causal, q_offset, k_offset,
                                        out_dtype)
        check(o.dtype == ro.dtype and o.shape == ro.shape and
              lse.shape == rl.shape, f"{name}: output dtype/shape differ")
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite output")
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        print(f"  {name}: max|o-o_plain| {err_o:.3e}  "
              f"max|lse-lse_plain| {err_l:.3e}", flush=True)
        check(torch.allclose(o.float(), ro.float(), atol=O_ATOL, rtol=O_RTOL),
              f"{name}: o differs from the plain version by {err_o}")
        check(torch.allclose(lse, rl, atol=LSE_ATOL, rtol=0),
              f"{name}: lse differs from the plain version by {err_l}")
        if all_empty:
            check(bool((o == 0).all()) and bool((lse == -1e30).all()),
                  f"{name}: rows with no visible key must give o == 0 and "
                  f"lse == -1e30")
        errs["o"] = max(errs["o"], err_o)
        errs["lse"] = max(errs["lse"], err_l)
        return o, lse

    bf16, f32 = torch.bfloat16, torch.float32
    print("phase 2: flash_fwd kernel vs its plain version", flush=True)
    shape_a = (8, 12, 512, 512, 64)  # BERT-base at bucket 8
    qa, ka, va = qkv(*shape_a, bf16)
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
    for d in (16, 32, 128):
        q, k, v = qkv(2, 3, 200, 200, d, f32)
        compare(f"(d) f32 s200 d{d}", q, k, v)
        compare(f"(d) f32 s200 d{d} causal", q, k, v, causal=True)

    kernel_ms = time_ms(lambda: fa.flash_fwd(qa, ka, va))
    plain_ms = time_ms(lambda: fa.flash_fwd_reference(qa, ka, va))
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qa, ka, va))
    flops, nbytes = attention_work(qa, ka, va, *fa.flash_fwd(qa, ka, va))
    bound_by = "bytes" if nbytes / PEAK_BYTES >= flops / PEAK_BF16_FLOPS \
        else "operations"
    bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
    print(f"  timing at (a), median of 20 after 3 warm-ups: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.3f} MB)", flush=True)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "autodist_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "autodist_tpu/ops/flash_attention.py:101",
            "tpu_kernel": "_fwd_kernel",
            "shape": list(shape_a[:3]) + [shape_a[4]],
            "max_abs_err": errs["o"], "max_err_o": errs["o"],
            "max_err_lse": errs["lse"], "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _device_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_dispatches(torch, srv, batch, n=6):
    """Where a dispatch's time goes: ``n`` sequential full-bucket requests
    under ``torch.profiler``; device time by kernel and the device's busy
    share of the wall time (kernels summed; the copy stream overlaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    srv.infer(batch, timeout=300)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.infer(batch, timeout=300)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
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

    record = kernel_phase(torch, fa)
    from autodist_tpu_torch.models import bert
    record["launches"] = serve_phase(torch, fa, card,
                                     bert.bert_base(max_len=512), "cuda")
    print(card, flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
