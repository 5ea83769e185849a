"""The port's flash-attention backward (plain version on the CPU) against the
JAX package's Pallas backward in interpret mode, its dense backward, and
``jax.grad`` through its attention.

The CUDA kernels run only on a card: ``chip_smoke.py`` holds them against
the same plain version there, and the last test here does too when a card
is present. Tolerances: f32 at atol/rtol 1e-5 (the same f32 arithmetic,
summed in another order); bf16 inputs at atol 1e-4 (both sides compute in
f32 from the same bf16 values, and the gradients here reach ~10).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autodist_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

SHAPES = [((2, 3, 32, 16), 16), ((1, 2, 64, 32), 32)]  # (b, h, s, d), block
# (q_offset, k_offset): none; q shifted; every row empty under causal
# masking; every key visible to every row.
OFFSETS = [(0, 0), (32, 0), (0, 64), (64, 0)]
CASES = [(shape, blk, causal, offs) for shape, blk in SHAPES
         for causal in (False, True) for offs in OFFSETS]


def _ids(case):
    (b, h, s, d), _, causal, (qo, ko) = case
    return f"b{b}h{h}s{s}d{d}-{'causal' if causal else 'full'}-q{qo}k{ko}"


def _all_empty(case):
    _, _, causal, (qo, ko) = case
    return causal and (qo, ko) == (0, 64)


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_residuals(q, k, v, do, causal, blk, qo, ko):
    """lse from the interpret-mode forward and delta = rowsum(do * o), in
    f32, as ``_bwd_rule`` computes them."""
    o, lse = jfa._flash_fwd(q, k, v, causal, blk, blk, qo, ko, True)
    delta = (do.astype(jnp.float32) * o.astype(jnp.float32)).sum(
        -1, keepdims=True)
    return lse, delta


def _close(got, want, atol=1e-5, rtol=1e-5):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_matches_interpret_kernels_f32(case):
    shape, blk, causal, (qo, ko) = case
    xs = [jnp.asarray(x) for x in _inputs(shape)]
    lse, delta = _jax_residuals(*xs, causal, blk, qo, ko)
    want = jfa._flash_bwd(*xs, lse, delta, causal, blk, blk, qo, ko, True)
    got = fa.flash_bwd_reference(*map(_t, xs), _t(lse), _t(delta), causal,
                                 qo, ko)
    _close(got, want)
    if _all_empty(case):
        assert all(bool((g == 0).all()) for g in got)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_matches_interpret_kernels_bf16(case):
    shape, blk, causal, (qo, ko) = case
    xs = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(shape, seed=1)]
    lse, delta = _jax_residuals(*xs, causal, blk, qo, ko)
    want = jfa._flash_bwd(*xs, lse, delta, causal, blk, blk, qo, ko, True)
    tx = [_t(x.astype(jnp.float32)).bfloat16() for x in xs]
    got = fa.flash_bwd(*tx, _t(lse), _t(delta), causal, qo, ko)
    _close(got, want, atol=1e-4, rtol=1e-5)
    if _all_empty(case):
        assert all(bool((g == 0).all()) for g in got)


@pytest.mark.parametrize("case", [c for c in CASES if not _all_empty(c)],
                         ids=_ids)
def test_plain_matches_dense_bwd(case):
    """Rows that see at least one key: the JAX dense backward agrees. (A
    row that sees none gets p = 1 there; the kernels and the port give
    exactly 0.)"""
    shape, _, causal, (qo, ko) = case
    xs = [jnp.asarray(x) for x in _inputs(shape, seed=2)]
    o, lse = jfa._dense_fwd(*xs[:3], causal, qo, ko)
    delta = (xs[3] * o).sum(-1, keepdims=True)
    want = jfa._dense_bwd(*xs, lse, delta, causal, qo, ko)
    got = fa.flash_bwd(*map(_t, xs), _t(lse), _t(delta), causal, qo, ko)
    _close(got, want)


def test_dense_bwd_gives_empty_rows_p_one_and_the_port_zero():
    """The difference ROADMAP.md Queue C records: with every row empty the
    dense backward's gradients are not zero, the port's are."""
    xs = [jnp.asarray(x) for x in _inputs((1, 2, 32, 16), seed=3)]
    lse = jnp.full((1, 2, 32, 1), -1e30, jnp.float32)
    delta = jnp.zeros((1, 2, 32, 1), jnp.float32)
    dense = jfa._dense_bwd(*xs, lse, delta, True, 0, 64)
    assert float(jnp.abs(dense[2]).max()) > 0
    got = fa.flash_bwd(*map(_t, xs), _t(lse), _t(delta), True, 0, 64)
    assert all(bool((g == 0).all()) for g in got)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_autograd_matches_jax_grad_of_flash_attention(causal):
    """torch.autograd through the port's flash_attention against jax.grad
    through the JAX package's custom_vjp in interpret mode."""
    q, k, v, w = _inputs((2, 2, 32, 16), seed=4)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, 8, 8, 0, True)
        return (o * w).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [_t(x).requires_grad_() for x in (q, k, v)]
    loss = (fa.flash_attention(tq, tk, tv, causal=causal) * _t(w)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attn_fn_grads_match_jax_default_attention(causal):
    """The port's default attention hook against jax.grad of the JAX
    package's (its dense reference off the TPU)."""
    q, k, v, w = _inputs((2, 4, 16, 16), seed=5)
    jattn = jfa.make_flash_attn_fn(causal=causal)

    def jloss(q, k, v):
        return (jattn(q, k, v) * w).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [_t(x).requires_grad_() for x in (q, k, v)]
    loss = (fa.make_flash_attn_fn(causal=causal)(tq, tk, tv) * _t(w)).sum()
    _close(torch.autograd.grad(loss, (tq, tk, tv)), want)


def test_bf16_grads_come_back_in_the_input_dtype():
    q, k, v = [_t(x).bfloat16().requires_grad_()
               for x in _inputs((1, 2, 16, 16), seed=6)[:3]]
    fa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))


def test_expanded_cotangent_is_accepted():
    """``out.sum().backward()`` hands the backward an expanded (stride-0)
    ``do``; the wrapper copies it and the grads match a materialized one."""
    xs = [_t(x).requires_grad_() for x in _inputs((1, 2, 16, 16), seed=7)[:3]]
    fa.flash_attention(*xs, causal=True).sum().backward()
    ys = [x.detach().clone().requires_grad_() for x in xs]
    out = fa.flash_attention(*ys, causal=True)
    out.backward(torch.ones_like(out).contiguous())
    for x, y in zip(xs, ys):
        assert torch.equal(x.grad, y.grad)


def test_cpu_tensors_never_count_a_backward_launch():
    xs = [_t(x) for x in _inputs((1, 2, 16, 16), seed=8)]
    o, lse = fa.flash_fwd(*xs[:3])
    delta = (xs[3] * o).sum(-1, keepdim=True)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(*xs, lse, delta)
    dk, dv = fa.flash_bwd_dkv(*xs, lse, delta)
    ref = fa.flash_bwd_reference(*xs, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), ref))
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("bad, match", [
    (dict(do_shape=(1, 2, 8, 8)), "do"),
    (dict(lse_dtype=torch.bfloat16), "lse must be float32"),
    (dict(d=24), "head_dim 24"),
], ids=["do-shape", "lse-dtype", "head-dim"])
def test_backward_wrapper_rejects_what_the_kernels_do_not_take(bad, match):
    d = bad.get("d", 16)
    q = k = v = torch.zeros(1, 2, 8, d)
    do = torch.zeros(bad.get("do_shape", (1, 2, 8, d)))
    lse = torch.zeros(1, 2, 8, 1, dtype=bad.get("lse_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        fa.flash_bwd_dq(q, k, v, do, lse, torch.zeros(1, 2, 8, 1))


WRAPPERS = {"dq": lambda *a, **kw: (fa.flash_bwd_dq(*a, **kw),),
            "dkv": fa.flash_bwd_dkv, "bwd": fa.flash_bwd}


def _bwd_args(shape, dtype, causal, qo, ko, seed):
    xs = [_t(x).to(dtype) for x in _inputs(shape, seed=seed)]
    o, lse = fa.flash_fwd(*xs[:3], causal, qo, ko, out_dtype=torch.float32)
    delta = (xs[3].float() * o).sum(-1, keepdim=True)
    return (*xs, lse, delta, causal, qo, ko)


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("case", CASES,
                         ids=_ids)
def test_bf16_out_dtype_is_the_f32_result_cast_bitwise(case, wrapper):
    """``out_dtype=q.dtype`` rounds the f32 gradients once, to nearest even:
    bitwise what ``Tensor.to`` gives (the kernels' contract as well)."""
    shape, _, causal, (qo, ko) = case
    args = _bwd_args(shape, torch.bfloat16, causal, qo, ko, seed=9)
    f32 = WRAPPERS[wrapper](*args)
    bf16 = WRAPPERS[wrapper](*args, out_dtype=torch.bfloat16)
    assert len(f32) == len(bf16)
    for a, b in zip(f32, bf16):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
        assert torch.equal(b, a.to(torch.bfloat16))


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("dtype, bad", [
    (torch.bfloat16, torch.float16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float16)], ids=["bf16-f16", "f32-bf16", "f32-f16"])
def test_backward_wrappers_reject_other_out_dtypes(wrapper, dtype, bad):
    args = _bwd_args((1, 2, 8, 16), dtype, False, 0, 0, seed=10)
    with pytest.raises(ValueError, match="out_dtype"):
        WRAPPERS[wrapper](*args, out_dtype=bad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_autograd_backward_takes_the_kernels_gradients_uncast(dtype,
                                                              monkeypatch):
    """``_FlashAttention.backward`` asks ``flash_bwd`` for q's dtype and
    hands those very tensors to autograd: no cast runs after the kernels."""
    calls = []
    real = fa.flash_bwd

    def counting(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw.get("out_dtype"), out))
        return out
    monkeypatch.setattr(fa, "flash_bwd", counting)
    q, k, v = [_t(x).to(dtype).requires_grad_()
               for x in _inputs((1, 2, 16, 16), seed=11)[:3]]
    out = fa.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert len(calls) == 1
    out_dtype, returned = calls[0]
    assert out_dtype == dtype
    assert all(g is r for g, r in zip(got, returned))
    assert all(g.dtype == dtype for g in got)


@pytest.mark.parametrize("case", CASES,
                         ids=_ids)
def test_bf16_out_matches_interpret_kernels_cast(case):
    """The bf16-output backward against the Pallas pair in interpret mode
    with its f32 result cast as ``_bwd_rule`` casts it: the two f32 results
    agree at atol 1e-4 (as above), so after rounding they differ by at most
    one bf16 step (2^-8 relative) or that 1e-4."""
    shape, blk, causal, (qo, ko) = case
    xs = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(shape, seed=12)]
    lse, delta = _jax_residuals(*xs, causal, blk, qo, ko)
    want = jfa._flash_bwd(*xs, lse, delta, causal, blk, blk, qo, ko, True)
    tx = [_t(x.astype(jnp.float32)).bfloat16() for x in xs]
    got = fa.flash_bwd(*tx, _t(lse), _t(delta), causal, qo, ko,
                       out_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(
            g.float().numpy(),
            np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32)),
            atol=1e-4, rtol=2 ** -8)


def test_kernels_match_plain_on_card():
    """Runs where a card is present (``chip_smoke.py`` runs the full set of
    shapes); skips on a host without CUDA. Covers the bf16 d = 64 TMA /
    wgmma route with f32 and bf16 outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = [torch.randn((2, 4, 200, 64), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4)]
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, do, lse, delta, True)
    low = fa.flash_bwd(q, k, v, do, lse, delta, True,
                       out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == \
        (before[0] + 2, before[1] + 2)
    ref = fa.flash_bwd_reference(q, k, v, do, lse, delta, True)
    # ds enters ds.k and ds^T.q as a bf16 pair (~2^-17 relative), so dq and
    # dk sit within 1e-4 of the max (ds rounded once reads ~2e-3); p rounds
    # once to bf16 (2^-9) before p^T.do, so dv sits within 1e-2.
    for g, r, tol in zip(got, ref, (1e-4, 1e-4, 1e-2)):
        assert (g - r).abs().max() <= tol * r.abs().max()
    for g, lo in zip(got, low):
        assert lo.dtype == torch.bfloat16
        assert torch.equal(lo, g.to(torch.bfloat16))
