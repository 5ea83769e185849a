"""The port's flash-attention forward (plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode and its dense reference.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` holds it
against the same plain version there, and the last test here does too when
a card is present.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from autodist_tpu.models import layers as JL
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.ops import flash_attention as fa

# The JAX package's ``ops`` re-exports the function under the module's name.
jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

SHAPES = [((2, 3, 32, 16), 16), ((1, 2, 64, 32), 32)]  # (b, h, s, d), block
OFFSETS = [(0, 0), (32, 0), (0, 64)]                    # (q_offset, k_offset)
CASES = [(shape, blk, causal, offs) for shape, blk in SHAPES
         for causal in (False, True) for offs in OFFSETS]


def _ids(case):
    (b, h, s, d), _, causal, (qo, ko) = case
    return f"b{b}h{h}s{s}d{d}-{'causal' if causal else 'full'}-q{qo}k{ko}"


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _to_bf16(xs):
    """bf16 copies for both packages with identical bits."""
    jx = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_matches_interpret_kernel_f32(case):
    shape, blk, causal, (qo, ko) = case
    xs = _inputs(shape)
    jo, jl = jfa._flash_fwd(*map(jnp.asarray, xs), causal, blk, blk, qo, ko,
                            True)
    o, lse = fa.flash_fwd_reference(*map(torch.from_numpy, xs), causal, qo,
                                    ko)
    assert o.dtype == torch.float32 and lse.shape == shape[:3] + (1,)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    if causal and (qo, ko) == (0, 64):
        # Every row is empty: the finite sentinels, exactly.
        assert bool((o == 0).all()) and bool((lse == -1e30).all())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_matches_interpret_kernel_bf16(case):
    """bf16 inputs: o at one bf16 ulp at |o| <= 2 (7.8e-3, so 1e-2); lse
    sums f32 products of the same bf16 values, in another order."""
    shape, blk, causal, (qo, ko) = case
    jx, tx = _to_bf16(_inputs(shape, seed=1))
    jo, jl = jfa._flash_fwd(*jx, causal, blk, blk, qo, ko, True)
    o, lse = fa.flash_fwd(*tx, causal, qo, ko)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), atol=1e-2,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if not (c[2] and c[3] == (0, 64))],
                         ids=_ids)
def test_plain_matches_dense_reference(case):
    """Rows that see at least one key: the JAX dense oracle agrees."""
    shape, _, causal, (qo, ko) = case
    xs = _inputs(shape, seed=2)
    jo, jl = jfa._dense_fwd(*map(jnp.asarray, xs), causal, qo, ko)
    o, lse = fa.flash_fwd(*map(torch.from_numpy, xs), causal, qo, ko,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


def test_bf16_in_f32_out_matches_block_attn_fwd():
    """``out_dtype=float32`` is ring attention's per-block call."""
    jx, tx = _to_bf16(_inputs((1, 2, 32, 16), seed=3))
    jo, jl = jfa.block_attn_fwd(*jx, True, 16, 0, 16, 16, interpret=True)
    o, lse = fa.flash_fwd(*tx, True, 16, 0, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_dual_output_matches_interpret_kernel(case):
    """The training call's plain version: f32 o, lse, and o in q's dtype,
    which is the f32 o cast to bf16 exactly; lse and o against the
    interpret-mode Pallas kernel at the bf16 tolerances above."""
    shape, blk, causal, (qo, ko) = case
    jx, tx = _to_bf16(_inputs(shape, seed=8))
    jo, jl = jfa._flash_fwd(*jx, causal, blk, blk, qo, ko, True)
    o, lse, lowp = fa.flash_fwd(*tx, causal, qo, ko, out_dtype=torch.float32,
                                with_lowp=True)
    assert o.dtype == torch.float32 and lowp.dtype == torch.bfloat16
    assert torch.equal(lowp, o.to(torch.bfloat16))
    ro, rl, rlowp = fa.flash_fwd_reference(*tx, causal, qo, ko,
                                           out_dtype=torch.float32,
                                           with_lowp=True)
    assert all(torch.equal(a, b) for a, b in ((o, ro), (lse, rl),
                                              (lowp, rlowp)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(lowp.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), atol=1e-2,
                               rtol=0)


def test_dual_output_of_f32_inputs_is_o_itself():
    xs = [torch.from_numpy(x) for x in _inputs((1, 2, 16, 16), seed=9)]
    o, lse, lowp = fa.flash_fwd(*xs, out_dtype=torch.float32, with_lowp=True)
    assert lowp is o


def test_tma_ready_copies_only_what_tma_cannot_read():
    """bf16 inputs of the TMA route need a 16-byte aligned base and (b, h,
    s) strides that are positive multiples of 8 elements; others are
    copied, explicitly, into a fresh contiguous tensor."""
    x = torch.randn(2, 3, 10, 64).bfloat16()
    assert fa._tma_ready(x) is x
    view = torch.randn(2, 10, 3, 64).bfloat16().transpose(1, 2)
    assert fa._tma_ready(view) is view  # the model's layout: no copy
    for odd in (torch.randn(2, 3, 10, 65).bfloat16()[..., 1:],
                torch.randn(1, 3, 10, 64).bfloat16().expand(2, 3, 10, 64)):
        copied = fa._tma_ready(odd)
        assert copied is not odd and copied.is_contiguous()
        assert torch.equal(copied, odd)


def test_cpu_tensors_never_count_a_launch():
    xs = [torch.from_numpy(x) for x in _inputs((2, 3, 32, 16))]
    before = fa.flash_fwd.launches
    fa.flash_fwd(*xs)
    fa.flash_attention(*xs, causal=True)
    fa.make_flash_attn_fn(causal=False)(*xs)
    assert fa.flash_fwd.launches == before


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_matches_jax(causal):
    xs = _inputs((2, 2, 32, 16), seed=4)
    want = jfa.flash_attention(*map(jnp.asarray, xs), causal, 8, 8, 0, True)
    got = fa.flash_attention(*map(torch.from_numpy, xs), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_vjp_matches_jax(causal):
    """The autograd path (training's call: the dual-output forward, then
    the backward from its f32 o) against ``jax.vjp`` of the JAX package's
    custom_vjp in interpret mode: the forward and the gradients at 1e-5."""
    q, k, v, g = [x for x in _inputs((2, 2, 32, 16), seed=7)] + [
        np.random.RandomState(10).randn(2, 2, 32, 16).astype(np.float32)]
    want_o, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal, 8, 8, 0, True),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_attn_fn_with_mask_is_dot_product_attention():
    """An explicit boolean mask goes to the dense reference attention, in
    both packages, and the two agree."""
    xs = _inputs((2, 2, 16, 16), seed=5)
    rng = np.random.RandomState(6)
    mask = rng.rand(1, 1, 16, 16) > 0.3
    mask[..., 0] = True
    tx = [torch.from_numpy(x) for x in xs]
    got = fa.make_flash_attn_fn(causal=False)(*tx, torch.from_numpy(mask))
    same = L.dot_product_attention(*tx, torch.from_numpy(mask))
    assert torch.equal(got, same)
    want = jfa.make_flash_attn_fn(causal=False)(*map(jnp.asarray, xs),
                                                jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JL.dot_product_attention(
            *map(jnp.asarray, xs), jnp.asarray(mask))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bad, match", [
    (dict(d=24), "head_dim 24"),
    (dict(kdtype=torch.float16), "one dtype"),
    (dict(sk_d=32), "do not fit"),
    (dict(out_dtype=torch.float16), "out_dtype"),
], ids=["head-dim", "dtype", "shapes", "out-dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    d = bad.get("d", 16)
    q = torch.zeros(1, 2, 8, d)
    k = torch.zeros(1, 2, 8, bad.get("sk_d", d), dtype=bad.get("kdtype",
                                                              torch.float32))
    v = k.clone()
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(q, k, v, out_dtype=bad.get("out_dtype"))


def test_causal_bias_matches_jax():
    want = np.asarray(jfa.causal_bias(8, 12, 4, 2))
    got = fa.causal_bias(8, 12, 4, 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_matches_plain_on_card():
    """Runs where a card is present (``chip_smoke.py`` runs the full set of
    shapes); skips on a host without CUDA. The TMA / wgmma route at d = 64
    and 128, with a bf16 o and with the training call's f32 + bf16 o (f32
    o at atol 5e-5: P enters P.V as a bf16 pair)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (64, 128):
        q, k, v = [torch.randn((2, 4, 200, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3)]
        before = fa.flash_fwd.launches
        o, lse = fa.flash_fwd(q, k, v, True)
        o32, lse32, o16 = fa.flash_fwd(q, k, v, True,
                                       out_dtype=torch.float32,
                                       with_lowp=True)
        torch.cuda.synchronize()
        assert fa.flash_fwd.launches == before + 2
        ro, rl = fa.flash_fwd_reference(q, k, v, True,
                                        out_dtype=torch.float32)
        torch.testing.assert_close(o.float(), ro, atol=1.6e-2, rtol=1e-2)
        torch.testing.assert_close(o32, ro, atol=5e-5, rtol=0)
        assert torch.equal(o16, o32.to(torch.bfloat16))
        for got in (lse, lse32):
            torch.testing.assert_close(got, rl, atol=1e-4, rtol=0)
