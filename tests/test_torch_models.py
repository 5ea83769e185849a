"""The port's model zoo against the JAX package on the same weights.

JAX params go JAX -> numpy (``jax.device_get``) -> ``convert.params_from_jax``;
inputs come from numpy. f32 forwards agree at atol 2e-5 / rtol 1e-4 (the two
frameworks sum in other orders); the bf16-compute BERT at atol 5e-2, because
the JAX package's dense attention rounds the scores to bf16 and the port's
flash forward keeps them in f32.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from autodist_tpu.graph_item import path_to_name as jax_path_to_name
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import layers as JL
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import transformer as JT
from autodist_tpu_torch import convert
from autodist_tpu_torch.models import bert, lm
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

ATOL, RTOL = 2e-5, 1e-4
CONFIGS = {"bert_tiny": (jbert.bert_tiny, bert.bert_tiny),
           "lm_tiny": (jlm.lm_tiny, lm.lm_tiny)}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _models(name, seed=0, **kw):
    jmake, make = CONFIGS[name]
    jcfg, cfg = jmake(**kw), make(**{k: (torch.bfloat16 if v == jnp.bfloat16
                                         else v) for k, v in kw.items()})
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jparams, convert.params_from_jax(jparams, device="cpu")


def _batch(jcfg, seed=0, rows=3, seq=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, jcfg.vocab, (rows, seq)).astype(np.int32)
    seg = rng.randint(0, 2, (rows, seq)).astype(np.int32)
    return ids, seg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_from_jax_keeps_names_shapes_dtypes(name):
    _, _, jparams, params = _models(name)
    jleaves = {jax_path_to_name(p): l for p, l in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    leaves = {path_to_name(p): l for p, l in flatten_with_path(params)[0]}
    assert sorted(jleaves) == sorted(leaves)
    for k, jl in jleaves.items():
        assert tuple(leaves[k].shape) == np.shape(jl), k
        assert leaves[k].dtype == torch.from_numpy(
            np.empty(0, np.asarray(jl).dtype)).dtype, k
    # Layouts: dense kernels (in, out), the embedding (vocab, dim).
    assert tuple(leaves["layer0/mlp/up/kernel"].shape) == (64, 256)
    assert leaves["embed/embedding"].shape[0] == CONFIGS[name][1]().vocab


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_params_to_numpy_round_trips_bitwise(name):
    _, _, jparams, params = _models(name)
    back = convert.params_to_numpy(params)
    jflat, jdef = jax.tree_util.tree_flatten(jparams)
    flat, treedef = jax.tree_util.tree_flatten(back)
    assert jdef == treedef
    for a, b in zip(jflat, flat):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_leaves_cross_bitwise():
    rng = np.random.RandomState(0)
    tree = {"w": np.asarray(jnp.asarray(rng.randn(4, 5), jnp.bfloat16)),
            "b": {"x": rng.randn(3).astype(np.float32)}}
    params = convert.params_from_jax(tree, device="cpu")
    assert params["w"].dtype == torch.bfloat16
    back = convert.params_to_numpy(params)
    assert back["w"].dtype == tree["w"].dtype
    np.testing.assert_array_equal(back["w"].view(np.uint16),
                                  tree["w"].view(np.uint16))
    np.testing.assert_array_equal(back["b"]["x"], tree["b"]["x"])


def test_dense_layernorm_mha_match_jax():
    key = jax.random.PRNGKey(1)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 16).astype(np.float32)
    pd = jax.device_get(JL.dense_init(key, 16, 8))
    pd["bias"] = rng.randn(8).astype(np.float32)
    _close(L.dense(convert.params_from_jax(pd, "cpu"), torch.from_numpy(x)),
           JL.dense(pd, x))
    pl = {"scale": rng.randn(16).astype(np.float32),
          "bias": rng.randn(16).astype(np.float32)}
    _close(L.layernorm(convert.params_from_jax(pl, "cpu"),
                       torch.from_numpy(x)), JL.layernorm(pl, x))
    pm = jax.device_get(JL.mha_init(key, 16, 4))
    tm = convert.params_from_jax(pm, "cpu")
    for mask in (None, JL.causal_mask(6)):
        tmask = None if mask is None else torch.from_numpy(np.array(mask))
        _close(L.mha(tm, torch.from_numpy(x), 4, mask=tmask),
               JL.mha(pm, x, 4, mask=mask))
    assert torch.equal(L.causal_mask(6), torch.from_numpy(
        np.array(JL.causal_mask(6))))


def _jax_interpret_flash(causal):
    def attn_fn(q, k, v, mask=None):  # causality is positional
        return jfa.flash_attention(q, k, v, causal, 8, 8, 0, True)
    return attn_fn


@pytest.mark.parametrize("jax_attn", ["default", "interpret-flash"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_and_logits_match_jax_f32(name, jax_attn):
    """JAX once with its default attention (dense off-TPU) and once with
    the Pallas kernel in interpret mode; the port with its flash forward
    (the plain version on CPU tensors). BERT carries segment ids."""
    jcfg, cfg, jparams, params = _models(name)
    ids, seg = _batch(jcfg)
    jseg = seg if jcfg.num_segments else None
    attn = None if jax_attn == "default" else _jax_interpret_flash(jcfg.causal)
    jh = JT.encode(jparams, jcfg, ids, segment_ids=jseg, attn_fn=attn)
    h = T.encode(params, cfg, torch.from_numpy(ids),
                 segment_ids=None if jseg is None else torch.from_numpy(seg))
    _close(h, jh)
    _close(T.logits(params, cfg, h), JT.logits(jparams, jcfg, jh),
           atol=1e-4)


def test_encode_with_explicit_attn_fn_gets_the_causal_mask():
    jcfg, cfg, jparams, params = _models("lm_tiny")
    ids, _ = _batch(jcfg, seed=3)
    jh = JT.encode(jparams, jcfg, ids, attn_fn=JL.dot_product_attention)
    h = T.encode(params, cfg, torch.from_numpy(ids),
                 attn_fn=L.dot_product_attention)
    _close(h, jh)


def test_bert_bf16_compute_matches_jax():
    """atol 5e-2: JAX's dense attention rounds the scores to bf16
    (``flash_attention.py:62``); the port's flash forward does not."""
    jcfg, cfg, jparams, params = _models("bert_tiny", dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16
    ids, seg = _batch(jcfg, seed=2)
    jh = JT.encode(jparams, jcfg, ids, segment_ids=seg)
    h = T.encode(params, cfg, torch.from_numpy(ids),
                 segment_ids=torch.from_numpy(seg))
    assert h.dtype == torch.bfloat16
    _close(h, jnp.asarray(jh, jnp.float32), atol=5e-2, rtol=0)


def test_gelu_is_the_tanh_approximation(monkeypatch):
    """A block whose MLP pre-activations are large enough that erf-gelu
    would miss the tolerance: the port matches JAX's tanh gelu."""
    jcfg, cfg, jparams, params = _models("bert_tiny", seed=4)
    jp = dict(jparams["layer0"])
    jp["mlp"] = {"up": {"kernel": jp["mlp"]["up"]["kernel"] * 8.0,
                        "bias": jp["mlp"]["up"]["bias"]},
                 "down": jp["mlp"]["down"]}
    tp = convert.params_from_jax(jp, "cpu")
    x = np.random.RandomState(5).randn(2, 8, 64).astype(np.float32)
    want = JT.block_apply(jp, x, jcfg)
    got = T.block_apply(tp, torch.from_numpy(x), cfg)
    _close(got, want)
    erf = F.gelu
    monkeypatch.setattr(T.F, "gelu", lambda t, approximate="none": erf(t))
    wrong = T.block_apply(tp, torch.from_numpy(x), cfg)
    with pytest.raises(AssertionError):
        _close(wrong, want)


def test_layernorm_eps_and_population_variance():
    """Inputs of variance ~1e-6: eps 1e-6 vs F.layer_norm's 1e-5 (or the
    unbiased variance) would miss the tolerance; the port matches JAX."""
    x = (np.random.RandomState(6).randn(4, 16) * 1e-3).astype(np.float32)
    p = {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}
    want = JL.layernorm(p, x)
    tx = torch.from_numpy(x)
    _close(L.layernorm(convert.params_from_jax(p, "cpu"), tx), want)
    for wrong in (F.layer_norm(tx, (16,)),
                  (tx - tx.mean(-1, keepdim=True)) *
                  torch.rsqrt(tx.var(-1, keepdim=True) + 1e-6)):
        with pytest.raises(AssertionError):
            _close(wrong, want)


def test_init_draws_the_jax_distributions_on_the_cpu():
    cfg = bert.bert_tiny()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    again = bert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(0),
                                     jbert.bert_tiny()))
    for (p, t), (_, a) in zip(flatten_with_path(params)[0],
                              flatten_with_path(again)[0]):
        assert torch.equal(t, a)  # seeded
    k = params["layer0"]["attn"]["query"]["kernel"]
    jk = jparams["layer0"]["attn"]["query"]["kernel"]
    assert k.shape == jk.shape and float(k.abs().max()) <= 2 * (2 / 64) ** .5
    assert abs(float(k.std()) - float(np.std(jk))) < 0.02
    assert float(params["embed"]["embedding"].std()) == pytest.approx(
        0.02, rel=0.1)
    assert torch.equal(params["ln_f"]["scale"], torch.ones(64))
