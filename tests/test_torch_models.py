"""The port's model zoo against the JAX package on the same weights.

JAX params go JAX -> numpy (``jax.device_get``) -> ``convert.params_from_jax``;
inputs come from numpy. f32 forwards agree at atol 2e-5 / rtol 1e-4 (the two
frameworks sum in other orders); the bf16-compute BERT at atol 5e-2, because
the JAX package's dense attention rounds the scores to bf16 and the port's
flash forward keeps them in f32. The conv / batch-norm / LSTM layers and the
ResNet, BiLSTM and NCF forwards: f32 at rtol 1e-4 / atol 1e-5 (single
layers at 1e-5), bf16 compute at 5e-2, batch norm on bf16 input within one
bf16 ulp. ``GraphItem.flops_estimate`` equals the JAX package's on every
scan-free model (rtol 1e-9).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.graph_item import path_to_name as jax_path_to_name
from autodist_tpu.models import ZOO as JZOO
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import bilstm as jbilstm
from autodist_tpu.models import layers as JL
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import mlp as jmlp
from autodist_tpu.models import ncf as jncf
from autodist_tpu.models import resnet as jresnet
from autodist_tpu.models import transformer as JT
from autodist_tpu_torch import convert
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.models import ZOO, bert, bilstm, lm, mlp, ncf, resnet
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


# -- conv, max pool, batch norm, lstm ----------------------------------------

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
# (kernel, stride, input size): odd and even sizes, so stride 2 covers the
# SAME pads (lo, hi) with lo != hi that a symmetric pad gets wrong.
WINDOWS = [(k, s, n) for k in (1, 3, 7) for s in (1, 2) for n in (15, 16)]


def _wid(case):
    return "k{}-s{}-n{}".format(*case)


@pytest.mark.parametrize("case", WINDOWS, ids=_wid)
def test_conv_matches_jax(case):
    k, stride, n = case
    rng = np.random.RandomState(k * 100 + stride * 10 + n)
    x = rng.randn(2, n, n + 3, 4).astype(np.float32)  # H != W
    p = {"kernel": rng.randn(k, k, 4, 6).astype(np.float32),
         "bias": rng.randn(6).astype(np.float32)}
    want = np.asarray(JL.conv(p, x, stride))
    got = L.conv(convert.params_from_jax(p, "cpu"), torch.from_numpy(x),
                 stride)
    assert tuple(got.shape) == want.shape
    assert got.is_contiguous()  # NHWC memory, not a strided view
    _close(got, want, **LAYER_TOL)
    pads = [L.same_pads(d, k, stride) for d in (n, n + 3)]
    if any(lo != hi for lo, hi in pads):
        # F.conv2d's own symmetric padding shifts every window.
        tp = convert.params_from_jax(p, "cpu")
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       tp["kernel"].permute(3, 2, 0, 1), tp["bias"],
                       stride=stride, padding=k // 2).permute(0, 2, 3, 1)
        assert sym.shape != got.shape or not np.allclose(
            sym.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("case", WINDOWS, ids=_wid)
def test_max_pool_matches_jax_reduce_window(case):
    """The ResNet stem's pool (``resnet.py:118``) at every window: SAME
    padding with -inf, so an all-negative edge window keeps its max."""
    k, stride, n = case
    rng = np.random.RandomState(k + stride + n)
    x = (rng.randn(2, n, n + 1, 3) - 3.0).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, k, k, 1), (1, stride, stride, 1),
        "SAME"))
    got = L.max_pool(torch.from_numpy(x), k, stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # The gradient of a ReLU output (ties at 0 in half the windows) goes to
    # the same element of each window as JAX's select-and-scatter.
    xr = np.maximum(x + 3.0, 0.0)
    jgrad = jax.grad(lambda a: jax.lax.reduce_window(
        a, -jnp.inf, jax.lax.max, (1, k, k, 1), (1, stride, stride, 1),
        "SAME").sum())(xr)
    tx = torch.from_numpy(xr).requires_grad_()
    L.max_pool(tx, k, stride).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    pads = [L.same_pads(d, k, stride) for d in (n, n + 1)]
    if any(lo != hi for lo, hi in pads):
        sym = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), k,
                           stride, padding=k // 2).permute(0, 2, 3, 1)
        assert sym.shape != got.shape or not torch.equal(sym, got)


def test_resnet50_stem_pads_asymmetrically():
    """ResNet's asymmetric pads: 3x3 stride 2 on 56/28/14 (and CIFAR's
    32/16) and the pool on 112 pad (0, 1), the 7x7 stem on 224 (2, 3), the
    1x1 stride-2 projections nothing."""
    for n in (56, 28, 14, 32, 16, 112):
        assert L.same_pads(n, 3, 2) == (0, 1)
    assert L.same_pads(224, 7, 2) == (2, 3)
    assert L.same_pads(56, 1, 2) == (0, 0)
    assert L.same_pads(56, 3, 1) == (1, 1)


def test_batchnorm_matches_jax_f32_and_bf16():
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 5, 6, 8) * 3 + 1).astype(np.float32)
    p = {"scale": rng.randn(8).astype(np.float32),
         "bias": rng.randn(8).astype(np.float32)}
    tp = convert.params_from_jax(p, "cpu")
    _close(L.batchnorm(tp, torch.from_numpy(x)), JL.batchnorm(p, x),
           **LAYER_TOL)
    # bf16 input: statistics and normalisation in f32, rounded once, so the
    # two differ by at most one bf16 ulp of the result.
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JL.batchnorm(p, xb), np.float32)
    got = L.batchnorm(tp, torch.from_numpy(np.asarray(xb, np.float32))
                      .to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()
    # Population variance and eps 1e-5: the unbiased variance misses.
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    wrong = (tx - tx.mean((0, 2, 3), keepdim=True)) * torch.rsqrt(
        tx.var((0, 2, 3), keepdim=True) + 1e-5)
    with pytest.raises(AssertionError):
        _close(wrong.permute(0, 2, 3, 1) * tp["scale"] + tp["bias"],
               JL.batchnorm(p, x), **LAYER_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_matches_jax(reverse, dtype):
    rng = np.random.RandomState(int(reverse))
    xs = rng.randn(3, 7, 10).astype(np.float32)
    p = jax.device_get(JL.lstm_init(jax.random.PRNGKey(3), 10, 6))
    p["bias"] = rng.randn(24).astype(np.float32)
    jdt, tdt = ((None, None) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = JL.lstm(p, xs, 6, reverse=reverse, dtype=jdt)
    got = L.lstm(convert.params_from_jax(p, "cpu"), torch.from_numpy(xs), 6,
                 reverse=reverse, dtype=tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 7, 6)
    tol = LAYER_TOL if dtype == "f32" else dict(atol=5e-2, rtol=0)
    _close(got, want, **tol)
    # The forget gate's +1: a cell without it (f's bias block 1 lower)
    # misses.
    tp = convert.params_from_jax(p, "cpu")
    shift = torch.cat([torch.zeros(6), torch.ones(6), torch.zeros(12)])
    with pytest.raises(AssertionError):
        _close(L.lstm(dict(tp, bias=tp["bias"] - shift), torch.from_numpy(xs),
                      6, reverse=reverse, dtype=tdt), want, **tol)


# -- ResNet, BiLSTM, NCF -----------------------------------------------------

def _zoo_pair(name, dtype=jnp.float32):
    """(JAX config, port config, JAX apply on a batch, port apply, the JAX
    tiny fixture's params and batch)."""
    jmod = {"resnet": jresnet, "bilstm": jbilstm, "ncf": jncf}[name]
    jparams, _, batch = jmod.tiny_fixture(seed=0)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    if name == "resnet":
        jcfg = jresnet.cifar_resnet(depth=8, num_classes=10, dtype=dtype)
        cfg = resnet.cifar_resnet(depth=8, num_classes=10, dtype=tdt)
        japply = lambda p, b: jresnet.apply(p, jcfg, b[0])  # noqa: E731
        apply = lambda p, b: resnet.apply(p, cfg, b[0])  # noqa: E731
    elif name == "bilstm":
        jcfg = jbilstm.BiLSTMConfig(vocab=500, embed_dim=32, hidden=32,
                                    dtype=dtype)
        cfg = bilstm.BiLSTMConfig(vocab=500, embed_dim=32, hidden=32,
                                  dtype=tdt)
        japply = lambda p, b: jbilstm.apply(p, jcfg, b[0])  # noqa: E731
        apply = lambda p, b: bilstm.apply(p, cfg, b[0])  # noqa: E731
    else:
        kw = dict(num_users=200, num_items=100, gmf_dim=16,
                  mlp_dims=(32, 16, 8))
        jcfg, cfg = jncf.NCFConfig(dtype=dtype, **kw), ncf.NCFConfig(
            dtype=tdt, **kw)
        japply = lambda p, b: jncf.apply(p, jcfg, b[0], b[1])  # noqa: E731
        apply = lambda p, b: ncf.apply(p, cfg, b[0], b[1])  # noqa: E731
    return jcfg, cfg, japply, apply, jax.device_get(jparams), batch


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["resnet", "bilstm", "ncf"])
def test_zoo_forward_matches_jax(name, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    _, cfg, japply, apply, jparams, batch = _zoo_pair(name, jdt)
    assert cfg.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    want = np.asarray(japply(jparams, batch), np.float32)
    got = apply(convert.params_from_jax(jparams, "cpu"),
                tuple(torch.from_numpy(b) for b in batch))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "f32" else dict(atol=5e-2,
                                                               rtol=0)
    _close(got, want, **tol)


def test_resnet_bf16_gradient_gap_matches_the_jax_packages():
    """A deep ResNet's bf16-compute gradient is far from its f32 gradient
    in the JAX package itself (rounding noise amplified through the depth
    and the batch norms); the port's is as far, the same way. CIFAR
    ResNet-20, batch 8 x 16^2: the whole gradient's cosine and relative L2
    to the f32 gradient within 0.01 / 0.03 of the JAX package's, and the
    two packages' f32 gradients at cosine >= 0.9999."""
    from autodist_tpu_torch.utils.tree import leaves
    rng = np.random.RandomState(0)
    batch = (rng.randn(8, 16, 16, 3).astype(np.float32),
             rng.randint(0, 10, (8,)).astype(np.int32))
    jparams = jax.device_get(jresnet.init(jax.random.PRNGKey(0),
                                          jresnet.cifar_resnet(20)))
    params = convert.params_from_jax(jparams, "cpu")
    tleaves = [t.requires_grad_() for t in leaves(params)]
    tbatch = tuple(torch.from_numpy(b) for b in batch)

    def jgrad(dtype):
        g = jax.grad(jresnet.make_loss_fn(jresnet.cifar_resnet(
            20, dtype=dtype)))(jparams, batch)
        return np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in jax.tree_util.tree_leaves(g)])

    def grad(dtype):
        loss = resnet.make_loss_fn(resnet.cifar_resnet(20, dtype=dtype))(
            params, tbatch)
        return torch.cat([g.flatten() for g in torch.autograd.grad(
            loss, tleaves)]).numpy()

    def gap(a, b):  # (cosine, relative L2) of a against b
        return (float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)),
                float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    j32, p32 = jgrad(jnp.float32), grad(torch.float32)
    want, got = gap(jgrad(jnp.bfloat16), j32), gap(grad(torch.bfloat16), p32)
    print(f"bf16 vs f32 gradient (cosine, relative L2): JAX {want}, port "
          f"{got}; port f32 vs JAX f32 {gap(p32, j32)}")
    assert gap(p32, j32)[0] >= 0.9999
    assert want[1] > 0.1  # the gap is real, not rounding of the result
    assert abs(got[0] - want[0]) <= 0.01 and abs(got[1] - want[1]) <= 0.03


@pytest.mark.parametrize("make", ["resnet50", "resnet18", "cifar_resnet",
                                  "bilstm", "ncf"])
def test_zoo_init_matches_the_jax_param_tree(make):
    """Names, shapes and dtypes leaf for leaf (the JAX side by
    ``jax.eval_shape``: no weights drawn); HWIO conv kernels."""
    if make == "bilstm":
        jtree = jax.eval_shape(lambda: jbilstm.init(
            jax.random.PRNGKey(0), jbilstm.BiLSTMConfig()))
        tree = bilstm.init(bilstm.BiLSTMConfig(), device="cpu")
    elif make == "ncf":
        jtree = jax.eval_shape(lambda: jncf.init(jax.random.PRNGKey(0),
                                                 jncf.NCFConfig()))
        tree = ncf.init(ncf.NCFConfig(), device="cpu")
    else:
        jtree = jax.eval_shape(lambda: jresnet.init(
            jax.random.PRNGKey(0), getattr(jresnet, make)()))
        tree = resnet.init(getattr(resnet, make)(), device="cpu")
    jleaves = {jax_path_to_name(p): l for p, l in
               jax.tree_util.tree_flatten_with_path(jtree)[0]}
    leaves = {path_to_name(p): l for p, l in flatten_with_path(tree)[0]}
    assert sorted(jleaves) == sorted(leaves)
    for k, jl in jleaves.items():
        assert tuple(leaves[k].shape) == jl.shape, k
        assert leaves[k].dtype == torch.float32, k
    if make == "resnet50":
        assert tuple(leaves["stem/conv/kernel"].shape) == (7, 7, 3, 64)
        assert tuple(leaves["stage1/block0/conv2/kernel"].shape) == (
            3, 3, 128, 128)
        k = leaves["stage3/block2/conv3/kernel"]
        assert abs(float(k.std()) - (2 / 512) ** .5) < 0.01  # He normal


def test_zoo_registry_has_the_jax_keys():
    assert sorted(ZOO) == sorted(JZOO)
    for name, mod in ZOO.items():
        assert callable(mod.init) and callable(mod.make_loss_fn), name


# -- GraphItem: flops_estimate, sparse access, precision="bf16" --------------

def _flops_pair(name):
    """(JAX GraphItem, port GraphItem) of a tiny model's loss."""
    if name in ("resnet", "bilstm", "ncf"):
        jmod = {"resnet": jresnet, "bilstm": jbilstm, "ncf": jncf}[name]
        jparams, jloss, batch = jmod.tiny_fixture(seed=0)
        jparams = jax.device_get(jparams)
        jcfg, cfg = _zoo_pair(name)[:2]
        loss = {"resnet": resnet, "bilstm": bilstm,
                "ncf": ncf}[name].make_loss_fn(cfg)
    elif name == "mlp":
        jparams, jloss, batch = jmlp.tiny_fixture(seed=0)
        jparams = jax.device_get(jparams)
        loss = mlp.make_loss_fn(mlp.MLPConfig(in_dim=16, hidden=(32,),
                                              num_classes=4))
    else:
        jmod, mod = (jbert, bert) if name == "bert" else (jlm, lm)
        jcfg = jmod.bert_tiny() if name == "bert" else jmod.lm_tiny()
        cfg = mod.bert_tiny() if name == "bert" else mod.lm_tiny()
        jparams = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
        if name == "bert":
            batch = jbert.synthetic_batch(jcfg, 4, 32)
        else:
            batch = (np.random.RandomState(0).randint(
                0, jcfg.vocab, (4, 33)).astype(np.int32),)
        jloss, loss = jmod.make_loss_fn(jcfg), mod.make_loss_fn(cfg)
    return (JGraphItem.capture(jloss, jparams, None, example_batch=batch),
            GraphItem.capture(loss, convert.params_from_jax(jparams, "cpu"),
                              None, example_batch=batch))


@pytest.mark.parametrize("name", ["resnet", "ncf", "mlp", "bert", "lm"])
def test_flops_estimate_matches_jax(name):
    """Scan-free models: the same matmul and conv count (the attention of
    BERT and the LM: the JAX package's dense einsums off the TPU, the
    port's flash forward's plain version on ``meta`` tensors)."""
    jitem, item = _flops_pair(name)
    assert item.batch_size == jitem.batch_size
    want = jitem.flops_estimate()
    assert want != 2.0 * sum(v.num_elements for v in jitem.variables) * \
        jitem.batch_size  # counted, not the fallback
    np.testing.assert_allclose(item.flops_estimate(), want, rtol=1e-9)


def test_flops_estimate_bilstm_counts_every_time_step():
    """The JAX count does not multiply ``lax.scan`` trip counts: one cell
    per direction. The port's loop counts T: port = JAX + 2 (T - 1) x one
    cell's operations (ROADMAP.md, Queue C)."""
    jitem, item = _flops_pair("bilstm")
    b, t = jitem.batch_struct[0].shape
    cell = 2.0 * b * (32 + 32) * 4 * 32  # x.wi + h.wh, in = hidden = 32
    np.testing.assert_allclose(item.flops_estimate(),
                               jitem.flops_estimate() + 2 * (t - 1) * cell,
                               rtol=1e-9)


def test_flops_estimate_falls_back_without_a_matmul():
    """linreg has no matmul: both packages give 2 x params x batch."""
    from autodist_tpu.models import mlp as jm
    x = np.zeros(8, np.float32)
    jitem = JGraphItem.capture(jm.linreg_loss, jm.linreg_init(), None,
                               example_batch=(x, x))
    item = GraphItem.capture(mlp.linreg_loss, mlp.linreg_init("cpu"), None,
                             example_batch=(x, x))
    assert item.flops_estimate() == jitem.flops_estimate() == 2.0 * 2 * 8


@pytest.mark.parametrize("name", ["ncf", "bilstm", "resnet"])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_sparse_access_flags_match_jax(name, precision):
    """NCF's four tables and the BiLSTM's embedding are read by lookups;
    ResNet has none. Detection runs on the unwrapped loss, so
    ``precision="bf16"`` flags the same tables."""
    jmod = {"resnet": jresnet, "bilstm": jbilstm, "ncf": jncf}[name]
    jparams, jloss, batch = jmod.tiny_fixture(seed=0)
    jparams = jax.device_get(jparams)
    loss = {"resnet": resnet, "bilstm": bilstm,
            "ncf": ncf}[name].make_loss_fn(_zoo_pair(name)[1])
    jitem = JGraphItem.capture(jloss, jparams, None, example_batch=batch,
                               precision=precision)
    item = GraphItem.capture(loss, convert.params_from_jax(jparams, "cpu"),
                             None, example_batch=batch, precision=precision)
    want = sorted(v.name for v in jitem.variables if v.sparse_access)
    assert sorted(v.name for v in item.variables if v.sparse_access) == want
    assert len(want) == {"ncf": 4, "bilstm": 1, "resnet": 0}[name]


def test_bf16_precision_casts_only_f32_leaves_and_returns_f32():
    seen = {}

    def loss_fn(params, batch):
        seen.update(w=params["w"].dtype, n=params["n"].dtype,
                    x=batch[0].dtype, ids=batch[1].dtype)
        y = batch[0] @ params["w"]
        return y.sum(), {"y": y, "n": params["n"]}
    params = {"w": torch.ones(3, 2), "n": torch.arange(3)}
    batch = (torch.ones(4, 3), torch.zeros(4, dtype=torch.int32))
    item = GraphItem.capture(loss_fn, params, None, example_batch=batch,
                             aux_output=True, precision="bf16")
    assert item.precision == "bf16"
    w = params["w"].clone().requires_grad_()
    loss, aux = item.loss_fn({"w": w, "n": params["n"]}, batch)
    assert seen == dict(w=torch.bfloat16, n=torch.int64, x=torch.bfloat16,
                        ids=torch.int32)
    assert loss.dtype == torch.float32 and aux["y"].dtype == torch.float32
    assert aux["n"].dtype == torch.int64
    (g,) = torch.autograd.grad(loss, [w])
    assert g.dtype == torch.float32  # the cast's backward casts back
    with pytest.raises(ValueError, match="precision"):
        GraphItem.capture(loss_fn, params, None, precision="fp16")
