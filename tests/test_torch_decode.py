"""The port's KV-cache decode (``device="cpu"``) against the JAX package's on
the same ``lm_tiny`` f32 weights, carried across by ``convert.params_from_jax``.

Tolerances: port against JAX, logits within 1e-5 of the largest |logit|
(read ~8e-7: the two frameworks sum in other orders); the port's step
against its own full-prefix recompute within 1e-5 of the largest |logit|,
greedy tokens equal. Bitwise where the shapes are the same and only the
contents differ: a freed slot's stale rows, and a request re-dispatched by
``scale_to``.
"""
import functools

import numpy as np
import jax
import pytest
import torch

from autodist_tpu import observability
from autodist_tpu import serve as jserve
from autodist_tpu.models import layers as JL
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import transformer as JT
from autodist_tpu_torch import convert, serve
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import lm
from autodist_tpu_torch.models import transformer as T

CFG, JCFG = lm.lm_tiny(), jlm.lm_tiny()
JAX_RTOL = 1e-5      # port vs JAX, relative to max |logit|
SELF_RTOL = 1e-5     # port step vs its own recompute, relative to max |logit|


@pytest.fixture(autouse=True)
def _fresh_metrics():
    observability.reset()
    yield
    observability.reset()


@pytest.fixture(scope="module")
def weights():
    jparams = jax.device_get(jlm.init(jax.random.PRNGKey(0), JCFG))
    return jparams, convert.params_from_jax(jparams, "cpu")


def _apply(p, batch):
    (tokens,) = batch if isinstance(batch, (tuple, list)) else (batch,)
    return T.logits(p, CFG, T.encode(p, CFG, tokens))


def _japply(p, batch):
    (tokens,) = batch if isinstance(batch, (tuple, list)) else (batch,)
    return JT.logits(p, JCFG, JT.encode(p, JCFG, tokens))


EXAMPLE = (np.zeros((8, 16), np.int32),)


def _server(params, **kw):
    kw.setdefault("buckets", ((8, 32),))
    return serve.DecodeServer(_apply, lm.make_decode_fn(CFG),
                              functools.partial(lm.init_decode_cache, CFG),
                              params, EXAMPLE, device="cpu", **kw)


def _step(params, cache, tok, pos, cfg=CFG):
    with torch.inference_mode():
        logits, cache = lm.make_decode_fn(cfg)(
            params, cache, torch.from_numpy(tok), torch.from_numpy(pos))
    return logits, cache


def _recompute(params, ids, cfg=CFG):
    """The port's full-prefix forward at the padded cache length, dense
    attention."""
    with torch.inference_mode():
        return T.logits(params, cfg, T.encode(
            params, cfg, torch.as_tensor(ids),
            attn_fn=L.dot_product_attention))


def _ref_greedy(params, prompt, n, cache_len):
    toks = list(prompt)
    for _ in range(n):
        ids = np.zeros((1, cache_len), np.int64)
        ids[0, :len(toks)] = toks
        toks.append(int(_recompute(params, ids)[0, len(toks) - 1].argmax()))
    return toks[len(prompt):]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() /
                 np.abs(want).max())


# -- (a) the decode functions against the JAX package -------------------------


def test_mha_decode_matches_jax_and_writes_the_cache_in_place(weights):
    jparams, params = weights
    rng = np.random.RandomState(0)
    slots, cache_len, hd = 3, 12, CFG.dim // CFG.num_heads
    x = rng.randn(slots, 1, CFG.dim).astype(np.float32)
    kc, vc = [rng.randn(slots, CFG.num_heads, cache_len, hd)
              .astype(np.float32) for _ in range(2)]
    pos = np.array([0, 7, 11], np.int32)
    jout, jk, jv = JL.mha_decode(jparams["layer0"]["attn"], x, CFG.num_heads,
                                 kc, vc, pos)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out, k2, v2 = L.mha_decode(params["layer0"]["attn"], torch.from_numpy(x),
                               CFG.num_heads, tk, tv, torch.from_numpy(pos))
    assert k2 is tk and v2 is tv
    assert _rel(out, jout) <= JAX_RTOL
    for got, want, old in ((tk, jk, kc), (tv, jv, vc)):
        got, want = got.numpy(), np.asarray(want)
        written = np.zeros(got.shape, bool)
        written[np.arange(slots), :, pos] = True
        np.testing.assert_array_equal(got[~written], old[~written])
        np.testing.assert_allclose(got[written], want[written], atol=1e-6,
                                   rtol=1e-5)


def test_decode_step_matches_jax_over_ragged_teacher_forced_slots(weights):
    """Ragged prompts in four slots, prefill and generation interleaved (the
    JAX package's bitwise test's sequence): every step's logits of the
    port within 1e-5 of the largest |logit| of JAX's, and the streams grow
    by the same greedy tokens."""
    jparams, params = weights
    rng = np.random.RandomState(0)
    slots, cache_len = 4, 32
    jcache = jlm.init_decode_cache(JCFG, slots, cache_len)
    cache = lm.init_decode_cache(CFG, slots, cache_len, device="cpu")
    jstep = jax.jit(jlm.make_decode_fn(JCFG))
    streams = [rng.randint(1, CFG.vocab, (n,)).tolist() for n in (3, 9, 5, 7)]
    worst = 0.0
    for s in range(max(len(p) for p in streams) + 5):
        tok = np.zeros((slots,), np.int32)
        pos = np.zeros((slots,), np.int32)
        active = [i for i, st in enumerate(streams) if s < len(st)]
        for i in active:
            tok[i], pos[i] = streams[i][s], s
        jlogits, jcache = jstep(jparams, jcache, tok, pos)
        logits, cache = _step(params, cache, tok, pos)
        jlogits = np.asarray(jlogits)
        for i in active:
            worst = max(worst, _rel(logits[i], jlogits[i]))
            if s == len(streams[i]) - 1:
                assert int(logits[i].argmax()) == int(jlogits[i].argmax())
                streams[i].append(int(logits[i].argmax()))
    assert worst <= JAX_RTOL, worst
    for name in cache:
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       np.asarray(jcache[name][key]),
                                       atol=1e-5, rtol=1e-5)


def test_init_cache_layout_and_cache_len_limit():
    cache = lm.init_decode_cache(CFG, 4, 16, device="cpu")
    jcache = jlm.init_decode_cache(JCFG, 4, 16)
    assert sorted(cache) == sorted(jcache)
    for name, kv in cache.items():
        for key in ("k", "v"):
            assert tuple(kv[key].shape) == jcache[name][key].shape
            assert kv[key].dtype == CFG.dtype and not kv[key].any()
    bf = T.init_cache(lm.lm_tiny(dtype=torch.bfloat16), 2, 8, device="cpu")
    assert bf["layer0"]["k"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="exceeds the model's max_len"):
        lm.init_decode_cache(CFG, 1, CFG.max_len + 1, device="cpu")
    with pytest.raises(ValueError, match="exceeds the model's max_len"):
        jlm.init_decode_cache(JCFG, 1, JCFG.max_len + 1)


# -- (b) the step against the port's own full-prefix recompute ----------------


def test_decode_step_matches_its_full_prefix_recompute(weights):
    """Every step's logits against ``encode`` over the prefix padded to the
    cache length (dense attention), and greedy tokens equal.

    Not bitwise, as the JAX package's test is: PyTorch's CPU matmul does not
    give a row the same bits when it is one of 4 rows (the step) as when it
    is one of 4 x 32 (the recompute), so the projections differ in the last
    ulp. The JAX package broadcasts the step's query to ``cache_len`` rows to
    match its attention matmul too; the port computes one row."""
    _, params = weights
    rng = np.random.RandomState(1)
    slots, cache_len = 4, 32
    cache = lm.init_decode_cache(CFG, slots, cache_len, device="cpu")
    streams = [rng.randint(1, CFG.vocab, (n,)).tolist() for n in (3, 9, 5, 7)]
    worst = 0.0
    for s in range(max(len(p) for p in streams) + 5):
        tok = np.zeros((slots,), np.int64)
        pos = np.zeros((slots,), np.int64)
        active = [i for i, st in enumerate(streams) if s < len(st)]
        for i in active:
            tok[i], pos[i] = streams[i][s], s
        logits, cache = _step(params, cache, tok, pos)
        for i in active:
            ids = np.zeros((1, cache_len), np.int64)
            ids[0, :s + 1] = streams[i][:s + 1]
            want = _recompute(params, ids)[0, s]
            worst = max(worst, _rel(logits[i], want))
            if s == len(streams[i]) - 1:
                assert int(logits[i].argmax()) == int(want.argmax())
                streams[i].append(int(logits[i].argmax()))
    assert worst <= SELF_RTOL, worst


# -- (c) a freed slot leaks nothing -------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_freed_slot_reuse_is_bitwise_a_fresh_cache(weights, dtype):
    """Slot 0's logits for request B are bitwise the same over a zeroed
    cache and over a cache whose every row request A filled: rows past
    ``pos`` get exactly 0 probability."""
    cfg = lm.lm_tiny(dtype=dtype)
    params = weights[1]
    rng = np.random.RandomState(2)
    slots, cache_len = 2, 16
    full = rng.randint(1, CFG.vocab, (cache_len,)).tolist()
    b_prompt = rng.randint(1, CFG.vocab, (5,)).tolist()

    def run_b(cache):
        out = []
        for s, t in enumerate(b_prompt):
            logits, cache = _step(params, cache, np.array([t, 0]),
                                  np.array([s, 0]), cfg)
            out.append(logits[0].clone())
        return torch.stack(out)
    fresh = run_b(T.init_cache(cfg, slots, cache_len, device="cpu"))
    cache = T.init_cache(cfg, slots, cache_len, device="cpu")
    for s, t in enumerate(full):
        _, cache = _step(params, cache, np.array([t, 0]), np.array([s, 0]),
                         cfg)
    assert cache["layer0"]["k"][0].abs().amin(dim=-1).gt(0).any()
    assert torch.equal(run_b(cache), fresh)


# -- (d) the server against the JAX package's ---------------------------------


def test_decode_server_greedy_tokens_match_jax_server(weights):
    jparams, params = weights
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, CFG.vocab, (n,)).tolist()
               for n in (3, 9, 5, 7, 2, 8)]
    with jserve.DecodeServer(
            _japply, jlm.make_decode_fn(JCFG),
            lambda s, n: jlm.init_decode_cache(JCFG, s, n), jparams,
            EXAMPLE, buckets=((8, 32),)) as jsrv:
        want = [np.asarray(f.result(timeout=120)) for f in
                [jsrv.submit(p, max_new_tokens=5) for p in prompts]]
    with _server(params) as srv:
        futs = [srv.submit(p, max_new_tokens=5) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
        st = srv.stats()
    for p, g, w in zip(prompts, got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _ref_greedy(params, p, 5, 32))
    assert st["completed"] == st["requests"] == len(prompts)
    assert st["tokens"] == 5 * len(prompts)
    assert st["in_flight"] == 0 and st["queue_depth"] == 0
    assert set(st) == {"requests", "completed", "tokens", "queue_depth",
                       "in_flight", "replicas", "scale_events", "buckets"}


def test_lane_ids_are_np_argmax_of_its_logits(weights):
    """The lane returns the greedy ids alone; they are ``np.argmax`` of
    the step's logits, row by row (the first maximum on ties)."""
    _, params = weights
    with _server(params) as srv:
        srv.engine._stop_threads()
        lane = srv.engine.replicas[0].lanes[0]
        assert lane.graph is None  # the CPU steps eagerly
        rng = np.random.RandomState(4)
        for s in range(3):
            ids = lane._run(rng.randint(1, CFG.vocab, 8), np.full(8, s))
            np.testing.assert_array_equal(
                ids, lane.logits.numpy().argmax(-1))
    tie = torch.tensor([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    np.testing.assert_array_equal(tie.argmax(-1).numpy(),
                                  tie.numpy().argmax(-1))


# -- (e) admission control, EOS, bucket rules, env ----------------------------


def test_decode_submit_validation(weights):
    _, params = weights
    rng = np.random.RandomState(5)
    with _server(params) as srv:
        with pytest.raises(ValueError, match="empty prompt"):
            srv.submit([])
        with pytest.raises(ValueError, match="cache_len"):
            srv.submit(rng.randint(1, CFG.vocab, (30,)), max_new_tokens=5)
        with pytest.raises(ValueError, match="max_new_tokens"):
            srv.submit([1, 2], max_new_tokens=0)
        # The server survives rejections.
        assert len(srv.generate([1, 2, 3], max_new_tokens=2,
                                timeout=120)) == 2


def test_decode_eos_stops_early(weights):
    _, params = weights
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, CFG.vocab, (4,)).tolist()
    full = _ref_greedy(params, prompt, 8, 32)
    with _server(params) as srv:
        out = srv.generate(prompt, max_new_tokens=8, eos=full[2],
                           timeout=120)
    assert out.tolist() == full[:full.index(full[2]) + 1]


def _two_host_devices(tmp_path):
    path = tmp_path / "spec.yml"
    path.write_text("nodes:\n  - address: localhost\n    cpus: [0, 1]\n")
    return str(path)


def test_decode_slots_must_divide_data_axis(weights, tmp_path):
    _, params = weights
    with pytest.raises(ValueError, match="not divisible"):
        serve.DecodeEngine(_apply, lm.make_decode_fn(CFG),
                           functools.partial(lm.init_decode_cache, CFG),
                           params, EXAMPLE, buckets=((3, 32),),
                           resource_spec=_two_host_devices(tmp_path),
                           device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        serve.DecodeEngine(_apply, lm.make_decode_fn(CFG),
                           functools.partial(lm.init_decode_cache, CFG),
                           params, EXAMPLE, buckets=(8, 32), device="cpu")


@pytest.mark.parametrize("env", [{}, {"AUTODIST_DECODE_SLOTS": "4"},
                                 {"AUTODIST_DECODE_SLOTS": "0",
                                  "AUTODIST_DECODE_CACHE_LEN": "512"}],
                         ids=["default", "slots", "clamped"])
def test_decode_buckets_from_env_matches_jax(monkeypatch, env):
    from autodist_tpu.serve.decode import decode_buckets_from_env as jbuckets
    for name in ("AUTODIST_DECODE_SLOTS", "AUTODIST_DECODE_CACHE_LEN"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    assert serve.decode_buckets_from_env() == jbuckets()


def test_decode_engine_default_bucket_and_cache_bytes(weights, monkeypatch):
    _, params = weights
    monkeypatch.setenv("AUTODIST_DECODE_SLOTS", "2")
    monkeypatch.setenv("AUTODIST_DECODE_CACHE_LEN", "16")
    engine = serve.DecodeEngine(
        _apply, lm.make_decode_fn(CFG),
        functools.partial(lm.init_decode_cache, CFG), params, EXAMPLE,
        device="cpu")
    assert engine.buckets == [(2, 16)] and engine.max_cache_len == 16
    hd = CFG.dim // CFG.num_heads
    assert engine.cache_bytes(2, 16) == \
        CFG.num_layers * 2 * 2 * CFG.num_heads * 16 * hd * 4
    engine.close()


# -- (f) zero-drop scale events -----------------------------------------------


def test_forced_shrink_grow_completes_all_requests_exactly_once(weights,
                                                                tmp_path):
    """replicas 2 -> 1 -> 2 (one host device each) with requests in flight
    and queued: every request completes exactly once, and its tokens are
    bitwise those of an uninterrupted run."""
    _, params = weights
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, CFG.vocab, (2 + (i % 7),)).tolist()
               for i in range(24)]
    with _server(params) as srv:
        plain = [f.result(timeout=300) for f in
                 [srv.submit(p, max_new_tokens=10) for p in prompts]]
    srv = _server(params, replicas=2,
                  resource_spec=_two_host_devices(tmp_path))
    try:
        assert [r.program.mesh.size for r in srv.engine.replicas] == [1, 1]
        futs = [srv.submit(p, max_new_tokens=10) for p in prompts]
        redispatched = srv.scale_to(1)   # forced shrink, mid-flight
        futs.extend(srv.submit(p, max_new_tokens=10) for p in prompts[:4])
        srv.scale_to(2)                  # forced grow, still mid-flight
        expected = plain + plain[:4]
        for want, f in zip(expected, futs):
            np.testing.assert_array_equal(f.result(timeout=300), want)
        st = srv.stats()
        assert st["completed"] == st["requests"] == len(expected)
        assert st["tokens"] == 10 * len(expected)
        assert st["scale_events"] == 2 and st["replicas"] == 2
        assert st["queue_depth"] == 0 and st["in_flight"] == 0
        assert redispatched >= 0  # the drained count depends on timing
    finally:
        srv.close()


def test_scale_to_releases_every_lane_before_rebuilding(weights, tmp_path):
    _, params = weights
    with _server(params, replicas=2,
                 resource_spec=_two_host_devices(tmp_path)) as srv:
        old = list(srv.engine.replicas)
        lanes = [ln for r in old for ln in r.lanes]
        assert srv.scale_to(2) == 0  # same size: nothing happens
        assert srv.scale_to(1) == 0
        assert all(ln.cache is None and ln.graph is None for ln in lanes)
        assert all(r.params is None and not r.lanes for r in old)
        with pytest.raises(ValueError, match=">= 1"):
            srv.scale_to(0)


# -- (g) shutdown --------------------------------------------------------------


def test_close_fails_pending_futures_loudly(weights):
    _, params = weights
    srv = _server(params)
    srv.engine._stop_threads()  # the queued request cannot complete
    fut = srv.submit([3, 4, 5], max_new_tokens=4)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit([1, 2])
    srv.close()  # idempotent


def test_decode_entry_points_default_to_cuda_and_raise_without_it(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, params = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_decode_cache(CFG, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.DecodeServer(_apply, lm.make_decode_fn(CFG),
                           functools.partial(lm.init_decode_cache, CFG),
                           params, EXAMPLE, buckets=((2, 8),))


# -- (h) on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_graph_replay_is_bitwise_the_eager_step_on_card(weights):
    """Runs where a card is present (``chip_smoke.py`` phase 6 runs lm1b);
    skips on a host without CUDA. A lane's captured step, replayed, gives
    bitwise the eager step's logits and cache; its ids are ``np.argmax`` of
    the logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from autodist_tpu_torch.utils.tree import leaves
    jparams, _ = weights
    params = convert.params_from_jax(jparams, "cuda")
    cfg = lm.lm_tiny(dtype=torch.bfloat16)
    with serve.DecodeServer(
            lambda p, b: T.logits(p, cfg, T.encode(p, cfg, b[0])),
            lm.make_decode_fn(cfg), functools.partial(lm.init_decode_cache,
                                                      cfg),
            params, EXAMPLE, buckets=((8, 32),)) as srv:
        srv.engine._stop_threads()
        lane = srv.engine.replicas[0].lanes[0]
        assert lane.graph is not None
        rng = np.random.RandomState(8)
        for s in range(4):
            tok, pos = rng.randint(1, CFG.vocab, 8), np.full(8, s)
            before = [t.clone() for t in leaves(lane.cache)]
            ids = lane._run(tok, pos).copy()
            logits = lane.logits.clone()
            after = [t.clone() for t in leaves(lane.cache)]
            for t, b in zip(leaves(lane.cache), before):
                t.copy_(b)
            lane.tokens.copy_(torch.from_numpy(tok))
            lane.pos.copy_(torch.from_numpy(pos))
            eager, eager_ids = lane._compute()
            assert torch.equal(eager, logits)
            assert all(torch.equal(a, b)
                       for a, b in zip(leaves(lane.cache), after))
            np.testing.assert_array_equal(ids, eager_ids.cpu().numpy())
            np.testing.assert_array_equal(ids,
                                          logits.cpu().numpy().argmax(-1))


# -- telemetry, the KV-cache class and the bucket memory check ----------------

from autodist_tpu_torch import observability as tobs  # noqa: E402
from autodist_tpu_torch.observability import memory as tmemory  # noqa: E402


@pytest.fixture
def port_telemetry(monkeypatch, tmp_path):
    from autodist_tpu_torch import const
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_SERVE_SLO_MS",
                 "AUTODIST_HBM_GB"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_WORKING_DIR", str(tmp_path))
    monkeypatch.setattr(const, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    tobs.refresh()
    tobs.reset()
    yield
    tobs.refresh()
    tobs.reset()


def test_decode_over_capacity_bucket_refused_like_jax(weights, monkeypatch,
                                                      port_telemetry):
    """``tests/test_decode.py:198``: a toy ~1 MiB card refuses the
    (4096, 64) lane's KV cache by name on both engines, before any
    placement, cache allocation or capture. A lane's predicted peak holds
    its cache as the ``kv_cache_bytes`` class."""
    from autodist_tpu.observability.memory import \
        InfeasibleMemoryError as JInfeasible
    jparams, params = weights
    monkeypatch.setenv("AUTODIST_HBM_GB", "0.001")
    jex = (np.zeros((8, 16), np.int32),)
    with pytest.raises(JInfeasible, match="decode bucket 4096x64"):
        jserve.DecodeEngine(_japply, jlm.make_decode_fn(JCFG),
                            lambda s, l: jlm.init_decode_cache(JCFG, s, l),
                            jparams, jex, buckets=((4096, 64),))
    allocated = []
    monkeypatch.setattr(serve.decode.DecodeReplica, "compile_decode",
                        lambda *a, **k: allocated.append(1))
    with pytest.raises(tmemory.InfeasibleMemoryError,
                       match="decode bucket 4096x64") as e:
        serve.DecodeEngine(_apply, lm.make_decode_fn(CFG),
                           functools.partial(lm.init_decode_cache, CFG),
                           params, EXAMPLE, buckets=((4096, 64),),
                           device="cpu")
    assert "AUTODIST_DECODE" in str(e.value) and "kv_cache" in str(e.value)
    assert allocated == []
    assert "serve-aot-compile" not in tobs.phase_timings()
    monkeypatch.undo()
    eng = serve.DecodeEngine(_apply, lm.make_decode_fn(CFG),
                             functools.partial(lm.init_decode_cache, CFG),
                             params, EXAMPLE, buckets=((8, 32),),
                             device="cpu")
    spec = serve.engine.serve_spec(None, torch.device("cpu"))
    mem = eng.bucket_memory(spec, (8, 32))
    assert mem["kv_cache_bytes"] == eng.cache_bytes(8, 32)
    eng.close()


def test_kv_cache_is_a_memory_ledger_class_like_jax(tmp_path):
    """``tests/test_decode.py:392``, and ``strategy_memory``'s
    ``batch_rows`` / ``kv_cache_bytes`` against the JAX package's on the
    tiny BERT and the same 8-GPU spec: every class at COST_RTOL but the
    activations (the port's own aten live set, at the same scaling)."""
    from autodist_tpu.observability import memory as jmemory
    from autodist_tpu.strategy import AllReduce as JAllReduce
    from autodist_tpu.tuner import cost_model as jcm
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    from autodist_tpu_torch.tuner import cost_model as cm
    from test_torch_attribution_goodput import (COST_RTOL, _bert_items,
                                                _close, _specs, _topologies)
    assert "kv_cache_bytes" in cm.MemoryBreakdown.CLASSES
    assert tmemory.CLASSES == cm.MemoryBreakdown.CLASSES == \
        jcm.MemoryBreakdown.CLASSES == jmemory.CLASSES
    assert "kv_cache_bytes" in tmemory.RESIDENT_CLASSES
    spec, jspec = _specs(tmp_path)
    jitem, item = _bert_items()
    topology, jtopology = _topologies(8, 1)
    for rows, kv in ((None, 0), (64, 3.5e6), (3, 1e9)):
        got = cm.CostModel(topology).strategy_memory(
            AllReduce().build(item, spec), item, batch_rows=rows,
            kv_cache_bytes=kv)
        want = jcm.CostModel(jtopology).strategy_memory(
            JAllReduce().build(jitem, jspec), jitem, batch_rows=rows,
            kv_cache_bytes=kv)
        _close(got, want, skip=("activations_bytes",))
        assert got["kv_cache_bytes"] == kv / 8
        scale = (rows or item.batch_size) / item.batch_size
        assert got["activations_bytes"] == pytest.approx(
            item.activation_live_bytes() * scale / 8, rel=COST_RTOL)


def test_decode_metrics(weights, port_telemetry, monkeypatch):
    monkeypatch.setenv("AUTODIST_SERVE_SLO_MS", "1000")
    _, params = weights
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, CFG.vocab, n) for n in (3, 5, 2, 7, 4, 6)]
    with _server(params) as srv:
        outs = [f.result(timeout=120) for f in
                [srv.submit(p, max_new_tokens=4 + i)
                 for i, p in enumerate(prompts)]]
    snap = tobs.registry().snapshot()
    tokens = sum(len(o) for o in outs)
    assert tokens == sum(4 + i for i in range(len(prompts)))
    assert snap["counters"]["decode.tokens"] == tokens
    assert snap["counters"]["decode.requests"] == len(prompts)
    assert snap["histograms"]["decode.latency_ms"]["count"] == len(prompts)
    assert snap["counters"]["decode.steps"] > 0
    p99 = snap["histograms"]["decode.latency_ms"]["p99"]
    assert snap["gauges"]["serve.slo_burn"] == round(p99 / 1000, 4)
    assert snap["gauges"]["decode.replicas"] == 1
    phases = tobs.phase_timings()
    assert phases["serve-aot-compile"]["count"] == 1
    assert phases["capture"]["count"] == 1
    kinds = [e["kind"] for e in tobs.recorder.events()]
    assert "serve-start" in kinds and "serve-stop" in kinds
