"""The port's serve.Server (device="cpu") against the JAX package's on the
same BERT / LM weights: answers, bucket selection, admission control,
shutdown, and (rows, seq) buckets. f32 answers agree at atol 2e-5 /
rtol 1e-4 (other summation orders)."""
import threading

import numpy as np
import jax
import pytest
import torch

from autodist_tpu import observability
from autodist_tpu import serve as jserve
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import layers as JL
from autodist_tpu.models import lm as jlm
from autodist_tpu.models import transformer as JT
from autodist_tpu_torch import convert, serve
from autodist_tpu_torch.models import bert, lm
from autodist_tpu_torch.models import transformer as T
from autodist_tpu_torch.utils.tree import leaves

ATOL, RTOL = 2e-5, 1e-4
ROWS = (1, 3, 7, 8, 2, 5, 4, 6, 8, 1)  # tests/test_serve.py's request sizes


@pytest.fixture(autouse=True)
def _fresh_metrics():
    observability.reset()
    yield
    observability.reset()


def _bert(seed=0):
    jcfg, cfg = jbert.bert_tiny(), bert.bert_tiny()
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(seed), jcfg))

    def japply(p, b):
        return JT.encode(p, jcfg, b[0], segment_ids=b[1])

    def apply(p, b):
        return T.encode(p, cfg, b[0], segment_ids=b[1])
    return cfg, japply, jparams, apply, convert.params_from_jax(jparams,
                                                                "cpu")


def _request(rng, cfg, rows, seq=16):
    return (rng.randint(0, cfg.vocab, (rows, seq)).astype(np.int32),
            rng.randint(0, 2, (rows, seq)).astype(np.int32))


@pytest.fixture(scope="module")
def servers():
    """The two servers on the same bert_tiny f32 weights, buckets (8, 32)."""
    cfg, japply, jparams, apply, params = _bert()
    example = _request(np.random.RandomState(0), cfg, 8)
    jsrv = jserve.Server(japply, jparams, example, buckets=(8, 32),
                         max_wait_ms=20)
    srv = serve.Server(apply, params, example, buckets=(8, 32),
                       max_wait_ms=20, device="cpu")
    yield cfg, jsrv, srv, params
    srv.close()
    jsrv.close()


def test_concurrent_requests_match_jax_server(servers):
    cfg, jsrv, srv, params = servers
    before = [t.clone() for t in leaves(params)]
    rng = np.random.RandomState(1)
    inputs = [_request(rng, cfg, r) for r in ROWS]
    futs = [None] * len(inputs)

    def client(i):
        futs[i] = srv.submit(inputs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for x, f in zip(inputs, futs):
        out = f.result(timeout=60)
        assert isinstance(out, torch.Tensor) and out.shape == (
            x[0].shape[0], 16, cfg.dim)
        want = np.asarray(jsrv.infer(x, timeout=60))
        np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    st = srv.stats()
    assert st["completed"] >= len(inputs)
    assert st["latency_ms"]["p99"] >= st["latency_ms"]["p50"] > 0
    # Params are read, never written.
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))


def test_repeated_request_is_bitwise_identical(servers):
    cfg, _, srv, _ = servers
    x = _request(np.random.RandomState(2), cfg, 5)
    first = srv.infer(x, timeout=60)
    for _ in range(2):
        assert torch.equal(srv.infer(x, timeout=60), first)
        st = srv.stats()  # an answered request is already counted
        assert st["completed"] == st["requests"]


@pytest.mark.parametrize("shape, buckets", [
    (8, [8, 32]), ((32,), [8, 32]), ((4, 128), [(4, 128), (16, 128)]),
    (3, [32, 8, 128]), (9, [32, 8, 128]), ((3, 100), [(8, 256), (4, 128)]),
    (129, [8, 32, 128]), ((4, 300), [(8, 256)]), (4, []), (4, [0, 8]),
    (4, [(8, 128), 32]), ((4, 128), [8, 32]),
], ids=lambda v: str(v).replace(" ", ""))
def test_pick_bucket_matches_jax(shape, buckets):
    def outcome(pick):
        try:
            return pick(shape, buckets)
        except ValueError as e:
            return f"ValueError: {e}"
    assert outcome(serve.pick_bucket) == outcome(jserve.pick_bucket)


@pytest.mark.parametrize("buckets", [[128, 8, 32, 8], [(8, 16), (2, 64)],
                                     None, []])
def test_normalize_buckets_matches_jax(buckets):
    def outcome(norm):
        try:
            return norm(buckets)
        except ValueError as e:
            return f"ValueError: {e}"
    assert outcome(serve.normalize_buckets) == \
        outcome(jserve.normalize_buckets)


@pytest.mark.parametrize("raw", [None, "8,32,128", "8x128,32x128",
                                 " 4 , 16X8 ", "0,8"])
def test_buckets_from_env_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("AUTODIST_SERVE_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("AUTODIST_SERVE_BUCKETS", raw)

    def outcome(fn):
        try:
            return fn(), fn((4,))
        except ValueError as e:
            return f"ValueError: {e}"
    assert outcome(serve.buckets_from_env) == outcome(jserve.buckets_from_env)


@pytest.mark.parametrize("bad", ["oversize", "trailing", "empty", "ragged",
                                 "structure"])
def test_malformed_requests_rejected_at_submit_like_jax(servers, bad):
    cfg, jsrv, srv, _ = servers
    rng = np.random.RandomState(3)
    ids, seg = _request(rng, cfg, 4)
    request = {"oversize": _request(rng, cfg, 33),
               "trailing": (ids[:, :8], seg[:, :8]),
               "empty": (ids[:0], seg[:0]),
               "ragged": (ids, seg[:3]),
               "structure": [ids, seg]}[bad]
    errors = []
    for server in (srv, jsrv):
        with pytest.raises(ValueError) as e:
            server.submit(request)
        errors.append(str(e.value))
    if bad == "structure":  # the tree printouts differ by framework
        assert all(msg.startswith("request structure") for msg in errors)
    else:
        assert errors[0] == errors[1]


def test_closed_server_rejects_and_drains():
    cfg, _, _, apply, params = _bert()
    rng = np.random.RandomState(4)
    srv = serve.Server(apply, params, _request(rng, cfg, 8), buckets=(8,),
                       max_wait_ms=1, device="cpu")
    futs = [srv.submit(_request(rng, cfg, 2)) for _ in range(6)]
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_request(rng, cfg, 2))
    srv.close()  # idempotent
    for f in futs:  # every queued request resolved: answered or failed fast
        assert f.exception(timeout=60) is None or \
            "closed" in str(f.exception())


def test_rows_seq_buckets_on_causal_lm_match_jax():
    """(rows, seq) buckets pad both dims of ragged token requests and
    de-pad each answer to (rows, seq): bitwise equal to the port's forward
    on the request's own padded grid, and equal to the JAX server's answer
    (tests/test_serve.py's ragged-prompt case)."""
    jcfg, cfg = jlm.lm_tiny(), lm.lm_tiny()
    jparams = jax.device_get(JT.init(jax.random.PRNGKey(0), jcfg))
    params = convert.params_from_jax(jparams, "cpu")

    def japply(p, tokens):
        return JT.logits(p, jcfg, JT.encode(p, jcfg, tokens,
                                            attn_fn=JL.dot_product_attention))

    def apply(p, tokens):
        return T.logits(p, cfg, T.encode(p, cfg, tokens))

    rng = np.random.RandomState(0)
    example = rng.randint(0, cfg.vocab, (8, 16)).astype(np.int32)
    buckets = ((8, 8), (8, 32))
    with jserve.Server(japply, jparams, example, buckets=buckets,
                       max_wait_ms=1) as jsrv, \
            serve.Server(apply, params, example, buckets=buckets,
                         max_wait_ms=1, device="cpu") as srv:
        for r, s in ((2, 5), (3, 8), (1, 20), (4, 3), (2, 17)):
            x = rng.randint(1, cfg.vocab, (r, s)).astype(np.int32)
            out = srv.infer(x, timeout=60)
            assert out.shape == (r, s, cfg.vocab)
            _, bseq = serve.pick_bucket((r, s), list(buckets))
            padded = np.zeros((r, bseq), np.int32)
            padded[:, :s] = x
            with torch.inference_mode():
                grid = apply(params, torch.from_numpy(padded))[:, :s]
            assert torch.equal(out, grid)
            np.testing.assert_allclose(out.numpy(),
                                       np.asarray(jsrv.infer(x, timeout=60)),
                                       atol=ATOL, rtol=RTOL)
        assert srv.last_dispatch["bucket"] in buckets
        with pytest.raises(ValueError, match="exceeds every bucket"):
            srv.submit(rng.randint(1, cfg.vocab, (2, 33)).astype(np.int32))


def _two_host_devices(tmp_path):
    path = tmp_path / "spec.yml"
    path.write_text("nodes:\n  - address: localhost\n    cpus: [0, 1]\n")
    return str(path)


def test_bucket_must_divide_data_axis_and_replicas_carve(tmp_path):
    cfg, _, _, apply, params = _bert()
    example = _request(np.random.RandomState(5), cfg, 8)
    spec = _two_host_devices(tmp_path)
    with pytest.raises(ValueError, match="do not split into 3"):
        serve.ServeEngine(apply, params, example, (8,), resource_spec=spec,
                          replicas=3, device="cpu")
    with pytest.raises(ValueError, match="bucket 3 not divisible"):
        serve.ServeEngine(apply, params, example, (3,), resource_spec=spec,
                          replicas=1, device="cpu")


def test_multi_replica_least_loaded_dispatch(tmp_path, servers):
    """Two replicas, one host device each: every answer matches the JAX
    server's and neither replica starves."""
    cfg, jsrv, _, params = servers
    _, _, _, apply, _ = _bert()
    rng = np.random.RandomState(7)
    with serve.Server(apply, params, _request(rng, cfg, 8), buckets=(4, 8),
                      max_wait_ms=1, replicas=2, device="cpu",
                      resource_spec=_two_host_devices(tmp_path)) as srv:
        assert len(srv.engine.replicas) == 2
        assert all(r.program.mesh.size == 1 for r in srv.engine.replicas)
        inputs = [_request(rng, cfg, 4) for _ in range(8)]
        futs = [srv.submit(x) for x in inputs]
        for x, f in zip(inputs, futs):
            np.testing.assert_allclose(f.result(timeout=60).numpy(),
                                       np.asarray(jsrv.infer(x, timeout=60)),
                                       atol=ATOL, rtol=RTOL)
        st = srv.stats()
        dispatches = [r["dispatches"] for r in st["replicas"]]
        assert sum(dispatches) == st["batches"]
        assert all(d > 0 for d in dispatches), dispatches


def test_strategy_env_other_than_allreduce_is_not_ported(monkeypatch):
    cfg, _, _, apply, params = _bert()
    monkeypatch.setenv("AUTODIST_STRATEGY", "auto")
    with pytest.raises(NotImplementedError, match="after slice 2"):
        serve.Server(apply, params, _request(np.random.RandomState(6), cfg,
                                             8), buckets=(8,), device="cpu")


class _RecordingRemapper:
    """Placement stand-in that records what the prefetcher issues."""

    device = torch.device("cpu")

    def __init__(self):
        self.issued = []

    def shard_batch(self, batch, non_blocking=False, poll=True):
        self.issued.append(batch)
        return batch


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_device_prefetcher_lazy_top_up_matches_jax(depth):
    """Over the serve work queue (which has ``next_nowait``) the window
    tops up lazily: the same batches come out, in order, after the same
    transfers were issued, as in the JAX package's DevicePrefetcher."""
    from autodist_tpu.data.loader import DevicePrefetcher as JPrefetcher
    from autodist_tpu.serve.engine import _WorkQueue as JWorkQueue
    from autodist_tpu_torch.data.loader import DevicePrefetcher
    from autodist_tpu_torch.serve.engine import _WorkQueue

    def trace(prefetcher_cls, queue_cls):
        source, remapper = queue_cls(), _RecordingRemapper()
        for i in range(3):
            source.put(i)
        pf = prefetcher_cls(source, remapper, depth=depth,
                            pull_in_background=False)
        steps = []
        for i in range(3):
            steps.append((next(pf), list(remapper.issued)))
        source.close()
        steps.append((list(pf), list(remapper.issued)))
        return steps
    assert trace(DevicePrefetcher, _WorkQueue) == \
        trace(JPrefetcher, JWorkQueue)


def test_device_prefetcher_fills_to_depth_from_a_plain_iterator():
    from autodist_tpu_torch.data.loader import DevicePrefetcher
    remapper = _RecordingRemapper()
    pf = DevicePrefetcher(iter(range(5)), remapper, depth=3,
                          pull_in_background=True)
    assert next(pf) == 0
    assert remapper.issued == [0, 1, 2]
    assert list(pf) == [1, 2, 3, 4]
