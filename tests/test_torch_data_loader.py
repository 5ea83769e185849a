"""The port's input pipeline against the JAX package's, on the CPU.

``autodist_tpu_torch.data`` (the C++ loader built from the byte-identical
``data/native/prefetcher.cpp``, ``BufferPool``, ``BlockStacker``,
``DevicePrefetcher``) and the loader-fed ``Runner.run`` against
``autodist_tpu.data`` and the JAX Runner in one process:

* batch order: the same record file and seed give the JAX loader's batch
  sequence bitwise over 3 epochs (worker threads 0 and 2, the async ring
  on and off, ``block_shuffle``, two stripes with equal ``stats()``, the
  Python fallback through the same monkeypatch as
  ``tests/test_data_loader.py``); ``BlockStacker`` blocks bitwise;
* contracts: the ``BufferPool`` sequence, the ring degrading to the
  synchronous path, ``close()`` with assemblies in flight, the prefetcher
  at depths 0 / 1 / 3, a handed-out CPU batch that the loader never
  rewrites, ``device="cuda"`` raising without CUDA;
* ``Runner.run(loader)`` (the tiny MLP and a 2-layer BERT on packed
  records, ``unroll`` 1 and 2, SGD) held to the JAX ``Runner.run(loader)``
  at rtol 1e-5 / atol 1e-6 (losses and params: the same f32 arithmetic in
  another order over six steps), and under the step guard with ``nan_at``
  (the same rollback events, params at rtol 1e-4 / atol 1e-5, the
  tolerance of ``tests/test_torch_resilience.py``);
* per-host stripes on a 2-rank gloo world: each rank reads only its stripe
  and the run equals one rank fed the concatenated rows (rtol 1e-5 /
  atol 1e-6).
"""
import fcntl
import functools
import inspect
import os
import pickle
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu.data.loader as jloader_mod
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import autodist as jautodist_mod
from autodist_tpu import data as jdata
from autodist_tpu import resilience as jresilience
from autodist_tpu.models import bert as jbert
from autodist_tpu.models import mlp as jmlp
from autodist_tpu.resilience import StepGuard as JStepGuard
from autodist_tpu.resilience import chaos as jchaos
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import AutoDist, convert, data, resilience
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.data import loader as loader_mod
from autodist_tpu_torch.models import bert, mlp
from autodist_tpu_torch.ops.build import BUILD_DIR
from autodist_tpu_torch.resilience import StepGuard, chaos
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

RTOL, ATOL = 1e-5, 1e-6
GUARD_RTOL, GUARD_ATOL = 1e-4, 1e-5  # Adam under the guard
EPOCHS = 3
BATCH = 8


@pytest.fixture(autouse=True)
def _clean_state():
    autodist_mod._reset_default()
    for mod in (resilience, jresilience):
        mod.clear_events()
    for mod in (chaos, jchaos):
        mod.reset()
    yield
    autodist_mod._reset_default()
    for mod in (resilience, jresilience):
        mod.clear_events()
    for mod in (chaos, jchaos):
        mod.reset()


@pytest.fixture
def record_file(tmp_path):
    data_ = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    path = tmp_path / "records.bin"
    data.write_record_file(path, data_)
    return path, data_


def _python_backend(monkeypatch):
    """Both packages' loaders on their Python fallback, as
    ``tests/test_data_loader.py`` forces it."""
    for mod in (loader_mod, jloader_mod):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_lib_err", RuntimeError("forced"))


def _named(tree):
    return {path_to_name(p): np.asarray(
        l.detach().cpu().numpy() if isinstance(l, torch.Tensor) else l)
        for p, l in flatten_with_path(tree)[0]}


# -- the native source and its build ----------------------------------------


def test_prefetcher_cpp_is_the_jax_packages_byte_for_byte():
    with open(loader_mod._SRC, "rb") as f:
        ours = f.read()
    with open(jloader_mod._SRC, "rb") as f:
        theirs = f.read()
    assert ours == theirs
    assert loader_mod.GXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC",
                                    "-pthread")


def test_native_loader_builds_into_the_build_dir(record_file):
    path, _ = record_file
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH,
                                   device="cpu")
    assert loader.backend == "native", loader_mod._lib_err
    so = loader_mod.library_path()
    assert os.path.dirname(so) == BUILD_DIR and os.path.exists(so)
    assert os.path.basename(so).startswith("prefetcher-")
    loader.close()


# -- batch order, bitwise the JAX loader's -----------------------------------

ORDER_CASES = {
    "threads0_sync": dict(num_threads=0, pipeline=False),
    "threads0_ring": dict(num_threads=0, pipeline=True, ring_depth=3),
    "threads2": dict(num_threads=2, capacity=3),
    "block_shuffle": dict(block_shuffle=True),
    "stripe0": dict(num_threads=0, pipeline=False, shard_index=0,
                    shard_count=2),
    "stripe1": dict(num_threads=0, pipeline=False, shard_index=1,
                    shard_count=2),
    "python": dict(python=True),
    "python_block_shuffle": dict(python=True, block_shuffle=True),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_batch_order_matches_jax_bitwise(record_file, monkeypatch, case):
    path, _ = record_file
    kw = dict(ORDER_CASES[case])
    if kw.pop("python", False):
        _python_backend(monkeypatch)
    ours = data.NativeDataLoader(path, (16,), np.float32, BATCH, seed=7,
                                 device="cpu", **kw)
    theirs = jdata.NativeDataLoader(path, (16,), np.float32, BATCH, seed=7,
                                    **kw)
    assert ours.backend == theirs.backend == (
        "python" if case.startswith("python") else "native")
    assert ours.num_samples == theirs.num_samples
    n = EPOCHS * ours.num_samples // BATCH
    got, want = [], []
    for _ in range(n):
        a, b = next(ours), next(theirs)
        got.append(np.array(a))
        want.append(np.array(b))
        ours.recycle(a)
        theirs.recycle(b)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")
    if kw.get("pipeline"):
        # Settle both rings' read-ahead: until then, how many of the
        # queued assemblies have run (and counted their reads) is a race.
        ours._drain_ring()
        theirs._drain_ring()
    if case.startswith(("stripe", "threads0", "block")):
        assert ours.stats() == theirs.stats()
    lo = kw.get("shard_index", 0) * ours.num_samples
    stats = ours.stats()
    assert lo <= stats["min_index"] <= stats["max_index"] < \
        lo + ours.num_samples
    ours.close()
    theirs.close()


def test_epochs_reshuffle_and_seeds_differ(record_file):
    path, data_ = record_file

    def epoch(seed):
        loader = data.NativeDataLoader(path, (16,), np.float32, 64, seed=seed,
                                       device="cpu", pipeline=False)
        out = [next(loader).copy() for _ in range(2)]
        loader.close()
        return out
    e0, e1 = epoch(5)
    assert not np.array_equal(e0, e1)
    np.testing.assert_array_equal(np.sort(e0, 0), np.sort(data_, 0))
    assert not np.array_equal(e0, epoch(6)[0])


def test_block_stacker_matches_jax_bitwise(record_file):
    path, _ = record_file
    loaders = [data.NativeDataLoader(path, (16,), np.float32, BATCH, seed=2,
                                     device="cpu", num_threads=0,
                                     pipeline=True),
               jdata.NativeDataLoader(path, (16,), np.float32, BATCH, seed=2,
                                      num_threads=0, pipeline=True)]
    ours = data.BlockStacker(loaders[0], 3, recycle_to=loaders[0],
                             device="cpu")
    theirs = jdata.BlockStacker(loaders[1], 3, recycle_to=loaders[1])
    for _ in range(2 * 8 // 3):  # two epochs
        a, b = next(ours), next(theirs)
        assert a.shape == (3, BATCH, 16)
        np.testing.assert_array_equal(a, b)
        ours.recycle(a)
        theirs.recycle(b)
    (pool,) = ours._pools.values()
    assert pool.fallback_allocs == 0 and pool.outstanding == 0
    assert loaders[0].stats()["pool_fallback_allocs"] == 0
    for ld in loaders:
        ld.close()


def test_block_stacker_stacks_recycles_and_stops():
    """The port of ``tests/test_unroll.py``'s BlockStacker contract."""

    class _Loader:
        def __init__(self, n):
            self.pool = data.BufferPool((4, 3), np.float32, size=4)
            self._n, self._i = n, 0

        def recycle(self, buf):
            self.pool.release(buf)

        def __iter__(self):
            return self

        def __next__(self):
            if self._i >= self._n:
                raise StopIteration
            out = self.pool.acquire()
            out[:] = self._i
            self._i += 1
            return out

    src = _Loader(5)
    stacker = data.BlockStacker(src, 2, recycle_to=src, device="cpu")
    b0 = next(stacker)
    assert b0.shape == (2, 4, 3)
    np.testing.assert_array_equal(b0[1], 1.0)
    assert src.pool.outstanding == 0  # source batches went straight back
    next(stacker)
    stacker.recycle(b0)
    with pytest.raises(StopIteration):  # 5th batch: a partial block
        next(stacker)
    assert src.pool.outstanding == 0
    with pytest.raises(ValueError, match="unroll must be >= 1"):
        data.BlockStacker(iter([]), 0, device="cpu")


# -- contracts ----------------------------------------------------------------


def test_buffer_pool_contract_matches_jax():
    trace = {}
    for name, cls in (("port", data.BufferPool), ("jax", jdata.BufferPool)):
        pool = cls((4, 8), np.float32, size=2)
        a, b = pool.acquire(), pool.acquire()
        out = [pool.fallback_allocs]
        c = pool.acquire()  # beyond size: a counted fresh allocation
        out += [pool.fallback_allocs, pool.outstanding]
        out += [pool.release(a), pool.release(b), pool.outstanding]
        out += [pool.acquire() is b, pool.acquire() is a]  # LIFO reuse
        out += [pool.release(np.zeros((3, 3))), pool.release(c[:2]),
                pool.release("not an array"), pool.release(c),
                pool.fallback_allocs]
        trace[name] = out
    assert trace["port"] == trace["jax"]


def test_ring_degrades_to_sync_when_async_refused(record_file):
    path, _ = record_file

    class _NoAsync:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return getattr(self._lib, name)

        def loader_next_async(self, h, buf):
            return -2

    ref = jdata.NativeDataLoader(path, (16,), np.float32, BATCH, seed=4,
                                 num_threads=0, pipeline=False)
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH, seed=4,
                                   device="cpu", num_threads=0,
                                   pipeline=True)
    assert loader._ring_depth > 0
    kind, lib, h = loader._impl
    loader._impl = (kind, _NoAsync(lib), h)
    for _ in range(12):
        np.testing.assert_array_equal(next(ref), next(loader))
    assert not loader._ring, "refused jobs must not enter the ring"
    loader._impl = (kind, lib, h)
    loader.close()
    ref.close()


def test_close_with_inflight_ring_assemblies(record_file):
    path, _ = record_file
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH, seed=2,
                                   device="cpu", num_threads=0,
                                   pipeline=True, ring_depth=3)
    next(loader)  # tops the ring up to 3, then collects the oldest
    assert len(loader._ring) == 2
    loader.close()  # drains both, then destroys the native loader
    assert not loader._ring and loader.pool.outstanding == 1
    with pytest.raises(StopIteration):
        next(loader)


def test_py_loader_close_does_not_hang_consumer(record_file):
    path, _ = record_file
    impl = loader_mod._PyLoaderImpl(path, 64, BATCH, seed=0, capacity=4)
    impl.close()
    done = []

    def drain():
        out = np.empty((BATCH, 64), np.uint8)
        try:
            while True:
                impl.next_into(out)
        except StopIteration:
            done.append(True)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and done == [True]


def test_cuda_device_raises_without_cuda(record_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    path, _ = record_file
    with pytest.raises(RuntimeError, match="CUDA"):
        data.NativeDataLoader(path, (16,), np.float32, BATCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        data.BlockStacker(iter([]), 2)


def test_public_signatures_are_the_jax_packages():
    """Every JAX parameter, in order; the port adds ``device`` (and the
    pool its pinned staging) at the end."""
    for name, extra in (("NativeDataLoader", ["device"]),
                        ("BlockStacker", ["device"]),
                        ("BufferPool", ["pin_memory"]),
                        ("DevicePrefetcher", []),
                        ("write_record_file", [])):
        ours = list(inspect.signature(getattr(data, name)).parameters)
        theirs = list(inspect.signature(getattr(jdata, name)).parameters)
        assert ours == theirs + extra, name


def test_per_host_resolves_from_the_world(record_file, monkeypatch):
    path, _ = record_file
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH,
                                   per_host=True, device="cpu")
    assert (loader.shard_index, loader.shard_count) == (0, 1)
    assert loader.num_samples == 64
    loader.close()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's, before the world
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH,
                                   per_host=True, device="cpu")
    assert (loader.shard_index, loader.shard_count) == (1, 2)
    assert loader.num_samples == 32
    loader.close()
    with pytest.raises(ValueError, match="outside"):
        loader_mod._resolve_shard(2, 2, False)


# -- the prefetcher -----------------------------------------------------------


def _mlp_runner():
    params, loss_fn, batch = mlp.tiny_fixture(device="cpu")
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=batch)
    return ad.create_distributed_session(item)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_prefetcher_depths_deliver_all_batches(record_file, depth):
    path, data_ = record_file
    runner = _mlp_runner()
    labels = np.arange(BATCH, dtype=np.int32) % 4
    xs = [data_[i * BATCH:(i + 1) * BATCH] for i in range(4)]
    feed = data.DevicePrefetcher(((x, labels) for x in xs), runner.remapper,
                                 depth=depth, pull_in_background=False)
    got = list(feed)
    assert len(got) == 4
    for x, b in zip(xs, got):
        np.testing.assert_array_equal(b[0].numpy(), x)
    with pytest.raises(StopIteration):
        next(feed)
    stats = feed.stats()
    assert stats["batches"] == 4 and stats["data_wait_ms_total"] >= 0
    assert set(stats) == {"batches", "data_wait_ms_total",
                          "data_wait_ms_mean", "inflight"}
    assert feed.last_wait_ms >= 0


def test_device_prefetcher_surfaces_iterator_errors(record_file):
    path, data_ = record_file
    runner = _mlp_runner()

    def bad():
        yield data_[:BATCH]
        raise RuntimeError("boom")

    feed = data.DevicePrefetcher(bad(), runner.remapper, depth=1,
                                 shard_in_background=True)
    next(feed)
    with pytest.raises(RuntimeError, match="boom"):
        next(feed)


@pytest.mark.parametrize("mode", ["ring", "threads", "sync"])
def test_cpu_batches_keep_their_bytes_while_the_loader_runs(record_file,
                                                            mode):
    """On the CPU a placed batch would alias the loader's pooled buffer:
    the prefetcher copies it, so a handed-out batch keeps its bytes across
    the next two ``next()`` calls (and every later one), while the pool
    still recycles (no fresh allocation after warm-up)."""
    path, _ = record_file
    kw = {"ring": dict(num_threads=0, pipeline=True),
          "threads": dict(num_threads=2),
          "sync": dict(num_threads=0, pipeline=False)}[mode]
    runner = _mlp_runner()
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH, seed=1,
                                   device="cpu", **kw)
    ref = jdata.NativeDataLoader(path, (16,), np.float32, BATCH, seed=1,
                                 num_threads=0, pipeline=False)
    feed = data.DevicePrefetcher(loader, runner.remapper, depth=2,
                                 loader=loader)
    handed, kept = [], []
    for _ in range(20):
        b = next(feed)
        handed.append(b)
        kept.append(b.clone())
        if len(handed) >= 3:
            assert torch.equal(handed[-3], kept[-3])
    for b, k in zip(handed, kept):
        assert torch.equal(b, k)
    for b in handed:
        np.testing.assert_array_equal(b.numpy(), next(ref))
    assert loader.stats()["pool_fallback_allocs"] == 0
    loader.close()
    ref.close()


def test_block_shuffle_views_place_once_without_a_warning(record_file):
    path, data_ = record_file
    runner = _mlp_runner()
    loader = data.NativeDataLoader(path, (16,), np.float32, BATCH, seed=5,
                                   device="cpu", block_shuffle=True)
    feed = data.DevicePrefetcher(loader, runner.remapper, depth=2,
                                 loader=loader)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = [next(feed) for _ in range(8)]
    rows = np.concatenate([b.numpy() for b in got])
    np.testing.assert_array_equal(np.sort(rows, 0), np.sort(data_, 0))
    loader.close()  # unmaps the file: the placed batches own their bytes
    assert all(b.numpy().flags.writeable for b in got)
    np.testing.assert_array_equal(np.sort(np.concatenate(
        [b.numpy() for b in got]), 0), np.sort(data_, 0))


def test_shard_local_batch_matches_shard_batch():
    runner = _mlp_runner()
    _, _, batch = mlp.tiny_fixture(device="cpu")
    ref = runner.remapper.shard_batch(batch)
    local = runner.remapper.shard_local_batch(batch)
    for a, b in zip(ref, local):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    state, metrics = runner.step(runner.create_state(), local,
                                 shard_inputs=False)
    assert np.isfinite(float(metrics["loss"]))


# -- Runner.run(loader) against the JAX Runner --------------------------------

SEQ, MASKED = 16, 4


def _mlp_packed(torch_side):
    """The tiny MLP over float32 records of 16 features; the label is the
    argmax of the first four (a NaN-poisoned batch keeps valid labels)."""
    if torch_side:
        base = mlp.make_loss_fn(mlp.MLPConfig(in_dim=16, hidden=(32,),
                                              num_classes=4))
        return lambda p, b: base(p, (b, b[:, :4].argmax(1)))
    _, base, _ = jmlp.tiny_fixture()
    return lambda p, b: base(p, (b, jnp.argmax(b[:, :4], 1)))


def _bert_packed(torch_side):
    """A 2-layer BERT over int32 records of 2 * SEQ + 2 * MASKED values:
    ids, segment ids, masked positions, their labels."""
    def split(b):
        return (b[:, :SEQ], b[:, SEQ:2 * SEQ], b[:, 2 * SEQ:2 * SEQ + MASKED],
                b[:, 2 * SEQ + MASKED:])
    if torch_side:
        base = bert.make_loss_fn(bert.bert_tiny())
    else:
        base = jbert.make_loss_fn(jbert.bert_tiny())
    return lambda p, b: base(p, split(b))


def _records(model, tmp_path):
    """(path, record shape, dtype, JAX params) for ``model``."""
    if model == "mlp":
        params, _, _ = jmlp.tiny_fixture(seed=0)
        recs = np.random.RandomState(3).randn(40, 16).astype(np.float32)
    else:
        params, _, _ = jbert.tiny_fixture(seed=0)
        cfg = jbert.bert_tiny()
        recs = np.concatenate(jbert.synthetic_batch(
            cfg, batch_size=40, seq_len=SEQ, num_masked=MASKED, seed=3), 1)
    path = str(tmp_path / f"{model}.rec")
    data.write_record_file(path, recs)
    return path, recs.shape[1:], recs.dtype, jax.device_get(params)


def _jax_run(model, path, shape, dtype, jparams, steps, unroll, opt,
             guard=None):
    jautodist_mod._reset_default()
    ad = JAutoDist(strategy_builder=JAllReduce())
    loss = _mlp_packed(False) if model == "mlp" else _bert_packed(False)
    example = np.zeros((BATCH,) + shape, dtype)
    runner = ad.create_distributed_session(
        ad.capture(loss, jparams, opt, example_batch=example))
    loader = jdata.NativeDataLoader(path, shape, dtype, BATCH, seed=9)
    state, m = runner.run(runner.create_state(), loader, steps,
                          unroll=unroll, step_guard=guard)
    loader.close()
    out = (np.atleast_1d(np.asarray(jax.device_get(m["loss"]))),
           _named(jax.device_get(runner.logical_params(state))),
           int(jax.device_get(state.step)))
    jautodist_mod._reset_default()
    return out


def _port_run(model, path, shape, dtype, jparams, steps, unroll, opt,
              guard=None, feed="loader"):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    loss = _mlp_packed(True) if model == "mlp" else _bert_packed(True)
    example = np.zeros((BATCH,) + shape, dtype)
    runner = ad.create_distributed_session(ad.capture(
        loss, convert.params_from_jax(jparams, "cpu"), opt,
        example_batch=example))
    loader = data.NativeDataLoader(path, shape, dtype, BATCH, seed=9,
                                   device="cpu")
    source = loader if feed == "loader" else (
        np.array(next(loader)) for _ in range(steps))
    state, m = runner.run(runner.create_state(), source, steps,
                          unroll=unroll, step_guard=guard)
    stats = loader.stats()
    loader.close()
    return (np.atleast_1d(m["loss"].detach().numpy()),
            _named(runner.logical_params(state)), int(state.step), stats)


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_run_loader_matches_jax_runner(tmp_path, model, unroll):
    """Six steps (1.2 epochs of a 40-record file) of ``Runner.run`` over a
    ``NativeDataLoader``: the port's wired feed (prefetcher; stacker and
    megastep under ``unroll=2``) against the JAX Runner's."""
    path, shape, dtype, jparams = _records(model, tmp_path)
    steps = 6
    want_loss, want, want_step = _jax_run(model, path, shape, dtype, jparams,
                                          steps, unroll, optax.sgd(0.1))
    loss, got, step, stats = _port_run(
        model, path, shape, dtype, jparams, steps, unroll,
        functools.partial(torch.optim.SGD, lr=0.1))
    assert step == want_step == steps
    assert loss.shape == want_loss.shape == (unroll,)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    _assert_close(got, want)
    assert stats["pool_fallback_allocs"] == 0
    # The host-stacked feed of the same batches: the same run.
    loss2, got2, _, _ = _port_run(
        model, path, shape, dtype, jparams, steps, unroll,
        functools.partial(torch.optim.SGD, lr=0.1), feed="iterator")
    np.testing.assert_array_equal(loss2, loss)
    for name in got:
        np.testing.assert_array_equal(got2[name], got[name])


@pytest.mark.parametrize("unroll,nan_at", [(1, 2), (2, 3)])
def test_run_loader_guard_rolls_back_like_jax(tmp_path, monkeypatch, unroll,
                                              nan_at):
    """The step guard and ``nan_at`` on the loader-fed loop: one rollback,
    the JAX Runner's events, its final params (Adam, eps 1e-6)."""
    monkeypatch.setenv("AUTODIST_CHAOS", f"nan_at={nan_at}")
    path, shape, dtype, jparams = _records("mlp", tmp_path)
    jguard = JStepGuard(check_every=1, max_strikes=2)
    want_loss, want, want_step = _jax_run(
        "mlp", path, shape, dtype, jparams, 4, unroll,
        optax.adam(1e-3, eps=1e-6), guard=jguard)
    guard = StepGuard(check_every=1, max_strikes=2)
    loss, got, step, _ = _port_run(
        "mlp", path, shape, dtype, jparams, 4, unroll,
        functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6), guard=guard)
    assert guard.rollbacks == jguard.rollbacks == 1
    kinds = ("chaos:nan", "rollback")
    assert [(k, d) for _, k, d in resilience.events() if k in kinds] == \
        [(k, d) for _, k, d in jresilience.events() if k in kinds]
    assert step == want_step and np.isfinite(loss).all()
    _assert_close(got, want, GUARD_RTOL, GUARD_ATOL)


# -- per-host stripes on a 2-rank gloo world -----------------------------------

WORLD = 2
STRIPE_STEPS = 6

_RANK = r'''
import datetime, functools, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch.data import NativeDataLoader
from autodist_tpu_torch.models import mlp
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inputs = pickle.load(f)
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
base = mlp.make_loss_fn(mlp.MLPConfig(in_dim=16, hidden=(32,),
                                      num_classes=4))


def loss(p, b):
    return base(p, (b, b[:, :4].argmax(1)))


res = {}
for unroll in (1, 2):
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        loss, inputs["params"], functools.partial(torch.optim.SGD, lr=0.1),
        example_batch=np.zeros((4, 16), np.float32)))
    loader = NativeDataLoader(inputs["path"], (16,), np.float32, 4, seed=1,
                              per_host=True, device="cpu")
    state, m = runner.run(runner.create_state(), loader, inputs["steps"],
                          unroll=unroll)
    res[unroll] = {
        "loss": np.atleast_1d(m["loss"].detach().numpy()),
        "params": {path_to_name(p): t.detach().numpy().copy() for p, t in
                   flatten_with_path(runner.logical_params(state))[0]},
        "stats": loader.stats(), "num_samples": loader.num_samples,
        "shard": (loader.shard_index, loader.shard_count)}
    loader.close()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def stripe_world(tmp_path_factory):
    """Both ``unroll`` runs on one 2-rank world, once per session:
    ([rank 0's results, rank 1's], the inputs)."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "loader_world"
    with open(shared / "loader_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            recs = np.random.RandomState(4).randn(48, 16).astype(np.float32)
            data.write_record_file(out / "stripes.rec", recs)
            params = mlp.init(mlp.MLPConfig(in_dim=16, hidden=(32,),
                                            num_classes=4),
                              torch.Generator().manual_seed(0), device="cpu")
            with open(out / "inputs.pkl", "wb") as f:
                pickle.dump({"path": str(out / "stripes.rec"),
                             "params": params, "steps": STRIPE_STEPS}, f)
            outs, err = _run_world(_RANK, WORLD, [str(out)], str(out))
            (out / "error").write_text(err if outs is None else "")
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    with open(out / "inputs.pkl", "rb") as f:
        return ranks, pickle.load(f)


@pytest.mark.parametrize("unroll", [1, 2])
def test_per_host_stripes_match_one_rank_on_the_concatenated_rows(
        stripe_world, unroll):
    ranks, inputs = stripe_world
    per = 48 // WORLD
    for r, res in enumerate(ranks):
        got = res[unroll]
        assert got["shard"] == (r, WORLD) and got["num_samples"] == per
        st = got["stats"]
        assert r * per <= st["min_index"] <= st["max_index"] < (r + 1) * per
        assert st["records_read"] >= 4 * STRIPE_STEPS
    # One rank fed each step's two stripes' batches, concatenated.
    stripes = [data.NativeDataLoader(inputs["path"], (16,), np.float32, 4,
                                     seed=1, shard_index=r, shard_count=WORLD,
                                     device="cpu") for r in range(WORLD)]
    rows = [np.concatenate([np.array(next(ld)) for ld in stripes])
            for _ in range(STRIPE_STEPS)]
    for ld in stripes:
        ld.close()
    base = mlp.make_loss_fn(mlp.MLPConfig(in_dim=16, hidden=(32,),
                                          num_classes=4))
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    runner = ad.create_distributed_session(ad.capture(
        lambda p, b: base(p, (b, b[:, :4].argmax(1))), inputs["params"],
        functools.partial(torch.optim.SGD, lr=0.1), example_batch=rows[0]))
    state, m = runner.run(runner.create_state(), iter(rows), STRIPE_STEPS,
                          unroll=unroll)
    want = _named(runner.logical_params(state))
    for res in ranks:
        np.testing.assert_allclose(res[unroll]["loss"],
                                   np.atleast_1d(m["loss"].numpy()),
                                   rtol=RTOL, atol=ATOL)
        _assert_close(res[unroll]["params"], want)
