"""A CUDA-graph capture runs no automatic Python GC pass.

A GC pass that starts on the capturing thread runs the finalizers of what
it frees there, inside the capture; one that calls CUDA (an event query, a
pinned free) invalidates the capture ("operation not permitted when stream
is capturing"). ``utils/cuda_graph.Graph._capture`` keeps the collector
off for the captured call and restores it after. On the CPU the capture
machinery is faked (``torch.cuda``'s device, stream, graph and
``CUDAGraph``), so ``Graph._capture`` runs its real code around them: a
cyclic object with a finalizer, made garbage inside the captured call,
must not be finalized there even with the collector's threshold at 1
(without the fix it is), and is finalized after.
"""
import contextlib
import gc

import pytest
import torch

from autodist_tpu_torch.utils import cuda_graph


class _Stream:
    cuda_stream = 12345

    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class _Cycle:
    finalized = []  # (made in, finalized inside a capture)
    state = {"capturing": False}

    def __init__(self, where):
        self.where = where
        self.me = self

    def __del__(self):
        _Cycle.finalized.append((self.where, _Cycle.state["capturing"]))


@pytest.fixture
def fake_capture(monkeypatch):
    state = _Cycle.state

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode=None):
        gc.collect()  # as torch.cuda.graph does on entry
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    yield state
    gc.set_threshold(*threshold)
    _Cycle.finalized.clear()


def test_no_gc_pass_inside_a_capture(fake_capture):
    seen = []

    def fn():
        where = "capture" if fake_capture["capturing"] else "warm-up"
        seen.append((where, gc.isenabled()))
        _Cycle(where)  # cyclic garbage at once
        for _ in range(2000):  # allocations past the threshold
            [object()]
        return torch.zeros(1)

    was = gc.isenabled()
    cuda_graph.Graph(fn, "cpu")._capture()
    assert seen == [("warm-up", was), ("capture", False)]
    assert gc.isenabled() == was
    gc.collect()
    assert ("capture", False) in _Cycle.finalized
    assert not [f for f in _Cycle.finalized if f[1]], \
        "a finalizer ran inside the capture"


def test_a_disabled_collector_stays_disabled(fake_capture):
    gc.disable()
    try:
        cuda_graph.Graph(lambda: torch.zeros(1), "cpu")._capture()
        assert not gc.isenabled()
    finally:
        gc.enable()
