"""Capture and replay of a function over static buffers.

The port's counterpart of the JAX package's ``jit(...).lower(...).compile()``
ahead-of-time executables: :class:`Graph` captures ``fn()`` once as a CUDA
graph and replays it. ``fn`` reads its inputs from tensors the caller owns
and refills before each call (static buffers), and the graph hands back
the same output tensors on every replay, overwritten.

* **Capture.** The first call runs ``fn`` eagerly on a side stream (the
  warm-up: kernels are loaded, library handles, workspaces and lazily
  created state exist before capture) and hands back *that* run's outputs;
  then it captures ``fn`` on the same stream. Capture errors are
  thread-local: other threads (serving replicas, decode lanes) may run
  kernels while one captures. No automatic Python GC pass runs inside the
  capture (:func:`_no_collection`): one would run, on the capturing thread,
  the finalizers of whatever it frees, and a finalizer that calls CUDA
  there (an event query, a pinned free) invalidates the capture
  ("operation not permitted when stream is capturing"). A capture that
  fails raises; nothing falls back to the eager function.
* **Ownership.** A graph's memory pool lives as long as the graph. An
  object that owns a graph of its own method passes the method through
  :func:`weak_call`, so the two form no reference cycle and dropping the
  owner frees the pool at once, not at the cyclic collector's next run
  (a capture that runs out of memory cannot free cached blocks and
  fails).
* **Launch counts.** A kernel wrapper calls :func:`count_launch` where it
  launches its kernel. Outside a capture that adds one to the wrapper's
  ``launches``; during a capture it adds one to the capturing graph's
  count instead, keyed by the capture stream (the autograd engine launches
  the backward from its own thread, on the forward's stream), and each
  replay adds that count to the wrapper's ``launches``. Host bookkeeping
  kept in a dict of counts (the pipeline schedule's ticks and hops) counts
  the same way through :func:`count_item`, so it reads per replay too.
* **Plain version.** On any device but CUDA, every call runs ``fn``
  directly, on the same static buffers.
"""
import contextlib
import gc
import threading
import weakref

import torch

from autodist_tpu_torch.utils.tree import leaves

_lock = threading.Lock()
_capturing = {}  # capture stream handle -> {counter: launches recorded}


def _stream_capturing():
    """Whether the current CUDA stream is being captured (never on a build
    of PyTorch without CUDA, whose query raises)."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:
        return False


@contextlib.contextmanager
def _no_collection():
    """The cyclic collector off for the block (``torch.cuda.graph``
    collects once on entry; the allocations of a captured step then start
    dozens of automatic passes), and back as it was after."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def count_launch(counter, n=1):
    """``n`` launches of ``counter``'s kernel (``counter`` is the wrapper
    that carries ``launches``): counted now, or, while the current stream
    is being captured by a :class:`Graph`, counted at each of its replays.
    A capture that no :class:`Graph` owns counts nothing."""
    with _lock:
        if _stream_capturing():
            counts = _capturing.get(torch.cuda.current_stream().cuda_stream)
            if counts is not None:
                counts[counter] = counts.get(counter, 0) + n
            return
        counter.launches += n


class _Item:
    """Entry ``key`` of the dict ``counts`` as a counter: its ``launches``
    is the entry's value."""

    def __init__(self, counts, key):
        self.counts, self.key = counts, key

    def __hash__(self):
        return hash((id(self.counts), self.key))

    def __eq__(self, other):
        return isinstance(other, _Item) and other.counts is self.counts \
            and other.key == self.key

    @property
    def launches(self):
        return self.counts[self.key]

    @launches.setter
    def launches(self, n):
        self.counts[self.key] = n


def count_item(counts, key, n=1):
    """Add ``n`` to ``counts[key]`` now, or at each replay of the graph
    capturing the current stream (:func:`count_launch`)."""
    count_launch(_Item(counts, key), n)


@contextlib.contextmanager
def recording_launches(stream_handle):
    """The launch counts of the capture on ``stream_handle``, filled by
    :func:`count_launch` while the block runs."""
    counts = {}
    with _lock:
        _capturing[stream_handle] = counts
    try:
        yield counts
    finally:
        with _lock:
            del _capturing[stream_handle]


def add_launches(counts):
    """One replay's launches: ``counts`` ({counter: n}) added to each
    counter's ``launches``."""
    with _lock:
        for counter, n in counts.items():
            counter.launches += n


def weak_call(owner, fn):
    """``lambda: fn(owner)`` through a weak reference to ``owner``: the
    function of a graph that ``owner`` holds, without a reference cycle."""
    ref = weakref.ref(owner)
    return lambda: fn(ref())


class Graph:
    """``fn()`` over static buffers on ``device``: captured as a CUDA graph
    at the first call and replayed at every later one (on CUDA), or called
    directly (elsewhere). ``replays`` counts the replays; ``launches`` holds
    the kernel launches one replay makes ({counter: n})."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs = None
        self.launches = {}
        self.replays = 0

    @property
    def captured(self):
        return self.graph is not None

    def __call__(self):
        if self.device.type != "cuda":
            return self.fn()
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        self.replays += 1
        add_launches(self.launches)
        return self.outputs

    def _capture(self):
        """Warm ``fn`` up on a side stream, then capture it there; returns
        the warm-up's outputs."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                warm = self.fn()
            graph = torch.cuda.CUDAGraph()
            with recording_launches(side.cuda_stream) as counts, \
                    _no_collection():
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    outputs = self.fn()
            current = torch.cuda.current_stream()
            current.wait_stream(side)
            for t in leaves(warm):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    # Allocated on the side stream, read on the caller's.
                    t.record_stream(current)
            side.synchronize()
        self.graph, self.outputs, self.launches = graph, outputs, counts
        return warm

    def release(self):
        """Drop the graph (and its memory pool) and its outputs."""
        self.graph = None
        self.outputs = None
