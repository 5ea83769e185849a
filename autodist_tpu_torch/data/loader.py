"""Input pipeline: the native shuffling loader and the depth-N prefetcher.

Counterpart of ``autodist_tpu/data/loader.py``:

* :class:`NativeDataLoader` — ctypes binding to ``native/prefetcher.cpp``
  (a byte-identical copy of the JAX package's): C++ threads assemble
  shuffled batches from a memory-mapped record file, GIL-free, into a small
  pool of reusable staging buffers (:class:`BufferPool`), with an async
  assembly ring (``loader_next_async``), per-host stripes
  (``per_host=True`` / ``shard_index`` + ``shard_count``) and
  ``block_shuffle=True`` zero-copy views into the mmap. The same source
  and seed give the JAX package's batch sequence, bitwise. Built with
  ``g++`` at first use into the checkout's git-ignored ``build/``;
  :class:`_PyLoaderImpl` is the pure-Python fallback with the same
  semantics, and ``backend`` says which one runs.
* :class:`BlockStacker` — K consecutive batches stacked into one
  ``(K,) + batch`` block for the Runner's K-step graph (``megastep``).
* :class:`DevicePrefetcher` — a deque of up to ``depth`` in-flight
  host->device copies over any batch iterator.

On CUDA (``device="cuda"``, the default) the staging buffers are numpy
views of pinned host tensors: the C++ threads assemble straight into
pinned memory, and the prefetcher's copy of a batch is one asynchronous
H2D copy on a side stream with no second host copy. A buffer goes back to
the pool only once that copy's CUDA event reports complete (the consumer
orders itself after the copy on the device, so the host never blocks on
it). On the CPU the placed batch would alias the buffer, so the
prefetcher copies it first.

Env knobs: ``AUTODIST_PREFETCH_DEPTH``, ``AUTODIST_LOADER_RING``,
``AUTODIST_LOADER_POOL``.
"""
import ctypes
import hashlib
import os
import queue
import subprocess
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.ops.build import BUILD_DIR
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.tree import flatten, leaves as tree_leaves
from autodist_tpu_torch.utils.tree import tree_map, unflatten

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "prefetcher.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lib = None
_lib_err = None
_build_lock = threading.Lock()


def library_path():
    """``build/prefetcher-<hash>.so``: the hash covers the source and the
    flags, so an edited source or flag rebuilds."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"prefetcher-{digest.hexdigest()[:16]}.so")


def _build_native():
    """Compile (once per source and flags) and load the native loader; None
    when ``g++`` or the build fails (logged with the compiler's output)."""
    global _lib, _lib_err
    with _build_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        so_path = library_path()
        try:
            if not os.path.exists(so_path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # Concurrent builders (test workers) each write their own
                # file and move it into place whole.
                tmp = f"{so_path}.{os.getpid()}.tmp"
                proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {_SRC}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so_path)
                logging.info("built native data loader: %s", so_path)
            lib = ctypes.CDLL(so_path)
        except (OSError, RuntimeError) as e:  # no toolchain, failed build
            _lib_err = e
            logging.warning("native loader unavailable (%s); using the "
                            "Python fallback", e)
            return None
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.loader_create_ex.restype = ctypes.c_void_p
        lib.loader_create_ex.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_uint64, ctypes.c_int,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.loader_next_view.restype = ctypes.c_int
        lib.loader_next_view.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_void_p)]
        lib.loader_next_async.restype = ctypes.c_int
        lib.loader_next_async.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.loader_next_wait.restype = ctypes.c_int
        lib.loader_next_wait.argtypes = [ctypes.c_void_p]
        lib.loader_async_pending.restype = ctypes.c_int64
        lib.loader_async_pending.argtypes = [ctypes.c_void_p]
        lib.loader_num_samples.restype = ctypes.c_int64
        lib.loader_num_samples.argtypes = [ctypes.c_void_p]
        lib.loader_stats.restype = None
        lib.loader_stats.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64)]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def write_record_file(path, array):
    """Write an (N, ...) array as a flat file of fixed-size records,
    streamed with ``ndarray.tofile`` (no second copy of the dataset);
    returns (record bytes, record shape, dtype)."""
    arr = np.ascontiguousarray(array)
    with open(path, "wb") as f:
        arr.tofile(f)
    return arr[0].nbytes, arr.shape[1:], arr.dtype


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, dtype)).dtype


class BufferPool:
    """Small pool of reusable staging buffers (one batch each).

    ``acquire`` hands out a free buffer, allocating only while the pool is
    below ``size``; beyond it a fresh buffer is allocated and counted in
    ``fallback_allocs`` (a consumer that holds on to buffers degrades, it
    never blocks or fails). ``release`` returns a buffer and ignores what
    the pool cannot reuse (wrong shape or dtype, views, not an array), so
    a caller can release every leaf of a batch.

    ``pin_memory=True`` (the CUDA loaders') allocates each buffer as a
    pinned host tensor and hands out its numpy view; such a view does not
    own its data, so the pool takes back only the views it allocated."""

    def __init__(self, shape, dtype, size, pin_memory=False):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.size = max(1, int(size))
        self.pin_memory = bool(pin_memory)
        self.fallback_allocs = 0
        self._allocated = 0
        self._free = []
        self._owned = weakref.WeakValueDictionary()  # id -> pinned view
        self._lock = threading.Lock()

    def acquire(self):
        with self._lock:
            if self._free:
                return self._free.pop()
            if self._allocated >= self.size:
                self.fallback_allocs += 1
            self._allocated += 1
        if not self.pin_memory:
            return np.empty(self.shape, self.dtype)
        buf = torch.empty(self.shape, dtype=_torch_dtype(self.dtype),
                          pin_memory=True).numpy()
        with self._lock:
            self._owned[id(buf)] = buf
        return buf

    def release(self, buf):
        """Return a buffer to the pool; False for arrays it cannot reuse."""
        if (not isinstance(buf, np.ndarray) or buf.shape != self.shape
                or buf.dtype != self.dtype):
            return False
        with self._lock:
            if self.pin_memory:
                if self._owned.get(id(buf)) is not buf:
                    return False
            elif not buf.flags.owndata:
                return False
            if len(self._free) < self.size and \
                    not any(b is buf for b in self._free):
                self._free.append(buf)
                return True
        return False

    @property
    def outstanding(self):
        with self._lock:
            return self._allocated - len(self._free)


def _resolve_shard(shard_index, shard_count, per_host):
    """(index, count) of this process's stripe; (0, 1) when unsharded.
    ``per_host`` takes them from the initialized ``torch.distributed``
    world, else from the torchrun variables the port's ``Cluster.start``
    joins with, else a lone process."""
    if per_host and shard_index is None and shard_count is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            shard_index, shard_count = dist.get_rank(), dist.get_world_size()
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            shard_index = int(os.environ["RANK"])
            shard_count = int(os.environ["WORLD_SIZE"])
        else:
            shard_index, shard_count = 0, 1
    shard_index = 0 if shard_index is None else int(shard_index)
    shard_count = 1 if shard_count is None else int(shard_count)
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index {shard_index} outside "
                         f"[0, {shard_count})")
    return shard_index, shard_count


class NativeDataLoader:
    """Shuffling batch iterator over a record file (C++ threads).

    Yields ``(batch_size,) + record_shape`` arrays of the record dtype,
    forever (each epoch reshuffles with seed + epoch), in the JAX
    package's order for the same file, seed and stripe.

    Batches come from a :class:`BufferPool` of reusable staging buffers
    (pinned host memory on ``device="cuda"``): hand each one back with
    :meth:`recycle` once nothing reads it any more (the
    :class:`DevicePrefetcher` does, once its copy retired); a buffer not
    returned costs a fresh allocation, never a corrupt batch. With
    ``block_shuffle=True`` batches are read-only views into the file's
    mmap (shuffled in whole batch-sized blocks) and ``recycle`` ignores
    them; on CUDA each view costs one copy into pinned memory when it is
    placed (``Remapper.shard_batch``).

    ``per_host=True`` (or ``shard_index`` / ``shard_count``) stripes the
    file across processes: this loader reads only its contiguous
    ``num_samples``-record range, which :meth:`stats` shows.

    ``device`` is where the batches go: ``"cuda"`` (the default; raises
    without CUDA) pins the staging buffers, ``"cpu"`` does not.
    """

    def __init__(self, path, record_shape, dtype, batch_size, seed=0,
                 capacity=8, num_threads=None, pipeline=None,
                 shard_index=None, shard_count=None, per_host=False,
                 block_shuffle=False, pool_size=None, ring_depth=None,
                 device="cuda"):
        """``pipeline=True`` keeps an async assembly ring of up to
        ``ring_depth`` batches (default ``AUTODIST_LOADER_RING``) filling
        ahead in a native thread: ``__next__`` hands out the oldest
        finished assembly and tops the ring up, so the copy overlaps the
        consumer's own work. Default: on with no worker threads (the only
        overlap there), off when worker threads assemble ahead anyway;
        ``block_shuffle`` needs neither (views are not assembled).
        ``num_threads`` defaults to 2, or 0 on a one-core host, where
        workers would only take turns with the consumer."""
        self.device = resolve_device(device)
        if num_threads is None:
            num_threads = 0 if (os.cpu_count() or 1) <= 1 else 2
        if block_shuffle:
            num_threads = 0  # views are synchronous: nothing to assemble
        if pipeline is None:
            pipeline = num_threads == 0 and not block_shuffle
        self.record_shape = tuple(record_shape)
        self.dtype = np.dtype(dtype)
        self.batch_size = batch_size
        self.block_shuffle = block_shuffle
        self.shard_index, self.shard_count = _resolve_shard(
            shard_index, shard_count, per_host)
        sample_bytes = int(np.prod(self.record_shape, dtype=np.int64) *
                           self.dtype.itemsize) if self.record_shape else \
            self.dtype.itemsize
        self._impl = None
        lib = _build_native()
        if lib is not None:
            h = lib.loader_create_ex(
                str(path).encode(), sample_bytes, batch_size, capacity,
                seed, num_threads, self.shard_index, self.shard_count,
                1 if block_shuffle else 0)
            if h:
                self._impl = ("native", lib, ctypes.c_void_p(h))
        if self._impl is None:
            self._impl = ("python",
                          _PyLoaderImpl(path, sample_bytes, batch_size,
                                        seed, capacity,
                                        shard_index=self.shard_index,
                                        shard_count=self.shard_count,
                                        block_shuffle=block_shuffle), None)
        self._sample_bytes = sample_bytes
        if ring_depth is None:
            ring_depth = max(0, const.ENV.AUTODIST_LOADER_RING.val)
        self._ring_depth = (min(ring_depth, max(1, capacity))
                            if (pipeline and self._impl[0] == "native"
                                and num_threads == 0 and not block_shuffle)
                            else 0)
        self._ring = deque()  # buffers with a queued or running assembly
        if pool_size is None:
            pool_size = const.ENV.AUTODIST_LOADER_POOL.val or \
                (self._ring_depth + const.ENV.AUTODIST_PREFETCH_DEPTH.val + 2)
        self._pool = BufferPool((batch_size,) + self.record_shape,
                                self.dtype, pool_size,
                                pin_memory=self.device.type == "cuda")

    @property
    def backend(self):
        """``"native"`` (the C++ loader) or ``"python"`` (the fallback)."""
        return self._impl[0]

    @property
    def num_samples(self):
        """Records in this shard's stripe (the whole file unsharded)."""
        kind, lib, h = self._impl
        if kind == "native":
            return int(lib.loader_num_samples(h))
        return lib.num_samples

    @property
    def pool(self):
        return self._pool

    def recycle(self, buf):
        """Return a batch buffer this loader handed out to its pool. Safe
        with anything (labels, views, tensors are ignored); call it only
        once nothing reads the buffer's bytes any more."""
        self._pool.release(buf)

    def stats(self):
        """{records_read, min_index, max_index, pool_fallback_allocs}; the
        indices are global record-file indices (None before the first
        read), so a multi-process run can check that this process read
        nothing outside its stripe."""
        kind, lib, h = self._impl
        if kind == "native":
            out = (ctypes.c_int64 * 3)()
            lib.loader_stats(h, out)
            read, lo, hi = int(out[0]), int(out[1]), int(out[2])
        elif kind == "python":
            read, lo, hi = lib.stats()
        else:
            read, lo, hi = 0, -1, -1
        return {"records_read": read,
                "min_index": None if lo < 0 else lo,
                "max_index": None if hi < 0 else hi,
                "pool_fallback_allocs": self._pool.fallback_allocs}

    def __iter__(self):
        return self

    def _next_view(self, lib, h):
        """Zero-copy hand-out: a read-only array over the mmap'd block."""
        ptr = ctypes.c_void_p()
        rc = lib.loader_next_view(h, ctypes.byref(ptr))
        if rc != 0:
            raise StopIteration
        nbytes = self.batch_size * self._sample_bytes
        raw = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
        out = np.frombuffer(raw, dtype=self.dtype).reshape(
            (self.batch_size,) + self.record_shape)
        out.flags.writeable = False
        return out

    def __next__(self):
        kind, lib, h = self._impl
        if kind == "closed":
            raise StopIteration
        if kind == "python":
            if self.block_shuffle:
                raw = lib.next_view()
                return raw.view(self.dtype).reshape(
                    (self.batch_size,) + self.record_shape)
            out = self._pool.acquire()
            try:
                lib.next_into(out)
            except StopIteration:
                self._pool.release(out)
                raise
            return out
        if self.block_shuffle:
            return self._next_view(lib, h)
        if self._ring_depth:
            # Top the ring up before collecting: the queued assemblies
            # overlap this wait and the consumer's work after it.
            while len(self._ring) < self._ring_depth:
                buf = self._pool.acquire()
                if lib.loader_next_async(
                        h, buf.ctypes.data_as(ctypes.c_void_p)) != 0:
                    # Refused (ring full or busy): this batch goes the
                    # synchronous way.
                    self._pool.release(buf)
                    break
                self._ring.append(buf)
            if self._ring:
                rc = lib.loader_next_wait(h)
                buf = self._ring.popleft()
                if rc != 0:
                    self._pool.release(buf)
                    self._drain_ring()
                    raise StopIteration
                return buf
        out = self._pool.acquire()
        rc = lib.loader_next(h, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            self._pool.release(out)
            raise StopIteration
        return out

    def _drain_ring(self):
        """Settle every queued async assembly (its thread writes into
        buffers Python owns) and take the buffers back."""
        kind, lib, h = self._impl
        while self._ring:
            if kind == "native":
                lib.loader_next_wait(h)
            self._pool.release(self._ring.popleft())

    def close(self):
        kind, lib, h = self._impl
        if kind == "native" and h:
            self._drain_ring()
            lib.loader_destroy(h)
            self._impl = ("closed", None, None)
        elif kind == "python":
            lib.close()
            self._impl = ("closed", None, None)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class _PyLoaderImpl:
    """Threaded pure-Python fallback with the same shuffle semantics as
    the JAX package's (``np.random.RandomState(seed + epoch)``)."""

    def __init__(self, path, sample_bytes, batch_size, seed, capacity,
                 shard_index=0, shard_count=1, block_shuffle=False):
        data = np.memmap(path, np.uint8, "r")
        file_samples = data.size // sample_bytes
        per = file_samples // shard_count
        self._lo = shard_index * per
        self.num_samples = per
        if self.num_samples < batch_size:
            raise ValueError(f"shard has {per} records < batch {batch_size}")
        self._data = data[:file_samples * sample_bytes].reshape(
            file_samples, sample_bytes)
        self._batch = batch_size
        self._seed = seed
        self._block = block_shuffle
        self._reads = 0
        self._min = -1
        self._max = -1
        self._stats_lock = threading.Lock()
        if block_shuffle:
            self._ticket = 0  # synchronous: views need no producer thread
            return
        self._q = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _account(self, lo, hi, count):
        with self._stats_lock:
            self._reads += count
            if self._min < 0 or lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    def stats(self):
        with self._stats_lock:
            return self._reads, self._min, self._max

    def _loop(self):
        epoch = 0
        while not self._stop.is_set():
            rng = np.random.RandomState((self._seed + epoch) % (2 ** 31))
            perm = self._lo + rng.permutation(self.num_samples)
            for s in range(self.num_samples // self._batch):
                idx = perm[s * self._batch:(s + 1) * self._batch]
                batch = np.asarray(self._data[idx])
                self._account(int(idx.min()), int(idx.max()), len(idx))
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            epoch += 1

    def next_into(self, out):
        # Timeout and check: after close() the producer stops, so a bare
        # blocking get() would hang; StopIteration as the native loader.
        while True:
            try:
                batch = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        out.view(np.uint8).reshape(batch.shape)[:] = batch

    def next_view(self):
        """Zero-copy block hand-out (block-shuffle mode only)."""
        bpe = self.num_samples // self._batch
        epoch, slot = divmod(self._ticket, bpe)
        self._ticket += 1
        rng = np.random.RandomState((self._seed + epoch) % (2 ** 31))
        block = int(rng.permutation(bpe)[slot])
        first = self._lo + block * self._batch
        self._account(first, first + self._batch - 1, self._batch)
        out = self._data[first:first + self._batch]
        out.flags.writeable = False
        return out

    def close(self):
        if not self._block:
            self._stop.set()


class BlockStacker:
    """Stacks K consecutive host batches into one ``(K,) + batch`` block:
    the input of the Runner's K-step graph (``Runner.run(unroll=K)``,
    ``megastep``).

    Blocks are assembled into pooled block-shaped buffers
    (``np.stack(..., out=buffer)``; pinned on ``device="cuda"``), and each
    source batch goes back to ``recycle_to`` (the wrapped loader) as soon
    as its rows are copied. Pass this object as the
    :class:`DevicePrefetcher`'s ``loader=``: :meth:`recycle` routes
    block buffers to their pools and anything else to the wrapped
    loader."""

    def __init__(self, iterator, unroll, recycle_to=None, pool_size=None,
                 device="cuda"):
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        self.device = resolve_device(device)
        self._it = iter(iterator)
        self._k = int(unroll)
        self._recycle_to = recycle_to
        if pool_size is None:
            pool_size = const.ENV.AUTODIST_LOADER_POOL.val or \
                (max(0, const.ENV.AUTODIST_PREFETCH_DEPTH.val) + 2)
        self._pool_size = max(1, int(pool_size))
        self._pools = {}  # (shape, dtype) -> BufferPool of block buffers

    @property
    def unroll(self):
        return self._k

    def recycle(self, buf):
        """Return a block buffer to its pool; anything else goes to the
        wrapped loader (which ignores what it cannot reuse)."""
        for pool in self._pools.values():
            if pool.release(buf):
                return
        if self._recycle_to is not None:
            self._recycle_to.recycle(buf)

    def _block_buffer(self, shape, dtype):
        key = (tuple(shape), np.dtype(dtype))
        pool = self._pools.get(key)
        if pool is None:
            pool = BufferPool(shape, dtype, self._pool_size,
                              pin_memory=self.device.type == "cuda")
            self._pools[key] = pool
        return pool.acquire()

    def _give_back(self, batches):
        if self._recycle_to is not None:
            for b in batches:
                for leaf in tree_leaves(b):
                    self._recycle_to.recycle(leaf)

    def __iter__(self):
        return self

    def __next__(self):
        batches = []
        try:
            for _ in range(self._k):
                batches.append(next(self._it))
        except StopIteration:
            # A partial block at the end: a megastep needs K steps of data.
            self._give_back(batches)
            raise
        flat = [flatten(b) for b in batches]
        out = []
        for j in range(len(flat[0][0])):
            parts = [np.asarray(f[0][j]) for f in flat]
            buf = self._block_buffer((self._k,) + parts[0].shape,
                                     parts[0].dtype)
            np.stack(parts, out=buf)
            out.append(buf)
        self._give_back(batches)
        return unflatten(flat[0][1], out)


def _own_copy(leaf):
    return np.array(leaf) if isinstance(leaf, np.ndarray) else leaf


class DevicePrefetcher:
    """Keeps ``depth`` placed batches in flight ahead of the consumer.

    Each ``__next__``

    1. recycles (``loader=``) the staging buffers of earlier batches whose
       copies have completed;
    2. tops the window up: pulls host batches and *issues* their copies
       without waiting; a source with ``next_nowait()`` (the serve request
       queue) tops up lazily, never stalling on traffic that has not
       arrived;
    3. settles the oldest and hands it out.

    On CUDA the copies run on a side stream from pinned host memory
    (``non_blocking=True``) and each batch records one ``torch.cuda.Event``;
    settling makes the consumer's current stream wait on that event (a
    device-side wait: the host does not block), so the copy of batch i+1
    overlaps the compute of batch i, and a graph step's copy into its
    static buffers runs after it. A staging buffer goes back to
    ``loader`` only once its event reports complete (``event.query()``):
    the consumer's wait does not tell the host when the copy engine has
    read it. On the CPU a placed batch would alias the loader's buffer, so
    it is copied first and the buffer recycled at once. ``depth=0``
    places and hands out synchronously.

    ``shard_fn(batch, non_blocking=...)`` overrides the placement call
    (default ``remapper.shard_batch``; the Runner passes ``shard_block``
    for K-blocks). ``pull_in_background`` (default: on a multi-core host
    when no ``loader`` is given; ``shard_in_background=True`` asks for it
    too, as in the JAX package) pulls the source on a thread into a
    queue of ``depth``. A loader assembles on its own native threads, and
    a pull thread would hold ``depth + 1`` more of its pooled buffers than
    its pool is sized for.

    :meth:`stats` counts the data wait: the host time the consumer spent
    inside ``__next__`` (pulling from the source, issuing copies, ordering
    its stream after them); a device-side wait does not show in it."""

    def __init__(self, iterator, remapper, depth=None,
                 shard_in_background=None, loader=None,
                 pull_in_background=None, shard_fn=None):
        if depth is None:
            depth = max(0, const.ENV.AUTODIST_PREFETCH_DEPTH.val)
        self._next_nowait = getattr(iterator, "next_nowait", None)
        self._it = iter(iterator)
        self._shard = shard_fn if shard_fn is not None \
            else remapper.shard_batch
        self._loader = loader
        self._depth = depth
        self._inflight = deque()  # (device_batch, event or None)
        self._retiring = deque()  # (event, host batch) to recycle
        self._exhausted = False
        self._wait_s_total = 0.0
        self._wait_s_last = 0.0
        self._batches = 0
        device = remapper.device
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        if pull_in_background is None:
            pull_in_background = bool(shard_in_background) or (
                loader is None and (os.cpu_count() or 1) > 1)
        self._q = None
        if pull_in_background and depth > 0:
            self._q = queue.Queue(maxsize=max(1, depth))
            self._done = object()
            self._thread = threading.Thread(target=self._pull_loop,
                                            daemon=True)
            self._thread.start()

    # -- source side ---------------------------------------------------------

    def _pull_loop(self):
        try:
            for batch in self._it:
                self._q.put(batch)
        except Exception as e:  # noqa: BLE001 - surfaced on next()
            self._q.put(e)
        self._q.put(self._done)

    def _pull(self):
        """Next host batch; raises StopIteration when the source ends."""
        if self._q is None:
            return next(self._it)
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    # -- transfer side -------------------------------------------------------

    def _issue(self, host_batch):
        if self._stream is None:
            if self._loader is None:
                return self._shard(host_batch, non_blocking=False), None
            db = self._shard(tree_map(_own_copy, host_batch),
                             non_blocking=False)
            self._recycle(host_batch)
            return db, None
        with torch.cuda.stream(self._stream):
            db = self._shard(host_batch, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        if self._loader is not None:
            self._retire(event, host_batch)
        return db, event

    def _retire(self, event, host_batch):
        """Recycle ``host_batch`` once ``event`` (its copy) completed."""
        self._retiring.append((event, host_batch))

    def _recycle_retired(self):
        while self._retiring and self._retiring[0][0].query():
            self._recycle(self._retiring.popleft()[1])

    def _recycle(self, host_batch):
        for leaf in tree_leaves(host_batch):
            self._loader.recycle(leaf)

    def _settle(self, device_batch, event):
        """Order the consumer's stream after the batch's copies."""
        if event is None:
            return
        consumer = torch.cuda.current_stream(self._stream.device)
        consumer.wait_event(event)
        for leaf in tree_leaves(device_batch):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                # Allocated on the side stream, read on the consumer's:
                # keep the allocator from reusing it too early.
                leaf.record_stream(consumer)

    @property
    def last_wait_ms(self):
        return self._wait_s_last * 1e3

    def stats(self):
        """{batches, data_wait_ms_total, data_wait_ms_mean, inflight}."""
        return {"batches": self._batches,
                "data_wait_ms_total": round(self._wait_s_total * 1e3, 3),
                "data_wait_ms_mean": round(
                    self._wait_s_total * 1e3 / self._batches, 3)
                if self._batches else None,
                "inflight": len(self._inflight)}

    def _handed_out(self, t0):
        dt = time.perf_counter() - t0
        self._wait_s_last = dt
        self._wait_s_total += dt
        self._batches += 1

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        self._recycle_retired()
        if self._depth == 0:
            db, event = self._issue(self._pull())
            self._settle(db, event)
            self._handed_out(t0)
            return db
        while len(self._inflight) < self._depth and not self._exhausted:
            lazy = self._next_nowait is not None and self._inflight
            try:
                hb = self._next_nowait() if lazy else self._pull()
            except StopIteration:
                self._exhausted = True
                break
            if hb is None and lazy:
                break  # nothing queued right now; don't stall the window
            self._inflight.append(self._issue(hb))
        if not self._inflight:
            raise StopIteration
        db, event = self._inflight.popleft()
        self._settle(db, event)
        self._handed_out(t0)
        return db
