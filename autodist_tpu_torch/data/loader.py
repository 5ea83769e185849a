"""DevicePrefetcher: keeps ``depth`` batches in flight ahead of the consumer.

Counterpart of ``autodist_tpu/data/loader.py:DevicePrefetcher``: a deque of
up to ``depth`` in-flight host->device copies. Each ``__next__``

1. tops the window up — pulls host batches and *issues* their copies
   without waiting; a source with ``next_nowait()`` (the serve request
   queue) tops up lazily, never stalling on traffic that has not arrived;
2. settles the oldest and hands it out.

On CUDA the copies run on a side stream from pinned host memory
(``non_blocking=True``) and each batch records one ``torch.cuda.Event``;
settling makes the consumer's current stream wait on that event (a
device-side wait: the host does not block), so the copy of batch i+1
overlaps the compute of batch i. ``depth=0`` degrades to synchronous
place-and-hand-out. The native loader and ``BlockStacker`` are not ported
yet (ROADMAP.md).
"""
import os
import queue
import threading
from collections import deque

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.utils.tree import leaves as tree_leaves


class DevicePrefetcher:
    """Depth-N window of placed batches over any host-batch iterator.

    ``shard_fn(batch, non_blocking=...)`` overrides the placement call
    (default ``remapper.shard_batch``)."""

    def __init__(self, iterator, remapper, depth=None,
                 pull_in_background=None, shard_fn=None):
        if depth is None:
            depth = max(0, const.ENV.AUTODIST_PREFETCH_DEPTH.val)
        self._next_nowait = getattr(iterator, "next_nowait", None)
        self._it = iter(iterator)
        self._shard = shard_fn if shard_fn is not None \
            else remapper.shard_batch
        self._depth = depth
        self._inflight = deque()  # (device_batch, event or None)
        self._exhausted = False
        device = remapper.device
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        if pull_in_background is None:
            pull_in_background = (os.cpu_count() or 1) > 1
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
            return self._shard(host_batch, non_blocking=False), None
        with torch.cuda.stream(self._stream):
            db = self._shard(host_batch, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return db, event

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

    def __iter__(self):
        return self

    def __next__(self):
        if self._depth == 0:
            db, event = self._issue(self._pull())
            self._settle(db, event)
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
        return db
