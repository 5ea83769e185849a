"""Saver and CheckpointManager: logical-name-keyed, layout-free checkpoints.

Counterpart of ``autodist_tpu/checkpoint/saver.py``. A checkpoint stores
the *logical* state (:meth:`Runner.to_logical`): whole, unpadded params
and optimizer state keyed by '/'-joined tree paths, identical however the
ranks stored them, so it restores onto any world (N -> M ranks, another
builder) and any reader can open it.

**Format** (the port's own; the JAX package's orbax format is not read).
A checkpoint is a directory holding

* ``arrays.bin``: every leaf's bytes, C order, little-endian, each at a
  64-byte-aligned offset;
* ``index.json``: ``{"format", "version", "nbytes", "leaves": [{"path",
  "dtype", "shape", "offset", "nbytes"}]}``, written after the data.

numpy and the standard library read it (``np.frombuffer`` at each offset).
A bfloat16 leaf is stored as its 16-bit pattern with ``"dtype":
"bfloat16"`` in the index (numpy has no bfloat16); the port's readers give
back ``torch.bfloat16`` tensors. No pickle, no ``torch.load``. A
checkpoint is written into a temporary sibling directory (data and index
flushed to disk) and renamed into place, so a torn write is never
mistaken for a checkpoint; the index is its seal. Reads give CPU tensors
(torch's host arrays; the JAX package's give numpy arrays).

A save first copies every leaf into one host buffer laid out as
``arrays.bin`` (pinned for leaves on the card, the copies on a side
stream), then writes it with one call. ``Saver.save`` and
:func:`write_tree` return once the checkpoint is durable;
``CheckpointManager.save`` returns after the copy and leaves the write to
a thread (``wait_until_finished``).

Multi-rank: converting to the logical form is a collective every rank
calls; only the chief (rank 0) writes, then every rank waits at a barrier
(for the manager, in ``wait_until_finished``). Paths must be on a
filesystem every rank sees.
"""
import json
import os
import shutil
import threading
import time
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, observability
from autodist_tpu_torch.checkpoint import manifest as manifest_mod
from autodist_tpu_torch.checkpoint.manifest import ManifestMismatchError
from autodist_tpu_torch.resilience.retry import (retry_call,
                                                 transient_runtime_error)
from autodist_tpu_torch.runner import (DispatchClock, TrainState,
                                       flush_cadence)
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

FORMAT = "autodist_tpu_torch-checkpoint"
FORMAT_VERSION = 1
INDEX = "index.json"
ARRAYS = "arrays.bin"
_ALIGN = 64

# numpy dtype of each stored torch dtype (bfloat16 as its bits).
_NUMPY = {torch.float64: np.float64, torch.float32: np.float32,
          torch.float16: np.float16, torch.bfloat16: np.uint16,
          torch.int64: np.int64, torch.int32: np.int32,
          torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
          torch.bool: np.bool_}
_TORCH = {manifest_mod.dtype_name(t): t for t in _NUMPY}


class _Staged(NamedTuple):
    """A tree copied into one host buffer laid out as ``arrays.bin``:
    ``buffer`` (uint8, pinned when a leaf was on the card), its first
    ``nbytes`` the file's bytes, ``entries`` the index's leaves, and
    ``done`` the CUDA event that marks the copies complete (None when
    every leaf was on the host)."""
    buffer: Any
    nbytes: int
    entries: list
    done: Any


def _stage(tree, buffer=None):
    """Copy every leaf of ``tree`` into a host buffer laid out as
    ``arrays.bin`` (``buffer`` when it is large enough and pinned where it
    must be, else a new one). Host leaves are copied now. Leaves on the
    card (one process drives one device) are copied without blocking on a
    side stream that first waits for the work already queued, and the
    current stream then waits for those copies: the caller may return at
    once, and the next in-place update of a leaf runs only after its copy
    (a device-side wait, no host stall)."""
    leaves = [(path_to_name(p), torch.as_tensor(leaf).detach())
              for p, leaf in flatten_with_path(tree)[0]]
    entries, offset = [], 0
    for name, t in leaves:
        if t.dtype not in _NUMPY:
            raise TypeError(f"autodist_tpu_torch: cannot checkpoint a "
                            f"{t.dtype} tensor ({name})")
        offset += -offset % _ALIGN
        nbytes = t.numel() * t.element_size()
        entries.append({"path": name,
                        "dtype": manifest_mod.dtype_name(t.dtype),
                        "shape": [int(s) for s in t.shape],
                        "offset": offset, "nbytes": int(nbytes)})
        offset += nbytes
    device = next((t.device for _, t in leaves if t.is_cuda), None)
    if buffer is None or buffer.numel() < offset or \
            (device is not None and not buffer.is_pinned()):
        buffer = torch.empty(offset, dtype=torch.uint8,
                             pin_memory=device is not None)
    end = 0
    for e in entries:  # the alignment padding, zeros as before
        buffer[end:e["offset"]].zero_()
        end = e["offset"] + e["nbytes"]
    side = done = None
    if device is not None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
    for (_, t), e in zip(leaves, entries):
        dst = buffer[e["offset"]:e["offset"] + e["nbytes"]]
        dst = dst.view(t.dtype).view(t.shape)
        if not t.is_cuda:
            dst.copy_(t)
            continue
        with torch.cuda.stream(side):
            dst.copy_(t, non_blocking=True)
        t.record_stream(side)  # a gathered copy may be freed meanwhile
    if side is not None:
        done = torch.cuda.Event()
        done.record(side)
        torch.cuda.current_stream(device).wait_stream(side)
    return _Staged(buffer, offset, entries, done)


def _fsync(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_staged(path, staged):
    """Write a staged tree as a checkpoint directory at ``path``,
    atomically, replacing one there: the data, then the index (the seal),
    each fsynced, in a temporary sibling renamed into place. Waits for the
    staging copies first. Returns the data bytes."""
    path = os.path.abspath(str(path))
    if staged.done is not None:
        staged.done.synchronize()
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{time.monotonic_ns()}"
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, ARRAYS), "wb") as f:
            f.write(memoryview(staged.buffer.numpy())[:staged.nbytes])
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, INDEX), "w") as f:
            json.dump({"format": FORMAT, "version": FORMAT_VERSION,
                       "nbytes": staged.nbytes, "leaves": staged.entries}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            old = f"{tmp}.old"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
        _fsync(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return staged.nbytes


def write_tree(path, tree, force=True):
    """Write ``tree`` (nested dicts / lists of tensors) as a checkpoint
    directory at ``path``, atomically, before returning; returns the data
    bytes. An existing checkpoint there is replaced only with ``force``."""
    if os.path.exists(os.path.abspath(str(path))) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    return _write_staged(path, _stage(tree))


def read_tree(path):
    """Read a checkpoint directory: nested dicts of CPU tensors by path
    (sequence indices become string keys). Raises on a missing index
    (an unsealed or torn checkpoint), a foreign format, or data shorter
    than the index says."""
    path = os.path.abspath(str(path))
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    if index.get("format") != FORMAT or \
            int(index.get("version", 0)) > FORMAT_VERSION:
        raise ValueError(f"{path}: not a {FORMAT} v{FORMAT_VERSION} "
                         f"checkpoint")
    buf = np.fromfile(os.path.join(path, ARRAYS), dtype=np.uint8)
    if buf.size < int(index["nbytes"]):
        raise ValueError(f"{path}: {ARRAYS} holds {buf.size} bytes, the "
                         f"index says {index['nbytes']} (truncated)")
    tree = {}
    for e in index["leaves"]:
        dtype = _TORCH[e["dtype"]]
        count = int(np.prod(e["shape"], dtype=np.int64))
        arr = np.frombuffer(buf, dtype=_NUMPY[dtype], count=count,
                            offset=int(e["offset"])).reshape(e["shape"])
        t = torch.from_numpy(arr)
        if dtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        node, parts = tree, e["path"].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return tree


def _barrier():
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# Managers whose writer thread may be running: an elastic re-exec
# (``Coordinator.reform_now``) joins them first, so the exec never tears a
# save.
_MANAGERS = weakref.WeakSet()


def join_writers():
    """Wait for every manager's pending checkpoint write to be durable (no
    barrier: a peer may be dead). A write that failed stays for that
    manager's next wait to raise."""
    for mgr in list(_MANAGERS):
        writer = mgr._writer
        if writer is not None:
            writer.join()


class _HandOff(Exception):
    """Unwinds ``CheckpointManager.run``'s step loop to its drain (an
    elastic re-form) or its emergency exit (checkpoint-and-exit), which
    then run outside the loop's span."""

    def __init__(self, elastic, step, state, torn=False, cause=None):
        super().__init__(f"hand-off at step {step}")
        self.elastic, self.step, self.state = elastic, step, state
        self.torn, self.cause = torn, cause


# How long a failed step or save waits for the supervision thread to note
# the worker death that caused it (the watcher's waitpid returns as the
# dead peer's sockets close, so it is usually at once).
_DEATH_WAIT_S = 30.0


def _death_noted(coordinator):
    """Whether the coordinator notes a worker death (or a re-form) within
    ``_DEATH_WAIT_S``; at once when it launched no worker."""
    if not coordinator._procs:
        return coordinator.failed or coordinator.reform_requested
    deadline = time.monotonic() + _DEATH_WAIT_S
    while True:
        if coordinator.failed or coordinator.reform_requested:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)


def _whole_on_every_rank(runner):
    """True when every rank holds the whole state (no ``zero1`` shard,
    ``fsdp`` or piece of another rank to gather): converting it to the
    checkpoint form calls no collective, so one rank can write it alone."""
    multi = dist.is_initialized() and dist.get_world_size() > 1
    return not any(kind in ("zero1", "fsdp")
                   for kind, _ in runner._kinds.values()) and \
        not any(runner._piece_dims.values()) and \
        not (multi and runner.has_sync_state)


def _logical_tree(runner, state):
    """(tree to write, logical state or None): a TrainState's checkpoint
    form through ``runner``, or a bare tree as it is."""
    if isinstance(state, TrainState):
        if runner is None:
            raise ValueError("saving a TrainState needs a Runner (its "
                             "optimizer state has no layout-free form "
                             "without one); save a bare params tree with "
                             "Saver()")
        logical = runner.to_logical(state)
        return manifest_mod.state_tree(logical), logical
    return state, None


def _as_logical(raw):
    """A raw read of a training checkpoint as a logical TrainState (its
    ``sync_state`` ``{}`` when it wrote none: the live entries are then
    reinitialized, ``Runner.from_logical``)."""
    return TrainState(raw["step"], raw["params"], raw.get("opt_state", {}),
                      raw.get("sync_state", {}))


def reshard_state(runner, raw, into=None):
    """Rebuild a live state on the *current* world from a raw (host) read
    of a checkpoint written under another one (its manifest already
    validated against the live model): the cross-shape half of the
    elastic contract. Params and optimizer state carry logical shapes and
    transfer value-exact, placed (padded, sharded) by
    ``Runner.from_logical``. A stale variable's checkpoint form is one
    copy (the chief's), so it needs no collapse."""
    return runner.from_logical(_as_logical(raw), into=into)


def _reshard_restore(runner, manifest, raw, where="", into=None):
    """One cross-shape restore: rebuild on the current world and record
    the reshard as an event."""
    from autodist_tpu_torch import resilience
    world = manifest.get("world", {})
    t0 = time.perf_counter()
    with observability.span("restore", where=str(where), reshard=True):
        state = reshard_state(runner, raw, into=into)
    dt_ms = (time.perf_counter() - t0) * 1e3
    live = manifest_mod.live_world(runner)
    detail = (f"step {int(state.step)}: world {world.get('devices')}d/"
              f"{world.get('processes')}p -> {live['devices']}d/"
              f"{live['processes']}p in {dt_ms:.0f}ms")
    resilience.record_event("reshard", detail)
    observability.record_event("checkpoint-restore", f"resharded: {detail}")
    logging.info("cross-shape restore (%s): %s", where, detail)
    if observability.enabled():
        reg = observability.registry()
        reg.gauge("checkpoint.reshard_ms").set(round(dt_ms, 3))
        reg.gauge("cluster.world_size").set(live["processes"])
    return state


def _params_subtree(tree):
    """Params subtree of a raw read: a training checkpoint reads as
    ``{step, params, opt_state}``; a params-only one is the params tree."""
    if isinstance(tree, dict) and "params" in tree and "step" in tree:
        return tree["params"]
    return tree


def _read(path, what):
    return retry_call(read_tree, path, is_retryable=transient_runtime_error,
                      describe=what)


def _restore(runner, raw, manifest, where, into):
    if manifest is not None and manifest_mod.world_changed(manifest, runner):
        return _reshard_restore(runner, manifest, raw, where=where,
                                into=into)
    with observability.span("restore", where=str(where)):
        return runner.from_logical(_as_logical(raw), into=into)


class Saver:
    """Save/restore the full training state (params + optimizer + step).

    A Saver bound to a Runner saves its states and restores onto its
    world; ``Saver()`` reads any checkpoint and saves bare trees."""

    def __init__(self, runner=None):
        self._runner = runner

    def save(self, state, path, force=True):
        """Write ``state`` (TrainState, or a bare params tree) to ``path``.
        Transient filesystem faults retry with backoff. TrainState saves
        get a manifest sidecar (``<path>.manifest.json``)."""
        path = os.path.abspath(str(path))
        with observability.span("checkpoint-save", path=path):
            tree, logical = _logical_tree(self._runner, state)
            if manifest_mod.is_chief():
                retry_call(write_tree, path, tree, force=force,
                           is_retryable=transient_runtime_error,
                           describe="checkpoint save")
                if logical is not None:
                    manifest_mod.write_manifest(
                        self._runner, int(logical.step),
                        manifest_mod.sidecar_path(path), logical)
            _barrier()
        observability.record_event("checkpoint-save", path)
        logging.info("saved checkpoint %s", path)
        return path

    def restore(self, path, into=None):
        """Restore onto the bound runner's world (any world: a change since
        save time goes through the cross-shape path). ``into``: a live
        state to copy the values into (``Runner.from_logical``). A
        manifest whose params do not match the live model raises
        :class:`ManifestMismatchError`."""
        if self._runner is None:
            raise ValueError("restore() needs a Runner; use restore_raw() "
                             "for framework-free reads")
        path = os.path.abspath(str(path))
        man = manifest_mod.read_manifest(manifest_mod.sidecar_path(path))
        if man is not None:
            manifest_mod.validate_manifest(man, self._runner, where=path)
        state = _restore(self._runner, _read(path, "checkpoint restore"),
                         man, path, into)
        observability.record_event("checkpoint-restore", path)
        logging.info("restored checkpoint %s", path)
        return state

    def restore_raw(self, path):
        """Framework-free read: the checkpoint as nested dicts of CPU
        tensors (readable from any world size)."""
        return read_tree(path)

    def restore_params(self, path):
        """Params-only restore: the model parameters as a tree of CPU
        tensors, with NO optimizer required or reconstructed. Works on
        training checkpoints and params-only saves alike; the result feeds
        ``serve.Server``, which places it. Needs no Runner."""
        with observability.span("restore", path=path, params_only=True):
            params = _params_subtree(self.restore_raw(path))
        observability.record_event("checkpoint-restore",
                                   f"params-only {path}")
        logging.info("restored params-only checkpoint %s", path)
        return params


class CheckpointManager:
    """Periodic checkpointing + resume (preemption tolerance).

    Step ``s`` lives in ``<directory>/<s>/`` with its manifest beside it
    (``manifest-<s>.json``). Which steps are written and kept follows
    orbax's ``CheckpointManager`` as the JAX package configures it: a step
    is saved when no checkpoint exists yet or when it is a multiple of
    ``save_interval_steps``, never when it is not past the latest saved
    step, and only the newest ``max_to_keep`` steps are kept (None: all).
    A forced save of an existing step writes nothing (returns False).

    Saves are asynchronous, as orbax's: :meth:`save` converts the state to
    its checkpoint form (a collective on several ranks), and the chief
    copies it into one host staging buffer laid out as ``arrays.bin``
    (pinned, reused by later saves; the copies run on a side stream that
    the training stream then waits for on the device) and returns. A
    writer thread writes the buffer, the index and the manifest to a
    temporary sibling, fsyncs, renames, and only then removes the steps
    pruned by ``max_to_keep``. :meth:`wait_until_finished` blocks until
    that is durable (and then meets the other ranks at a barrier); a
    second save, a restore and :meth:`close` wait first. A write that
    failed raises from the wait that follows it. A process that dies
    mid-write leaves only a temporary directory, never a step.
    """

    def __init__(self, runner, directory=None, save_interval_steps=100,
                 max_to_keep=3):
        self._runner = runner
        self._dir = os.path.abspath(str(directory or
                                        const.DEFAULT_CHECKPOINT_DIR))
        self._interval = save_interval_steps
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)
        # Every rank keeps the list (as orbax keeps its checkpoints): the
        # save decisions, and so the collectives of to_logical, agree
        # across ranks whatever the chief has already written.
        self._steps = sorted(int(d) for d in os.listdir(self._dir)
                             if d.isdigit() and
                             os.path.isdir(os.path.join(self._dir, d)))
        self._buffer = None      # the staging buffer, reused by each save
        self._writer = None      # the pending save's thread
        self._error = None       # what the pending save raised
        self._unsynced = False   # a save since the last barrier
        _MANAGERS.add(self)

    @property
    def directory(self):
        return self._dir

    def all_steps(self):
        return list(self._steps)

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def should_save(self, step):
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return (self._interval is not None and step % self._interval == 0) \
            or not self._steps

    def _step_dir(self, step):
        return os.path.join(self._dir, str(int(step)))

    def _manifest_path(self, step):
        return os.path.join(self._dir, manifest_mod.manifest_name(step))

    def save(self, step, state, force=False):
        """Start saving ``state`` as ``step`` when :meth:`should_save` says
        so (or ``force``); returns whether a checkpoint was started. The
        write goes on after this returns (:meth:`wait_until_finished`)."""
        step = int(step)
        if not force and not self.should_save(step):
            return False
        if step in self._steps:
            return False
        t0 = time.perf_counter()
        with observability.span("checkpoint-save", step=step):
            # One write at a time: it owns the buffer.
            self.wait_until_finished()
            tree, logical = _logical_tree(self._runner, state)
            self._steps = sorted(self._steps + [step])
            pruned = self._prune()
            self._unsynced = True
            if manifest_mod.is_chief():
                staged = _stage(tree, self._buffer)
                self._buffer = staged.buffer
                manifest = None if logical is None else \
                    manifest_mod.build_manifest(self._runner, step, logical)
                self._writer = threading.Thread(
                    target=self._write,
                    args=(step, staged, manifest, pruned),
                    name=f"checkpoint-step-{step}")
                self._writer.start()
        if observability.enabled():
            reg = observability.registry()
            reg.counter("checkpoint.saves").inc()
            reg.gauge("checkpoint.last_save_ms").set(
                round((time.perf_counter() - t0) * 1e3, 3))
            observability.record_event("checkpoint-save", f"step {step}")
        return True

    def _save_alone(self, step, state):
        """Save ``state`` as ``step`` and wait until it is durable, without
        a barrier (the pending write's one dropped too), for a world with a
        dead peer. The caller checks the state is whole on this rank
        (:func:`_whole_on_every_rank`): its checkpoint form then calls no
        collective."""
        self._unsynced = False
        saved = self.save(step, state, force=True)
        self._unsynced = False
        self.wait_until_finished()
        return saved

    def _write(self, step, staged, manifest, pruned):
        """The writer thread: the step made durable, then its manifest,
        then the pruned steps removed. What it raises is kept for
        :meth:`wait_until_finished`."""
        try:
            retry_call(_write_staged, self._step_dir(step), staged,
                       is_retryable=transient_runtime_error,
                       describe=f"checkpoint save (step {step})")
            if manifest is not None:
                manifest_mod.store_manifest(manifest,
                                            self._manifest_path(step))
            for old in pruned:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
                try:
                    os.remove(self._manifest_path(old))
                except OSError:  # hygiene only, never kill a save
                    pass
        except BaseException as e:  # noqa: BLE001 - raised by the wait
            self._error = (step, pruned, e)

    def _prune(self):
        """Drop the oldest steps beyond ``max_to_keep`` from the list;
        returns them (the writer removes the chief's directories and
        manifests once the new step is durable)."""
        pruned = []
        if self._max_to_keep is not None:
            while len(self._steps) > self._max_to_keep:
                pruned.append(self._steps.pop(0))
        return pruned

    def restore_params(self, step=None):
        """Params-only restore of a managed step (default: the latest) as
        a tree of CPU tensors, without touching or needing the optimizer."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise ValueError(
                f"no checkpoint steps under {self._dir}; nothing to "
                f"restore params from")
        with observability.span("restore", step=step, params_only=True):
            raw = _read(self._step_dir(step),
                        f"params-only restore (step {step})")
        observability.record_event("checkpoint-restore",
                                   f"params-only step {step}")
        logging.info("restored params-only checkpoint step %d", step)
        return _params_subtree(raw)

    def wait_until_finished(self):
        """Block until the pending save is durable (its data, index and
        manifest fsynced and renamed into place), then meet the other
        ranks at a barrier. Raises what the write raised; its step is then
        not listed, and the steps it would have pruned are again."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        failed, self._error = self._error, None
        if failed is not None:
            step, pruned, error = failed
            self._steps = sorted({s for s in self._steps if s != step} |
                                 set(pruned))
            raise error
        if self._unsynced:
            self._unsynced = False
            _barrier()

    def restore_or_init(self, into=None):
        """Resume from the newest INTACT checkpoint, or create fresh state.

        Steps are tried newest first. A step that cannot be read (no index:
        torn or truncated; data shorter than the index) or whose ``step``
        leaf (the sentinel) differs from its directory's name falls back
        to the previous retained one, because the likeliest cause is this
        very job's earlier incarnation dying mid-write. A manifest that
        does not match the live model raises :class:`ManifestMismatchError`
        and never falls back. ``into``: a live state to copy the values
        into (``Runner.from_logical``); with no step restorable it is reset
        to the captured params with no optimizer state."""
        from autodist_tpu_torch import resilience
        self.wait_until_finished()
        steps = self.all_steps()
        for step in reversed(steps):
            man = manifest_mod.read_manifest(self._manifest_path(step))
            if man is not None:
                manifest_mod.validate_manifest(
                    man, self._runner, where=f"step {step} in {self._dir}")
            try:
                raw = _read(self._step_dir(step),
                            f"checkpoint restore (step {step})")
                restored = int(raw["step"])
                if restored != step:
                    raise ValueError(
                        f"checkpoint step sentinel mismatch: directory "
                        f"{step} holds step={restored}")
                state = _restore(self._runner, raw, man, f"step {step}",
                                 into)
            except KeyboardInterrupt:
                raise
            except ManifestMismatchError:
                raise
            except Exception as e:  # noqa: BLE001 - corruption is open-ended
                resilience.record_event(
                    "ckpt-fallback",
                    f"step {step} unrestorable ({type(e).__name__}: "
                    f"{str(e)[:200]}); trying previous retained step")
                logging.warning("checkpoint step %d unrestorable (%s); "
                                "falling back to the previous retained step",
                                step, e)
                continue
            if observability.enabled():
                observability.registry().counter("checkpoint.restores").inc()
                observability.record_event("checkpoint-restore",
                                           f"resumed step {step}")
            logging.info("resumed from checkpoint step %d", step)
            return state
        if steps:
            logging.warning("no retained checkpoint was restorable; "
                            "initializing fresh state")
        if into is None:
            return self._runner.create_state()
        return self._runner.from_logical(self._runner.initial_logical(),
                                         into=into)

    def run(self, state, data_iter, num_steps, step_guard=None,
            preemption=None, unroll=None, coordinator=None):
        """Step loop with periodic checkpointing, from ``state.step`` to
        ``num_steps``; call again with :meth:`restore_or_init`'s state to
        resume after a preemption.

        * ``step_guard`` (:class:`~autodist_tpu_torch.resilience.StepGuard`)
          reads the device-side ``notfinite`` flag every ``check_every``
          steps AND before every periodic save (a poisoned state is never
          persisted); on divergence restores the newest intact checkpoint
          into the live state's tensors and continues with fresh batches.
        * ``preemption`` (:class:`~autodist_tpu_torch.resilience.
          PreemptionHandler`, or ``True`` to install one for the loop's
          duration): a SIGTERM/SIGINT force-saves an emergency checkpoint
          at the current step and raises :class:`~autodist_tpu_torch.
          resilience.Preempted`.

        ``unroll=K`` (env ``AUTODIST_UNROLL``) runs K steps per CUDA graph
        (``Runner.megastep``); saves, preemption polls and guard checks
        land on megastep boundaries. A resume whose start step is not
        K-aligned single-steps up to the next boundary first. With
        telemetry on, the loop records ``step.latency_ms`` and
        ``step.count`` in a ``step-loop`` span and finalizes the goodput
        ledger, as the JAX package's does.

        ``coordinator`` (the chief's ``AutoDist.coordinator``) lets the loop
        act on worker deaths: ``AUTODIST_CHAOS``'s ``kill_at`` /
        ``kill_worker`` / ``slow_host`` fire after each dispatch; a pending
        elastic re-form drains (:meth:`_elastic_drain`: an emergency save
        when one process is left, the goodput segment, then
        ``Coordinator.reform_now``, which re-execs the job, and
        :class:`~autodist_tpu_torch.resilience.ElasticReform` under a
        stubbed exec); a noted death under checkpoint-and-exit makes an
        emergency save (alone, without a barrier, where a peer is dead and
        the state is whole on this rank; else skipped and recorded) and
        raises. A step or save that fails while the coordinator notes a
        death (a collective with the dead peer) hands off the same way,
        without saving the state the failed step may have torn. The
        re-tuning hooks wait for A12 (ROADMAP.md)."""
        from autodist_tpu_torch.resilience import (DivergenceAbort,
                                                   PreemptionHandler)
        runner = self._runner
        metrics = None
        if unroll is None:
            unroll = const.ENV.AUTODIST_UNROLL.val
        unroll = max(1, int(unroll))
        chaos = None
        if const.ENV.AUTODIST_CHAOS.val:
            from autodist_tpu_torch.resilience import chaos
        handler, installed = preemption, False
        if handler is True:
            handler = PreemptionHandler().install()
            installed = True
        # Same telemetry discipline as Runner.run: one clock mark per
        # dispatch (DispatchClock: a CUDA event on the card), the registry
        # flushed on the guard's cadence; zero telemetry calls when
        # AUTODIST_TELEMETRY=0.
        obs = runner._obs
        cadence = flush_cadence(step_guard, unroll)
        clock = DispatchClock(runner.remapper.device) \
            if obs is not None else None
        # Same step-loop span Runner.run opens: the goodput ledger keys its
        # in-loop accounting (captures and saves billed into step latency)
        # on it.
        span = (obs.span("step-loop", steps=num_steps, unroll=unroll)
                if obs is not None else observability.tracing.NULL_SPAN)

        def flush():  # the billed steps so far, before a hand-off
            if clock is not None:
                clock.flush(obs.registry(), final=True)

        if coordinator is not None:
            coordinator.attach_loop()
        handoff = None
        try:
            with span:
                i = int(state.step)
                if clock is not None:
                    clock.start()
                while i < num_steps:
                    k = (unroll if unroll > 1 and i % unroll == 0
                         and num_steps - i >= unroll else 1)
                    if k > 1:
                        batch = runner._next_block(data_iter, k)
                    else:
                        batch = next(data_iter)
                    if chaos is not None:
                        batch = chaos.maybe_poison_batch(i + 1, batch)
                    try:
                        if k > 1:
                            state, metrics = runner.megastep(state, batch)
                        else:
                            state, metrics = runner.step(state, batch)
                    except DivergenceAbort:
                        raise
                    except Exception as e:  # noqa: BLE001 - a dead peer?
                        self._on_fault(e, i, state, coordinator, flush,
                                       torn=True)
                    i += k
                    if clock is not None:
                        clock.mark(k, 0.0)
                        if i % cadence == 0 or i >= num_steps:
                            clock.flush(obs.registry(),
                                        final=i >= num_steps)
                    if chaos is not None:
                        chaos.maybe_kill(i)
                        chaos.maybe_slow_host(i)
                    # The flag is read before any save, the emergency one
                    # included: a diverged state is rolled back, never
                    # saved.
                    preempted = bool(handler) and handler.preempted
                    checked = step_guard is not None and (
                        step_guard.due(i, unroll) or i >= num_steps
                        or self.should_save(i) or preempted)
                    diverged = checked and step_guard.diverged(metrics)
                    if diverged:
                        i, state = step_guard.rollback(i, manager=self,
                                                       state=state)
                        if clock is not None:
                            clock.start()  # don't bill rollback as steps
                    elif checked:
                        step_guard.progressed()
                    if handler:
                        handler.check(self, i, state)  # raises Preempted
                    if coordinator is not None:
                        self._poll_coordinator(coordinator, i, state, flush)
                    if not diverged:
                        try:
                            self.save(i, state)
                        except Exception as e:  # noqa: BLE001 - a dead peer?
                            self._on_fault(e, i, state, coordinator, flush,
                                           torn=False)
                if clock is not None:
                    clock.flush(obs.registry(), final=True)
                # The writer's last wait: never a step, a save's own time
                # (goodput's checkpoint class).
                with (obs.span("checkpoint-wait") if obs is not None
                      and self._writer is not None
                      else observability.tracing.NULL_SPAN):
                    self.wait_until_finished()
        except _HandOff as h:
            handoff = h
        finally:
            if installed:
                handler.uninstall()
            if coordinator is not None:
                coordinator.attach_loop(False)
        if handoff is not None:
            # Outside the step-loop span: the ledger then takes the loop's
            # in-loop captures and saves off its steps, as at a loop's end.
            if handoff.elastic:
                self._elastic_drain(handoff.step, handoff.state, coordinator,
                                    torn=handoff.torn, cause=handoff.cause,
                                    unroll=unroll)
            self._emergency_exit(handoff.step, handoff.state,
                                 torn=handoff.torn, cause=handoff.cause)
        if obs is not None:
            try:
                # The run-level goodput/MFU ledger: the same cold-path
                # finalize Runner.run makes.
                from autodist_tpu_torch.observability import goodput
                goodput.finalize(runner, obs.registry(), unroll=unroll)
            except Exception as e:  # noqa: BLE001
                logging.debug("goodput not recorded: %s", e)
        return state, metrics

    # -- worker deaths (``run(coordinator=...)``) ----------------------------

    def _poll_coordinator(self, coordinator, step, state, flush):
        """Between steps: a re-form requested (pending, or its exec under
        way on the supervision thread) hands off to the drain; a death
        noted under checkpoint-and-exit to the emergency exit."""
        if coordinator.reform_requested or coordinator.failed:
            flush()  # the segment this generation persists carries them
            raise _HandOff(coordinator.reform_requested, step, state)

    def _on_fault(self, error, step, state, coordinator, flush, torn):
        """A step (``torn``: its state may be half-updated) or a save
        raised. Where the coordinator notes a worker death within
        ``_DEATH_WAIT_S`` (a collective with the dead peer failed first),
        hand off as between steps, never saving a torn state; else
        re-raise."""
        if coordinator is None or not _death_noted(coordinator):
            raise error
        logging.warning("step loop: %s after a worker death; handing off",
                        error)
        flush()
        raise _HandOff(coordinator.reform_requested, step, state, torn=torn,
                       cause=error)

    def _emergency_exit(self, step, state, torn=False, cause=None):
        """checkpoint-and-exit: an emergency checkpoint at ``step``, then
        raise. With one process a plain save; with a dead peer the chief
        writes alone where the state is whole on it, else (a piece-split
        state, or one a failed step may have torn) the save is skipped and
        recorded: the last periodic checkpoint stands."""
        from autodist_tpu_torch import resilience
        with observability.span("emergency-save", step=step,
                                why="worker-death"):
            if dist.is_initialized() and dist.get_world_size() > 1:
                if torn or not _whole_on_every_rank(self._runner):
                    resilience.record_event(
                        "emergency-save",
                        f"skipped at step {step}: "
                        + ("the failed step may have torn the state" if torn
                           else "the state is split across ranks and a "
                                "peer is dead")
                        + "; the last retained checkpoint stands")
                else:
                    self._save_alone(step, state)
                    resilience.record_event(
                        "emergency-save", f"worker death: checkpoint at "
                                          f"step {step} written alone")
            else:
                self.save(step, state, force=True)
                self.wait_until_finished()
                resilience.record_event(
                    "emergency-save", f"worker death: checkpoint at step "
                                      f"{step}")
        raise RuntimeError(
            f"autodist_tpu_torch: a worker died (checkpoint-and-exit "
            f"supervision); emergency checkpoint at step {step} "
            f"(latest retained: {self.latest_step()})") from cause

    def _elastic_drain(self, step, state, coordinator, torn=False,
                       cause=None, unroll=1):
        """Elastic re-form observed by the chief's step loop: emergency-save
        when one process is left (and the state is not torn), else record
        the skipped save (after a participant died, a world of several
        processes cannot convert or barrier-save a state; the relaunch
        resumes from the last retained periodic checkpoint); then close
        this generation's goodput ledger (its segment is persisted once,
        by ``reform_now``) and hand control to ``Coordinator.reform_now``,
        which re-execs the job at the new world size. A stubbed exec
        returns, and :class:`~autodist_tpu_torch.resilience.ElasticReform`
        unwinds the caller."""
        from autodist_tpu_torch import resilience
        from autodist_tpu_torch.resilience import ElasticReform
        processes = dist.get_world_size() if dist.is_initialized() else 1
        if processes == 1 and not torn:
            with observability.span("emergency-save", step=step,
                                    why="elastic-re-form"):
                self.save(step, state, force=True)
                self.wait_until_finished()
            resilience.record_event(
                "emergency-save", f"elastic re-form: checkpoint at step "
                                  f"{step} before shrinking")
        else:
            why = ("multi-process state is not chief-recoverable after a "
                   "participant death" if processes > 1 else
                   f"the failed step after {step} may have torn the state")
            resilience.record_event(
                "emergency-save", f"skipped: {why}; re-forming from the "
                                  f"last retained checkpoint")
        if self._runner._obs is not None:
            try:
                from autodist_tpu_torch.observability import goodput
                goodput.finalize(self._runner, self._runner._obs.registry(),
                                 unroll=unroll, persist=False)
            except Exception as e:  # noqa: BLE001
                logging.debug("goodput not recorded before re-form: %s", e)
        coordinator.reform_now()
        raise ElasticReform(new_world=coordinator.world_size,
                            step=step) from cause

    def close(self):
        self.wait_until_finished()
