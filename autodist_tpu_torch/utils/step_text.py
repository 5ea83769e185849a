"""One whole training step as text, one op a line: the port's counterpart
of the compiled step's HLO text.

The JAX package hands ``report.render_report`` the text of its AOT-compiled
step (``Runner._aot_executable(batch).as_text()``); its collective table,
``replica_group_sizes`` and ``einsum_result_lead_dims`` read that text.
PyTorch compiles nothing, so :func:`record` runs the step itself once on
``meta`` tensors (nothing is computed) under a dispatch mode that writes a
line for every aten op it dispatches, the backward and the optimizer's
update included::

    %12 = bf16[32,12,128,128] aten.bmm.default(%10, %11), phase=forward, op_name="layer0/attn/bhqd,bhkd->bhqk"

``op_name`` is the :func:`~autodist_tpu_torch.utils.scope.named_scope`
path open at dispatch (an einsum's spec is its innermost name, as in the
JAX package's op metadata) and ``phase`` the part of the step
(``forward``, ``backward``, ``grad-sync``, ``update``, ``metrics``) the
Runner had open (:func:`phase`). A collective is recorded, never run: while
the text is recorded ``torch.distributed``'s collectives on this thread
write a line under the JAX name of their kind (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``, and
``collective-permute`` for a hop, an all-to-all with one peer) with the
group in HLO's iota form, ``replica_groups=[G,S]<=[N]`` (S ranks a group,
G groups, N in the world), and return at once::

    %40 = f32[1024] all-reduce(%39), replica_groups=[1,2]<=[2], phase=grad-sync, op_name=""

so a chief that writes the text alone cannot hang its world. A
hand-written kernel is one ``custom-call`` line whichever route would run
it (``ops/flash_attention.py`` asks :func:`active`)::

    %9 = (f32[...], f32[...], bf16[...]) custom-call(%6, %7, %8), custom_call_target="flash_fwd", ...

The text holds no address or device: one program and batch shape give the
same text on the CPU and on the card. Names are ``%p.<variable>`` for the
params at their stored layout, ``%b.<i>`` for the batch's leaves and
``%<n>`` for op results in order; an in-place op's result keeps its
input's name.
"""
import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from autodist_tpu_torch.utils.scope import current_scope

_tls = threading.local()

# HLO's element type names.
_DTYPES = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64"}

_NULL = contextlib.nullcontext()


def active():
    """The :class:`StepRecorder` recording on this thread, else ``None``."""
    return getattr(_tls, "recorder", None)


def phase(name):
    """Context manager: mark the ops of its body as the step's ``name``
    part. A shared no-op unless a recorder is active on this thread."""
    rec = active()
    if rec is None:
        return _NULL
    return rec.phase(name)


def _shape(t):
    return (f"{_DTYPES.get(t.dtype, str(t.dtype).split('.')[-1])}"
            f"[{','.join(str(int(d)) for d in t.shape)}]")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _attr(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    return str(v)


class _Work:
    """What an ``async_op=True`` collective returns while recording."""

    def wait(self, timeout=None):
        return True

    def is_completed(self):
        return True


class StepRecorder(TorchDispatchMode):
    """Writes one line for each dispatched op (see the module docstring).
    Every tensor it names is kept, so no ``id()`` is reused."""

    def __init__(self):
        super().__init__()
        self.lines = []
        self._names = {}
        self._keep = []
        self._phase = ""
        self._count = 0
        self._quiet = 0

    # -- names ---------------------------------------------------------------

    def name(self, t, name):
        """Give tensor ``t`` the name ``%<name>``."""
        self._names[id(t)] = "%" + name
        self._keep.append(t)

    def _ref(self, t):
        ref = self._names.get(id(t))
        if ref is None:  # a tensor made outside the step (a constant)
            ref = self._new(t)
        return ref

    def _new(self, t):
        ref = f"%{self._count}"
        self._count += 1
        self._names[id(t)] = ref
        self._keep.append(t)
        return ref

    # -- lines ---------------------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name):
        before, self._phase = self._phase, name
        try:
            yield
        finally:
            self._phase = before

    @contextlib.contextmanager
    def quiet(self):
        """Ops of the body write no line (a kernel's stand-in outputs)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def emit(self, op, inputs, outputs, **attrs):
        """Append the line of ``op`` reading ``inputs`` and producing
        ``outputs`` (tensors); ``attrs`` go before ``phase`` / ``op_name``
        in order."""
        ins = ", ".join(self._ref(t) for t in inputs)
        if len(outputs) == 1:
            t = outputs[0]
            lhs = self._names.get(id(t)) if any(t is i for i in inputs) \
                else None
            lhs = lhs or self._new(t)
            result = _shape(t)
        else:
            lhs = f"%{self._count}"
            self._count += 1
            for t in outputs:
                if not any(t is i for i in inputs):
                    self._new(t)
            result = "(" + ", ".join(_shape(t) for t in outputs) + ")"
        extra = "".join(f", {k}={_attr(v)}" for k, v in attrs.items())
        self.lines.append(
            f"{lhs} = {result} {op}({ins}){extra}, phase={self._phase or '-'}"
            f", op_name=\"{current_scope()}\"")

    def custom_call(self, target, inputs, outputs, **attrs):
        """One line for a hand-written kernel's call: ``outputs`` are
        ``(shape, dtype)`` pairs, made on ``meta`` and returned."""
        with self.quiet():
            outs = [torch.empty(shape, dtype=dtype, device="meta")
                    for shape, dtype in outputs]
        self.emit("custom-call", inputs, outs,
                  custom_call_target=f"\"{target}\"", **attrs)
        return outs

    def collective(self, kind, inputs, outputs, group, **attrs):
        """One line for a collective over ``group`` (recorded, not run)."""
        import torch.distributed as dist
        world = dist.get_world_size()
        size = dist.get_world_size(group) if group is not None else world
        self.emit(kind, inputs, outputs,
                  replica_groups=f"[{world // max(1, size)},{size}]<=[{world}]",
                  **attrs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            self.emit(str(func), _tensors(args) + _tensors(kwargs),
                      _tensors(out))
        return out

    def text(self):
        return "\n".join(self.lines) + "\n"


# -- collectives recorded, not run -------------------------------------------

def _all_reduce(tensor, op=None, group=None, async_op=False):
    active().collective("all-reduce", [tensor], [tensor], group)
    return _Work() if async_op else None


def _all_gather_into_tensor(output_tensor, input_tensor, group=None,
                            async_op=False):
    active().collective("all-gather", [input_tensor], [output_tensor], group)
    return _Work() if async_op else None


def _reduce_scatter_tensor(output, input, op=None, group=None,
                           async_op=False):
    active().collective("reduce-scatter", [input], [output], group)
    return _Work() if async_op else None


def _all_to_all_single(output, input, output_split_sizes=None,
                       input_split_sizes=None, group=None, async_op=False):
    # A hop sends to one peer and receives from one: XLA's permute.
    hop = (output_split_sizes is not None and input_split_sizes is not None
           and sum(1 for s in output_split_sizes if s) <= 1
           and sum(1 for s in input_split_sizes if s) <= 1)
    active().collective("collective-permute" if hop else "all-to-all",
                        [input], [output], group)
    return _Work() if async_op else None


def _broadcast(tensor, src=None, group=None, async_op=False, **kwargs):
    active().collective("broadcast", [tensor], [tensor], group)
    return _Work() if async_op else None


_RECORDED = {"all_reduce": _all_reduce,
             "all_gather_into_tensor": _all_gather_into_tensor,
             "reduce_scatter_tensor": _reduce_scatter_tensor,
             "all_to_all_single": _all_to_all_single,
             "broadcast": _broadcast}
_patch_lock = threading.Lock()
_patch_depth = 0
_originals = {}


def _dispatching(name):
    """``torch.distributed.<name>`` while recording: this thread's
    recorder takes the call, any other thread's call runs as before."""
    original = _originals[name]
    recorded = _RECORDED[name]

    def call(*args, **kwargs):
        if active() is not None:
            return recorded(*args, **kwargs)
        return original(*args, **kwargs)
    call.__wrapped__ = original
    return call


@contextlib.contextmanager
def _collectives_recorded():
    global _patch_depth
    import torch.distributed as dist
    with _patch_lock:
        if _patch_depth == 0:
            for name in _RECORDED:
                _originals[name] = getattr(dist, name)
            for name in _RECORDED:
                setattr(dist, name, _dispatching(name))
        _patch_depth += 1
    try:
        yield
    finally:
        with _patch_lock:
            _patch_depth -= 1
            if _patch_depth == 0:
                for name, fn in _originals.items():
                    setattr(dist, name, fn)
                _originals.clear()


@contextlib.contextmanager
def record():
    """Record the body's ops and collectives on this thread; yields the
    :class:`StepRecorder` (its :meth:`~StepRecorder.text` afterwards)."""
    if active() is not None:
        raise RuntimeError("autodist_tpu_torch: a step text is already "
                           "being recorded on this thread")
    rec = StepRecorder()
    with _collectives_recorded():
        _tls.recorder = rec
        try:
            with rec:
                yield rec
        finally:
            _tls.recorder = None
