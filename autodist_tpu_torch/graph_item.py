"""GraphItem: the captured program and its per-variable metadata.

Counterpart of ``autodist_tpu/graph_item.py``. The captured function is an
``apply_fn(params, batch)`` (or a loss) over nested dicts of tensors; the
metadata strategy builders read is the same: per-variable name (the
'/'-joined key path), shape, dtype, ``trainable`` and ``sparse_access``.

Sparse-access detection runs ``apply_fn`` once on ``meta`` tensors (shapes
only: nothing is computed, no kernel launches) under a
``TorchDispatchMode`` that records which parameter is the table operand of
``aten.embedding`` / ``aten.index_select`` / advanced indexing — the
counterpart of the JAX package's scan for ``gather`` on a parameter.

``precision="bf16"`` wraps the loss in the JAX package's mixed-precision
policy, and ``flops_estimate`` counts the forward's matmul and conv
operations, both as in the JAX package (``graph_item.py:85-127,426-455``).

Per-scope costs (``graph_item.py:457-570`` there): the loss runs once on
``meta`` tensors under a dispatch mode that records every aten op with
the :func:`~autodist_tpu_torch.utils.scope.named_scope` path it ran under
(:meth:`GraphItem.op_provenance`, summed per scope by
:meth:`GraphItem.scope_costs`), and the same trace gives the last-use
live-set peak of :meth:`GraphItem.activation_live_bytes`. Where the JAX
package's provenance is jaxpr equations, the port's is aten ops: the
FLOPs agree per scope, the op counts and bytes do not (ROADMAP.md, Queue
C). :meth:`GraphItem.to_proto` / :meth:`GraphItem.deserialize` write and
read the JAX package's ``GraphItem`` proto (``proto/graphitem_pb2.py``, a
byte-identical copy), dtypes under the JAX names.
"""
import re

import numpy as np
import torch
# A TorchDispatchMode's first use imports torch._dynamo, and that import
# leaves a frame that refers to itself (``torch.fx.wrap`` keeps
# ``inspect.currentframe()`` in a local) and, through ``f_back``, to every
# frame that called it: the first capture of a process and the runner its
# caller goes on to build would stay alive until the cyclic collector ran,
# and on the card with them the runner's CUDA graph pools. Imported here,
# the chain holds only module frames.
import torch._dynamo  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode

from autodist_tpu_torch.proto import graphitem_pb2
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.scope import current_scope
from autodist_tpu_torch.utils.tree import (flatten, flatten_with_path,
                                           path_to_name, tree_map)

__all__ = ["GraphItem", "ShapeDtypeStruct", "TensorSpec", "UNATTRIBUTED",
           "VariableItem", "path_to_name", "scope_path"]

_GATHER_OPS = (torch.ops.aten.embedding.default,
               torch.ops.aten.index_select.default,
               torch.ops.aten.index.Tensor)
_aten = torch.ops.aten
# Matmul-like ops as they reach the dispatcher (``@``, ``einsum`` and
# ``F.linear`` decompose into these).
_MATMUL_OPS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
               _aten.baddbmm.default)


def _shape(leaf):
    return tuple(int(s) for s in (leaf.shape if isinstance(leaf, torch.Tensor)
                                  else np.shape(leaf)))


def _np_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


class ShapeDtypeStruct:
    """Shape and numpy dtype of one example-batch leaf."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def __repr__(self):
        return f"ShapeDtypeStruct({self.shape}, {self.dtype})"


class TensorSpec:
    """Shape/dtype spec; dim value ``None`` marks the polymorphic batch dim."""

    def __init__(self, shape, dtype, name=""):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.name = name

    def __repr__(self):
        return f"TensorSpec({self.name}, {self.shape}, {self.dtype})"


class VariableItem:
    """Per-variable metadata consumed by strategy builders."""

    def __init__(self, name, shape, dtype, trainable=True, sparse_access=False):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype  # torch.dtype
        self.trainable = trainable
        self.sparse_access = sparse_access

    @property
    def num_elements(self):
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def size_bytes(self):
        return self.num_elements * self.dtype.itemsize

    def __repr__(self):
        return (f"VariableItem({self.name}, {self.shape}, {self.dtype}, "
                f"sparse={self.sparse_access})")


class _GatherRecorder(TorchDispatchMode):
    def __init__(self, watched):
        super().__init__()
        self.watched = watched  # id(tensor) -> variable index
        self.hits = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _GATHER_OPS and args and id(args[0]) in self.watched:
            self.hits.add(self.watched[id(args[0])])
        return func(*args, **(kwargs or {}))


def _op_flops(func, args, out):
    """Operations of ONE dispatched op: ``_eqn_flops`` of the JAX package
    (2 x output elements x contracted elements for a matmul; a conv's
    contraction is its kernel's elements per output channel), 0.0 for
    everything else."""
    if func in _MATMUL_OPS:
        a = args[1] if func in (_aten.addmm.default,
                                _aten.baddbmm.default) else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if func is _aten.convolution.default:
        w = args[1]
        return 2.0 * out.numel() * w.numel() / max(1, w.shape[0])
    return 0.0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class _OpRecorder(TorchDispatchMode):
    """Records every dispatched op in order: its overload, the scope open
    at dispatch, :func:`_op_flops`, the bytes of the outputs it allocates
    (an output that aliases an input, a view's or an in-place op's,
    allocates nothing), and what :func:`_live_set_peak_bytes` needs: the
    ids of its tensor inputs and of its allocated outputs, each aliasing
    output mapped to the tensor whose storage it shares. Every tensor it
    sees is kept, so no ``id()`` is reused during the run."""

    def __init__(self):
        super().__init__()
        self.records = []
        self.ops = []        # (input ids, [(output id, bytes)]) per op
        self.root = {}       # id of an aliasing output -> id of its storage
        self._keep = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        self._keep.extend(ins + outs)
        base = None
        aliasing = any(r.alias_info is not None for r in func._schema.returns)
        if aliasing:
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is not None:
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    if isinstance(v, torch.Tensor):
                        base = self.root.get(id(v), id(v))
                    break
        made = []
        for t in outs:
            if base is not None:
                self.root[id(t)] = base
            else:
                made.append((id(t), float(t.numel()) * t.element_size()))
        self.ops.append(([self.root.get(id(t), id(t)) for t in ins], made))
        self.records.append({
            "eqn": len(self.records), "prim": str(func),
            "scope": current_scope(), "flops": _op_flops(func, args, out),
            "bytes": sum(b for _, b in made)})
        return out


def _live_set_peak_bytes(ops, outputs):
    """Peak live bytes of a linear last-use walk over the recorded ops
    (``_live_set_peak_bytes`` of the JAX package over the aten trace).

    Every allocated output stays live from the op that produces it until
    the last op that reads it, or reads a view of it, retires; the
    program's ``outputs`` (their storages' ids: the loss, an aux output)
    stay live through the end. Inputs (parameters and the batch) are never
    produced by an op and so never count."""
    n = len(ops)
    sizes, last_use = {}, {}
    for i, (_, made) in enumerate(ops):
        for vid, size in made:
            sizes[vid] = size
            last_use[vid] = i
    for i, (ins, _) in enumerate(ops):
        for vid in ins:
            if vid in last_use:
                last_use[vid] = max(last_use[vid], i)
    for vid in outputs:
        if vid in last_use:
            last_use[vid] = n
    frees = {}
    for vid, idx in last_use.items():
        frees.setdefault(idx, []).append(vid)
    live = peak = 0.0
    for i, (_, made) in enumerate(ops):
        for vid, size in made:
            live += size
        peak = max(peak, live)
        for vid in frees.get(i, ()):
            live -= sizes[vid]
    return peak


# Scope bucket for ops that carry no usable scope: the per-layer profiler
# and the automap walker put every op in some bucket (costs may be
# unattributed, never dropped).
UNATTRIBUTED = "(unattributed)"

# Transform frames a JAX name stack wraps around user scopes (`jvp(layer0)`,
# `transpose(jvp(layer0))`, ...): the scope is the payload. `jit(...)` /
# `pjit(...)` frames carry function names, not scopes, and are dropped.
_SCOPE_WRAP_RE = re.compile(
    r"\b(?:jvp|vjp|transpose|vmap|pmap|remat|checkpoint|custom_jvp|"
    r"custom_vjp|scan|while|cond)\(([^()]*)\)")


def scope_path(name_stack_text):
    """Normalize a name stack or an HLO ``op_name`` into the user's scope
    path (``"layer0/attn"``): transform frames unwrapped, ``jit`` frames
    dropped (``autodist_tpu/graph_item.py:242``). ``""`` when no user scope
    survives: the profiler's unattributed signal."""
    if not name_stack_text:
        return ""
    try:
        text = str(name_stack_text)
    except Exception:  # noqa: BLE001 - an unprintable stack is unattributed
        return ""
    # Unwrap before splitting: a scope may itself hold "/" ("stage0/
    # block1") and a wrapper encloses it whole. Innermost-out, to fixpoint.
    prev = None
    while prev != text:
        prev = text
        text = _SCOPE_WRAP_RE.sub(r"\1", text)
    segments = []
    for seg in text.split("/"):
        seg = seg.strip()
        if not seg or "(" in seg or ")" in seg:
            continue
        segments.append(seg)
    return "/".join(segments)


def _dtype_name(dtype):
    """A torch or numpy dtype under the JAX package's name (``"float32"``,
    ``"bfloat16"``); ``getattr(torch, name)`` reads it back."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _bf16_compute(loss_fn, aux_output):
    """Mixed-precision policy: bf16 compute, f32 master weights and loss.

    Only float32 tensor leaves of params and batch are cast (ints and
    bools untouched). The cast is part of the autograd graph, so its
    backward casts the gradients back to f32: gradients, optimizer state
    and the stored parameters never leave f32."""
    def down(x):
        return x.to(torch.bfloat16) if isinstance(x, torch.Tensor) and \
            x.dtype == torch.float32 else x

    def wrapped(params, batch):
        out = loss_fn(tree_map(down, params), tree_map(down, batch))
        if aux_output:
            loss, aux = out
            return loss.float(), tree_map(
                lambda a: a.float() if isinstance(a, torch.Tensor) and
                a.dtype == torch.bfloat16 else a, aux)
        return out.float()
    return wrapped


class GraphItem:
    """Captured program + metadata. Construct via :meth:`capture`."""

    def __init__(self, loss_fn, params, optimizer=None, batch_spec=None,
                 variables=None, batch_struct=None, aux_output=False,
                 precision=None, optimizer_name=""):
        self.loss_fn = loss_fn
        self.params = params
        # A factory: list of trainable tensors -> torch.optim.Optimizer.
        self.optimizer = optimizer
        self.optimizer_name = optimizer_name
        self.batch_spec = batch_spec
        self.batch_struct = batch_struct  # ShapeDtypeStruct tree of the example
        self.variables = variables or []
        self.aux_output = aux_output  # loss_fn returns (loss, aux)
        self.precision = precision  # None (as written) | "bf16" (mixed)
        self._flops_estimate = None
        self._trace = None  # (records, peak live bytes, error) of a forward

    @classmethod
    def capture(cls, loss_fn, params, optimizer=None, example_batch=None,
                sparse_params=(), non_trainable=(), aux_output=False,
                precision=None):
        """Build a GraphItem from a single-device function
        ``loss_fn(params, batch)``.

        Args:
            loss_fn: ``(params, batch) -> loss`` (or ``(loss, aux)`` with
                ``aux_output=True``).
            params: nested dict of tensors.
            optimizer: a factory taking the list of trainable tensors and
                returning a ``torch.optim.Optimizer`` (for example
                ``functools.partial(torch.optim.SGD, lr=0.1)``); None for a
                forward-only capture (serving).
            example_batch: example batch tree; dim 0 is the batch dimension.
            sparse_params: name substrings force-marked as sparse-access.
            non_trainable: name substrings marked non-trainable.
            precision: ``"bf16"`` wraps the loss: float32 tensor leaves of
                params and batch are cast to bfloat16 at the loss boundary
                and the loss (and aux) come back float32, while master
                weights, gradients and optimizer state stay float32. bf16
                keeps f32's exponent range, so no loss scaling is needed.
        """
        if precision not in (None, "bf16"):
            raise ValueError(f"precision must be None or 'bf16', got "
                             f"{precision!r}")
        pairs, _ = flatten_with_path(params)
        variables = []
        for path, leaf in pairs:
            name = path_to_name(path)
            variables.append(VariableItem(
                name, _shape(leaf), leaf.dtype,
                trainable=not any(s in name for s in non_trainable)))
        batch_spec = batch_struct = None
        if example_batch is not None:
            bpairs, _ = flatten_with_path(example_batch)
            batch_spec = [TensorSpec((None,) + _shape(l)[1:] if _shape(l)
                                     else (), _np_dtype(l), path_to_name(p))
                          for p, l in bpairs]
            batch_struct = tree_map(
                lambda l: ShapeDtypeStruct(_shape(l), _np_dtype(l)),
                example_batch)
        # The optimizer's name as the JAX package takes it; a
        # functools.partial factory gives its function's.
        opt_name = "" if optimizer is None else (
            getattr(getattr(optimizer, "func", optimizer), "__name__", "")
            or type(optimizer).__name__)
        item = cls(loss_fn, params, optimizer, batch_spec=batch_spec,
                   variables=variables, batch_struct=batch_struct,
                   aux_output=aux_output, precision=precision,
                   optimizer_name=opt_name)
        if example_batch is not None:
            # On the unwrapped program, as the JAX package does: there the
            # bf16 cast would hide the table operand of each lookup.
            item._detect_sparse_access()
        for v in item.variables:
            if any(s in v.name for s in sparse_params):
                v.sparse_access = True
        if precision == "bf16":
            item.loss_fn = _bf16_compute(loss_fn, aux_output)
        return item

    def _meta_inputs(self):
        """(params, batch) as ``meta`` tensors of the captured shapes and
        dtypes: running the loss on them computes nothing."""
        pairs, _ = flatten_with_path(self.params)
        meta_params = [torch.empty(_shape(l), dtype=l.dtype, device="meta")
                       for _, l in pairs]
        it = iter(meta_params)
        params = tree_map(lambda _: next(it), self.params)
        batch = tree_map(lambda s: torch.empty(
            s.shape, dtype=_torch_dtype(s.dtype), device="meta"),
            self.batch_struct)
        return meta_params, params, batch

    def _detect_sparse_access(self):
        """Mark parameters read through a row gather as sparse-access."""
        meta_params, params, batch = self._meta_inputs()
        watched = {id(t): i for i, t in enumerate(meta_params)}
        recorder = _GatherRecorder(watched)
        try:
            with torch.no_grad(), recorder:
                self.loss_fn(params, batch)
        except Exception as e:  # noqa: BLE001 - detection is best-effort
            logging.debug("sparse-access detection skipped: %s", e)
            return
        for i in sorted(recorder.hits):
            self.variables[i].sparse_access = True
            logging.debug("detected sparse access: %s", self.variables[i].name)

    # -- queries -------------------------------------------------------------

    @property
    def trainable_variables(self):
        return [v for v in self.variables if v.trainable]

    def var_by_name(self, name):
        for v in self.variables:
            if v.name == name:
                return v
        raise KeyError(name)

    @property
    def total_bytes(self):
        return sum(v.size_bytes for v in self.variables)

    @property
    def batch_size(self):
        """Leading (batch) dim of the captured example batch (of the batch
        spec for a metadata-only item), or 0."""
        for s in flatten(self.batch_struct)[0]:
            if s.shape:
                return int(s.shape[0])
        for t in (self.batch_spec or []):
            if t.shape:
                return 0 if t.shape[0] is None else int(t.shape[0])
        return 0

    def flops_estimate(self):
        """Forward matmul and conv operations of one loss evaluation at the
        captured batch size: the sum of :meth:`op_provenance`'s ``flops``
        in dispatch order. Falls back to ``2 x param_elements x
        batch_size`` when nothing is counted or the loss cannot run on
        ``meta`` tensors (as the JAX package does when it cannot trace).

        Where the JAX package traces a ``lax.scan`` its body counts once;
        the port's loops (the LSTM's time steps, the stacked layers) count
        every iteration.
        """
        if self._flops_estimate is None:
            fallback = 2.0 * sum(v.num_elements for v in self.variables) * \
                (self.batch_size or 1)
            total = 0.0
            for rec in self.op_provenance():
                total += rec["flops"]
            self._flops_estimate = total or fallback
        return self._flops_estimate

    def _traced(self):
        """(records, peak live bytes, error) of one forward on ``meta``
        tensors under :class:`_OpRecorder`; ``([], 0.0, why)`` for a
        metadata-only item or a loss that cannot run on ``meta``."""
        if self._trace is not None:
            return self._trace
        if self.loss_fn is None or self.batch_struct is None:
            self._trace = ([], 0.0, "no program")
            return self._trace
        _, params, batch = self._meta_inputs()
        recorder = _OpRecorder()
        try:
            with torch.no_grad(), recorder:
                out = self.loss_fn(params, batch)
        except Exception as e:  # noqa: BLE001 - provenance is best-effort
            logging.debug("op provenance unavailable: %s", e)
            self._trace = ([], 0.0, str(e))
            return self._trace
        outputs = {recorder.root.get(id(t), id(t)) for t in _tensors(out)}
        self._trace = (recorder.records,
                       _live_set_peak_bytes(recorder.ops, outputs), "")
        return self._trace

    def op_provenance(self):
        """Per-op provenance of the captured forward:
        ``[{"eqn", "prim", "scope", "flops", "bytes"}]`` in dispatch order.

        The loss runs once on ``meta`` tensors (nothing is computed) under
        a dispatch mode that sees every aten op: ``prim`` is the overload
        (``"aten.addmm.default"``), ``scope`` the :func:`named_scope` path
        open at dispatch (``""`` outside any), ``flops`` the rule of
        :meth:`flops_estimate` (the two share :func:`_op_flops`, so the
        records sum to the estimate exactly) and ``bytes`` the outputs the
        op allocates (a view or an in-place op allocates nothing: 0). The
        JAX package records jaxpr equations; its scope paths are the same.
        On ``meta`` the attention takes the flash kernel's plain version
        (``ops/flash_attention.py``), as the JAX package's hook runs its
        dense reference off the TPU. ``[]`` for a metadata-only item."""
        return self._traced()[0]

    def scope_costs(self):
        """:meth:`op_provenance` summed per scope: ``{scope: {"flops",
        "bytes", "ops"}}`` (the ``""`` key holds the scope-less ops)."""
        out = {}
        for rec in self.op_provenance():
            agg = out.setdefault(rec["scope"],
                                 {"flops": 0.0, "bytes": 0.0, "ops": 0})
            agg["flops"] += rec["flops"]
            agg["bytes"] += rec["bytes"]
            agg["ops"] += 1
        return out

    def activation_live_bytes(self):
        """Peak live activation bytes of one forward at the captured batch
        size: the JAX package's linear last-use live-set scan over the
        same trace as :meth:`op_provenance`. An op's allocated outputs
        stay live until the last op that reads them or a view of them;
        the loss (and an aux output) stay live to the end; parameters and
        the batch are excluded (the memory ledger's params and staging
        classes own them). The attention counts as its plain version runs
        (see :meth:`op_provenance`): with its (b, h, s, s) scores, which
        the flash kernel on the card never writes. ``0.0`` for a
        metadata-only item."""
        return self._traced()[1]

    @property
    def jaxpr_text(self):
        """The op trace as text, one op a line: what the JAX package's
        ``jaxpr_text`` holds for its program (the proto's field name)."""
        records, _, error = self._traced()
        if error:
            return f"<untraceable: {error}>"
        return "\n".join(f"{r['eqn']} {r['prim']} scope={r['scope'] or '-'} "
                         f"flops={r['flops']:g} bytes={r['bytes']:g}"
                         for r in records)

    # -- serialization -------------------------------------------------------

    def to_proto(self, include_jaxpr=False):
        """The JAX package's ``GraphItem`` proto: dtypes under the JAX
        names (``"float32"``, ``"bfloat16"``, ``"int32"``), and with
        ``include_jaxpr`` the op trace in ``jaxpr_text``."""
        pb = graphitem_pb2.GraphItem(optimizer_name=self.optimizer_name)
        for v in self.variables:
            pb.variables.append(graphitem_pb2.VariableItem(
                name=v.name, shape=list(v.shape), dtype=_dtype_name(v.dtype),
                trainable=v.trainable, sparse_access=v.sparse_access,
                size_bytes=v.size_bytes))
        for t in (self.batch_spec or []):
            pb.batch_spec.append(graphitem_pb2.TensorSpecProto(
                name=t.name, shape=[-1 if s is None else s for s in t.shape],
                dtype=_dtype_name(t.dtype)))
        if include_jaxpr:
            pb.jaxpr_text = self.jaxpr_text
        return pb

    def serialize(self, path):
        with open(path, "wb") as f:
            f.write(self.to_proto().SerializeToString())

    @classmethod
    def metadata_from_proto(cls, pb):
        """Rebuild the metadata (not the function) of a serialized item."""
        variables = [VariableItem(v.name, tuple(v.shape),
                                  getattr(torch, v.dtype), v.trainable,
                                  v.sparse_access)
                     for v in pb.variables]
        batch_spec = [TensorSpec(tuple(None if s == -1 else s
                                       for s in t.shape), t.dtype, t.name)
                      for t in pb.batch_spec]
        return cls(loss_fn=None, params=None, optimizer=None,
                   batch_spec=batch_spec or None, variables=variables,
                   optimizer_name=pb.optimizer_name)

    @classmethod
    def deserialize(cls, path):
        pb = graphitem_pb2.GraphItem()
        with open(path, "rb") as f:
            pb.ParseFromString(f.read())
        return cls.metadata_from_proto(pb)
