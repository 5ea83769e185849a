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

Not ported yet (ROADMAP.md): ``activation_live_bytes``, ``op_provenance``
and the proto round-trip (``graphitem_pb2``).
"""
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

from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import (flatten, flatten_with_path,
                                           path_to_name, tree_map)

__all__ = ["GraphItem", "ShapeDtypeStruct", "TensorSpec", "VariableItem",
           "path_to_name"]

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


class _FlopCounter(TorchDispatchMode):
    """Sums the operations of every matmul and convolution dispatched:
    ``_eqn_flops`` of the JAX package (2 x output elements x contracted
    elements; a conv's contraction is its kernel's elements per output
    channel)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MATMUL_OPS:
            a = args[1] if func in (_aten.addmm.default,
                                    _aten.baddbmm.default) else args[0]
            self.flops += 2.0 * out.numel() * a.shape[-1]
        elif func is _aten.convolution.default:
            w = args[1]
            self.flops += 2.0 * out.numel() * w.numel() / max(1, w.shape[0])
        return out


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
                 precision=None):
        self.loss_fn = loss_fn
        self.params = params
        # A factory: list of trainable tensors -> torch.optim.Optimizer.
        self.optimizer = optimizer
        self.batch_spec = batch_spec
        self.batch_struct = batch_struct  # ShapeDtypeStruct tree of the example
        self.variables = variables or []
        self.aux_output = aux_output  # loss_fn returns (loss, aux)
        self.precision = precision  # None (as written) | "bf16" (mixed)
        self._flops_estimate = None

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
        item = cls(loss_fn, params, optimizer, batch_spec=batch_spec,
                   variables=variables, batch_struct=batch_struct,
                   aux_output=aux_output, precision=precision)
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
        """Leading (batch) dim of the captured example batch, or 0."""
        for s in flatten(self.batch_struct)[0]:
            if s.shape:
                return int(s.shape[0])
        return 0

    def flops_estimate(self):
        """Forward matmul and conv operations of one loss evaluation at the
        captured batch size: the loss runs once on ``meta`` tensors under a
        dispatch mode that counts them. Falls back to ``2 x param_elements
        x batch_size`` when nothing is counted or the loss cannot run on
        ``meta`` tensors (as the JAX package does when it cannot trace).

        Where the JAX package traces a ``lax.scan`` its body counts once;
        the port's loops (the LSTM's time steps) count every iteration.
        """
        if self._flops_estimate is not None:
            return self._flops_estimate
        fallback = 2.0 * sum(v.num_elements for v in self.variables) * \
            (self.batch_size or 1)
        self._flops_estimate = fallback
        if self.loss_fn is None or self.batch_struct is None:
            return fallback
        _, params, batch = self._meta_inputs()
        counter = _FlopCounter()
        try:
            with torch.no_grad(), counter:
                self.loss_fn(params, batch)
        except Exception as e:  # noqa: BLE001 - estimation is best-effort
            logging.debug("flops estimate failed: %s", e)
            return fallback
        self._flops_estimate = counter.flops or fallback
        return self._flops_estimate
