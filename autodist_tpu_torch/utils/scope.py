"""Named scopes: the counterpart of ``jax.named_scope``.

``with named_scope("layer0"):`` pushes a name onto a thread-local stack
and pops it on exit; :func:`current_scope` is the ``/``-joined stack
(``"layer0/attn"``). Nothing else happens: no ``record_function``, no
device work, so a forward with scopes computes the same bits as one
without, and a replayed CUDA graph (which runs no Python) is unchanged.
``GraphItem.op_provenance`` reads the stack at every op it records.
"""
import contextlib
import threading

_stack = threading.local()


def _names():
    names = getattr(_stack, "names", None)
    if names is None:
        names = _stack.names = []
    return names


@contextlib.contextmanager
def named_scope(name):
    """Run the body under scope ``name`` (nested inside the current one)."""
    names = _names()
    names.append(str(name))
    try:
        yield
    finally:
        names.pop()


def current_scope():
    """The ``/``-joined path of the open scopes, ``""`` outside any."""
    return "/".join(_names())


def einsum(spec, *operands):
    """``torch.einsum`` under a scope named after its ``spec``: the JAX
    package's ``jnp.einsum`` puts its spec on the name stack of the
    product it traces (``"layer0/attn/bhqd,bhkd->bhqk"``), so the
    per-scope costs of the two packages key the product alike."""
    import torch
    with named_scope(spec):
        return torch.einsum(spec, *operands)
