"""Named scopes: the counterpart of ``jax.named_scope``.

``with named_scope("layer0"):`` pushes a name onto a thread-local stack
and pops it on exit; :func:`current_scope` is the ``/``-joined stack
(``"layer0/attn"``). ``GraphItem.op_provenance`` reads the stack at every
op it records. Under ``AUTODIST_TRACE=profiler`` the scope also opens a
``torch.profiler.record_function`` named ``scope:<path>``, the bridge
the per-layer profile (``observability/profile.py``) follows kernels
through; otherwise nothing else happens. Either way there is no device
work, so a forward with scopes computes the same bits as one without,
and a replayed CUDA graph (which runs no Python) is unchanged.
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
    annotation = None
    try:
        from autodist_tpu_torch.observability import tracing
        if tracing._mode() == "profiler":
            import torch
            annotation = torch.profiler.record_function(
                "scope:" + "/".join(names))
            annotation.__enter__()
    except Exception:  # noqa: BLE001 - a scope never fails the forward
        annotation = None
    try:
        yield
    finally:
        if annotation is not None:
            annotation.__exit__(None, None, None)
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
