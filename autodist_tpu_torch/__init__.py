"""autodist_tpu_torch: the PyTorch / CUDA port of ``autodist_tpu``.

The JAX package ``autodist_tpu`` is the reference; this package mirrors its
module paths and public names, and imports neither JAX nor anything of
``autodist_tpu``. Plain tensor code is PyTorch over nested dicts of tensors
with the JAX param trees' keys; every Pallas TPU kernel on a ported path is
a hand-written Hopper kernel under ``csrc/`` with a plain PyTorch version
beside it (``ops/``).

Ported so far:

* serving: ``serve.Server`` -> ``ServeEngine`` -> capture (``graph_item``)
  -> strategy (``strategy``, AllReduce) -> transform (``kernel``) ->
  placement (``remapper``) -> depth-N prefetch (``data.loader``);
* data-parallel training: :class:`AutoDist` (``capture`` ->
  ``create_distributed_session``) -> the ``torch.distributed`` world and
  rank mesh (``cluster``) -> per-variable synchronizers
  (``kernel.synchronization``, AllReduce with bucketed NCCL / gloo
  all-reduce) -> ``runner.Runner`` (``create_state``, ``step``, ``run``);

* sequence parallelism: ``strategy.SequenceParallel`` carves a ``seq``
  axis; the Runner runs the loss in the program's parallel context
  (``parallel``), where a transformer's attention is ring or Ulysses
  attention over the seq group and each rank encodes its chunk;
* tensor and expert parallelism: ``strategy.ModelParallel`` over a
  ``model`` or an ``expert`` axis (``parallel.sharding_rules``,
  ``parallel.moe``);
* pipeline parallelism: ``strategy.Pipeline`` carves a ``pipe`` axis and
  splits the stacked layers of ``ops.scan_blocks`` over it, each rank
  running its stage on the schedule of ``pipeline``;
* the input pipeline: ``data.NativeDataLoader`` (the C++ loader of
  ``data/native``, staging in pinned host memory from a ``BufferPool``),
  ``data.BlockStacker`` and ``data.DevicePrefetcher``, which
  ``Runner.run`` wires around a loader it is given;

over the model zoo (``models``) whose attention runs the flash-attention
kernels, forward and backward (``ops.flash_attention``). ``convert``
carries weights across from the JAX package. What is left is listed in
ROADMAP.md.

Entry points take ``device=`` and default to ``"cuda"``; with no CUDA device
they raise unless the caller asks for ``"cpu"``.
"""
from autodist_tpu_torch._version import __version__  # noqa: E402
from autodist_tpu_torch.autodist import AutoDist, get_default_autodist  # noqa: E402

__all__ = ["AutoDist", "get_default_autodist", "__version__"]
