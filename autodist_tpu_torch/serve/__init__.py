"""Serving runtime: bucketed, continuously-batched inference.

Counterpart of ``autodist_tpu/serve``:

* :mod:`~autodist_tpu_torch.serve.buckets` — public bucket selection
  (:func:`pick_bucket`): requests route to the smallest admissible padded
  bucket, warmed up ahead of time;
* :mod:`~autodist_tpu_torch.serve.engine` — the per-replica runtimes:
  params placed once and never written, multi-replica device carving with
  least-loaded dispatch, depth-N prefetch overlap on the request path;
* :mod:`~autodist_tpu_torch.serve.server` — the continuous-batching
  :class:`Server`: ``submit() -> Future``, coalescing under a max-wait
  deadline (``AUTODIST_SERVE_MAX_WAIT_MS``), FIFO packing, exact
  per-request de-padding.

The KV-cache decode server and the autoscaler are not ported yet
(ROADMAP.md).
"""
from autodist_tpu_torch.serve.buckets import (buckets_from_env,  # noqa: F401
                                              normalize_buckets, pick_bucket)
from autodist_tpu_torch.serve.engine import (ReplicaRuntime,  # noqa: F401
                                             ServeEngine,
                                             build_replica_programs)
from autodist_tpu_torch.serve.server import Server  # noqa: F401

__all__ = ["Server", "ServeEngine", "ReplicaRuntime",
           "build_replica_programs", "pick_bucket", "normalize_buckets",
           "buckets_from_env"]
