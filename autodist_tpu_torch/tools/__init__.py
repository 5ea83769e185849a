"""Offline operator tooling (no torch import required).

* :mod:`~autodist_tpu_torch.tools.timeline` — the merged cluster
  timeline: every rank's Chrome trace, flight log and the chief's skew
  summary rebased onto the chief's clock in one Perfetto file
  (``python -m autodist_tpu_torch.tools.timeline <logdir>``).

Not ported yet (ROADMAP.md): ``tools/trend.py``, which tracks the JAX
benchmark's history files; it comes with the port's own benchmark (A2).
"""
