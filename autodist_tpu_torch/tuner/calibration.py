"""Calibration: keep the analytic cost model honest against this cluster.

Counterpart of ``autodist_tpu/tuner/calibration.py``, less the collective
micro-probe (``micro_probe``), which comes with the tuner's search
(ROADMAP.md, A12).

The cost model's bandwidth/latency constants are *seeds*.  Two refinement
paths converge on reality:

* **Measured steps** — the runner records predicted-vs-measured step time
  after every observed run (observability's ``step.latency_ms`` window);
  :meth:`Calibration.observe` folds the ratio into a bounded-history EMA
  ``scale`` that multiplies future predictions, so absolute predictions
  track this cluster even when the seeds are off by a constant factor.
* **Per-term attribution** — the step-time attribution ledger
  (``observability/attribution.py``) reconciles wall time into named
  causes and feeds :meth:`Calibration.observe_term` a measured value
  per *class*: ``compute`` (wall minus the measured/overhead terms vs
  the raw FLOPs+HBM roofline) and ``comms`` (the scheduled-HLO exposed
  collective time vs the raw sync estimate).  The per-term EMAs refine
  the global scale — the model learns WHICH term is wrong, not just a
  single fudge factor — via :attr:`compute_scale` / :attr:`comms_scale`,
  which the cost model applies per class.
* **Link overrides** — stored per-tier (bandwidth, latency) pairs that
  :meth:`Calibration.apply_link_overrides` lays over the seed links.

A persisted per-dispatch host overhead, :attr:`host_dispatch_ms`, is what
the attribution ledger's host-dispatch term reads instead of the
``DISPATCH_MS`` seed.

State persists as JSON so later processes — and later *runs* — start
from the refined constants. The step loops keep one file per card and
program (:func:`path_for`: ``<working_dir>/tuner_calibration/<key>.json``,
where the JAX package keeps one ``tuner_calibration.json`` per working
directory), so one model's runs never move another's term scales;
``AUTODIST_TUNER_CALIBRATION`` names one file that every program then
shares. The loops' load-observe-save cycles hold a lock on the file
(:meth:`Calibration.locked`), so concurrent processes do not drop each
other's updates. Every filesystem touch is fail-open: a read-only
working dir degrades to in-memory calibration.
"""
import contextlib
import fcntl
import hashlib
import json
import os
import re
import time

from autodist_tpu_torch import const
from autodist_tpu_torch.tuner.cost_model import Connectivity
from autodist_tpu_torch.utils import logging

MAX_SAMPLES = 50
EMA_ALPHA = 0.3
# Clamp the EMA scale: a single wild measurement (cold caches, CI host
# contention) must not invert every future ranking.
SCALE_BOUNDS = (0.02, 50.0)

_TIER_KEYS = {"ici": Connectivity.ICI, "local": Connectivity.LOCAL,
              "dcn": Connectivity.DCN}


def default_path(key=None):
    """``AUTODIST_TUNER_CALIBRATION`` when set; else, with ``key``
    (:func:`program_key`), ``<working_dir>/tuner_calibration/<key>.json``;
    else ``<working_dir>/tuner_calibration.json``."""
    override = const.ENV.AUTODIST_TUNER_CALIBRATION.val
    if override:
        return override
    if key:
        return os.path.join(const.DEFAULT_WORKING_DIR, "tuner_calibration",
                            f"{key}.json")
    return os.path.join(const.DEFAULT_WORKING_DIR, "tuner_calibration.json")


def program_key(runner, unroll=1):
    """``<card>-n<devices>-u<unroll>-<hash>`` of one Runner's program run
    ``unroll`` steps a dispatch: the card's name
    (``torch.cuda.get_device_name``, ``cpu`` off the card), the mesh's
    device count, and a hash of the graph item (variables, batch spec,
    batch size, optimizer), each variable's sync kind and the all-reduce
    buckets."""
    import torch
    prog = runner.program
    item = prog.graph_item
    h = hashlib.sha256()
    for v in item.variables:
        h.update(f"{v.name}|{tuple(v.shape)}|{v.dtype}\n".encode())
    for t in item.batch_spec or ():
        h.update(f"{tuple(t.shape)}|{t.dtype}\n".encode())
    h.update(f"bs={item.batch_size}|opt={item.optimizer_name}|"
             f"{sorted(runner.var_kinds.items())}|"
             f"{runner.bucket_plan()}".encode())
    device = torch.device(runner.remapper.device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    card = re.sub(r"[^A-Za-z0-9._]+", "-", card).strip("-")
    devices = max(1, int(getattr(prog.mesh, "size", 1) or 1))
    return f"{card}-n{devices}-u{max(1, int(unroll))}-{h.hexdigest()[:16]}"


def path_for(runner, unroll=1):
    """The calibration file of one Runner's program on its card."""
    return default_path(program_key(runner, unroll))


class Calibration:
    """Persisted refinement state for the cost model."""

    def __init__(self, scale=1.0, samples=None, link_overrides=None,
                 term_scales=None, host_dispatch_ms=None, last_mfu=None,
                 path=None):
        self.scale = float(scale)
        self.samples = list(samples or [])
        # {"ici": {"bandwidth": ..., "latency": ...}, ...}
        self.link_overrides = dict(link_overrides or {})
        # Per-class refinement on top of the global scale (attribution
        # feedback): {"compute": ..., "comms": ...}.
        self.term_scales = {"compute": 1.0, "comms": 1.0,
                            **(term_scales or {})}
        # Measured per-dispatch host overhead (ms); None => the cost
        # model's DISPATCH_MS seed.
        self.host_dispatch_ms = (float(host_dispatch_ms)
                                 if host_dispatch_ms else None)
        # Last run-level MFU from the goodput ledger —
        # a sanity anchor for the compute roofline: an MFU above 1 means
        # the peak table or the flops estimate is wrong, so the compute
        # scale the attribution loop is fitting cannot be trusted either.
        self.last_mfu = float(last_mfu) if last_mfu else None
        self.path = path or default_path()

    @property
    def compute_scale(self):
        """Effective multiplier for compute/update terms."""
        return self.scale * self.term_scales.get("compute", 1.0)

    @property
    def comms_scale(self):
        """Effective multiplier for collective/overlay terms."""
        return self.scale * self.term_scales.get("comms", 1.0)

    # -- persistence ---------------------------------------------------------

    @classmethod
    def load(cls, path=None):
        path = path or default_path()
        try:
            with open(path) as f:
                data = json.load(f)
            return cls(scale=data.get("scale", 1.0),
                       samples=data.get("samples", []),
                       link_overrides=data.get("link_overrides", {}),
                       term_scales=data.get("term_scales", {}),
                       host_dispatch_ms=data.get("host_dispatch_ms"),
                       last_mfu=data.get("last_mfu"),
                       path=path)
        except (OSError, ValueError):
            return cls(path=path)

    @classmethod
    @contextlib.contextmanager
    def locked(cls, path=None):
        """:meth:`load` ``path`` under an exclusive ``flock`` on
        ``<path>.lock``, held to the end of the block, so concurrent
        processes' load-observe-save cycles on one file serialize
        (fail-open: unlocked where the lock file cannot be made)."""
        path = path or default_path()
        fd = None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fd = os.open(f"{path}.lock", os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(fd, fcntl.LOCK_EX)
        except OSError as e:
            logging.debug("tuner calibration not locked: %s", e)
        try:
            yield cls.load(path)
        finally:
            if fd is not None:
                os.close(fd)  # releases the lock

    def save(self):
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = f"{self.path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": 2, "scale": round(self.scale, 6),
                           "term_scales": {k: round(v, 6) for k, v
                                           in self.term_scales.items()},
                           "host_dispatch_ms": self.host_dispatch_ms,
                           "last_mfu": self.last_mfu,
                           "samples": self.samples[-MAX_SAMPLES:],
                           "link_overrides": self.link_overrides}, f,
                          indent=1)
            os.replace(tmp, self.path)
            return self.path
        except OSError as e:
            logging.debug("tuner calibration not persisted: %s", e)
            return None

    # -- refinement ----------------------------------------------------------

    def observe(self, predicted_ms, measured_ms, context=""):
        """Fold one predicted-vs-measured pair into the scale EMA."""
        if not predicted_ms or not measured_ms or predicted_ms <= 0 \
                or measured_ms <= 0:
            return self.scale
        ratio = measured_ms / predicted_ms
        lo, hi = SCALE_BOUNDS
        new = self.scale * (1 - EMA_ALPHA) + min(hi, max(lo, ratio)) * \
            EMA_ALPHA
        self.scale = min(hi, max(lo, new))
        self.samples.append({
            "t": int(time.time()),
            "predicted_ms": round(float(predicted_ms), 4),
            "measured_ms": round(float(measured_ms), 4),
            "error_pct": round(100.0 * (predicted_ms - measured_ms)
                               / measured_ms, 2),
            "context": str(context)[:120]})
        self.samples = self.samples[-MAX_SAMPLES:]
        self.save()
        return self.scale

    def observe_term(self, term, predicted_ms, measured_ms, context=""):
        """Fold one per-class predicted-vs-measured pair into that term's
        EMA (attribution feedback; independent of the other terms).

        ``predicted_ms`` is the RAW model term — the global scale is
        factored out of the ratio, so the term scale captures only the
        per-class error on top of the common-mode correction."""
        if not predicted_ms or not measured_ms or predicted_ms <= 0 \
                or measured_ms <= 0:
            return self.term_scales.get(term, 1.0)
        ratio = measured_ms / (predicted_ms * max(1e-9, self.scale))
        lo, hi = SCALE_BOUNDS
        cur = self.term_scales.get(term, 1.0)
        new = cur * (1 - EMA_ALPHA) + min(hi, max(lo, ratio)) * EMA_ALPHA
        self.term_scales[term] = min(hi, max(lo, new))
        self.samples.append({
            "t": int(time.time()),
            "term": str(term),
            "predicted_ms": round(float(predicted_ms), 4),
            "measured_ms": round(float(measured_ms), 4),
            "error_pct": round(100.0 * (predicted_ms - measured_ms)
                               / measured_ms, 2),
            "context": str(context)[:120]})
        self.samples = self.samples[-MAX_SAMPLES:]
        self.save()
        return self.term_scales[term]

    def note_mfu(self, mfu, context=""):
        """Record the goodput ledger's run-level MFU as a calibration
        sanity input (persisted as ``last_mfu``).  MFU > 1 is physically
        impossible — it means the peak-flops table (or the flops
        estimate) is wrong, and the compute roofline every ``compute``
        term observation is fit against shares the same inputs, so the
        warning names both."""
        if mfu is None or mfu <= 0:
            return self.last_mfu
        self.last_mfu = round(float(mfu), 6)
        if self.last_mfu > 1.0:
            logging.warning(
                "goodput MFU %.3f > 1 (%s): the peak-flops table "
                "(AUTODIST_PEAK_TFLOPS) or GraphItem.flops_estimate is "
                "wrong — per-term compute calibration shares these inputs "
                "and should not be trusted until they are fixed",
                self.last_mfu, context)
        self.save()
        return self.last_mfu

    def scope_scales(self):
        """Per-scope refinement ratios from the per-layer profiler's
        ``profile:<scope>`` samples (``observability/profile.py``
        ``feed_calibration``): ``{scope: {"compute": r, "comms": r}}``.

        Only REAL measured data produces these samples (the profiler
        feeds scheduled-HLO measurements, never model-vs-itself), so a
        scope key here means the automap searcher can price that layer
        with its own measured-vs-predicted ratio.  Ratios are EMA-folded
        in sample order with the same bounds the class scales use, and
        the global scale is factored out (samples record raw-model
        predictions) — scope scales compose ON TOP of
        ``compute_scale``/``comms_scale``, they do not replace them.
        """
        out = {}
        for s in self.samples:
            ctx = str(s.get("context", ""))
            term = s.get("term")
            if not ctx.startswith("profile:") or term not in ("compute",
                                                              "comms"):
                continue
            scope = ctx[len("profile:"):]
            pred, meas = s.get("predicted_ms"), s.get("measured_ms")
            if not pred or not meas or pred <= 0 or meas <= 0:
                continue
            lo, hi = SCALE_BOUNDS
            ratio = min(hi, max(lo, meas / (pred * max(1e-9, self.scale))))
            row = out.setdefault(scope, {})
            cur = row.get(term, 1.0)
            row[term] = min(hi, max(lo, cur * (1 - EMA_ALPHA) +
                                    ratio * EMA_ALPHA))
        return out

    def apply_link_overrides(self, links):
        """Overlay stored per-tier (bandwidth, latency) onto seed links."""
        out = dict(links)
        for key, tier in _TIER_KEYS.items():
            ov = self.link_overrides.get(key)
            if not ov:
                continue
            bw, lat = out.get(tier, (None, None))
            out[tier] = (float(ov.get("bandwidth", bw)),
                         float(ov.get("latency", lat)))
        return out

    def prediction_error_pct(self):
        """Signed error of the most recent sample (None if no samples)."""
        return self.samples[-1]["error_pct"] if self.samples else None
