"""Mesh-axis names and the typed environment knobs the port reads.

Counterpart of ``autodist_tpu/const.py``: the same axis names and, for the
knobs kept here, the same variable names, types and defaults, so one
environment configures both packages.
"""
import enum
import os
import tempfile

DEFAULT_WORKING_DIR = os.environ.get(
    "AUTODIST_WORKING_DIR", os.path.join(tempfile.gettempdir(), "autodist_tpu"))
DEFAULT_LOG_DIR = os.path.join(DEFAULT_WORKING_DIR, "logs")
DEFAULT_GRAPH_DUMP_DIR = os.path.join(DEFAULT_WORKING_DIR, "graphs")

# Canonical mesh axis names.
MESH_AXIS_DATA = "data"        # data parallel / gradient reduction axis
MESH_AXIS_MODEL = "model"      # tensor / parameter partition axis
MESH_AXIS_SEQ = "seq"          # sequence/context parallel axis
MESH_AXIS_EXPERT = "expert"    # expert parallel axis (MoE)
MESH_AXIS_PIPELINE = "pipe"    # pipeline stage axis
ALL_MESH_AXES = (MESH_AXIS_DATA, MESH_AXIS_MODEL, MESH_AXIS_SEQ,
                 MESH_AXIS_EXPERT, MESH_AXIS_PIPELINE)


class ENV(enum.Enum):
    """Typed environment variables (``name``, type, default)."""

    AUTODIST_MIN_LOG_LEVEL = ("AUTODIST_MIN_LOG_LEVEL", str, "INFO")
    AUTODIST_DUMP_GRAPHS = ("AUTODIST_DUMP_GRAPHS", bool, False)  # dump the strategy at each compile stage
    AUTODIST_STRATEGY = ("AUTODIST_STRATEGY", str, "")  # strategy builder by name: "allreduce" ("" => AllReduce when serving; AutoDist needs a builder)
    AUTODIST_PREFETCH_DEPTH = ("AUTODIST_PREFETCH_DEPTH", int, 2)  # DevicePrefetcher in-flight transfers (0 => passthrough)
    AUTODIST_SERVE_BUCKETS = ("AUTODIST_SERVE_BUCKETS", str, "")  # "8,32,128" or "8x128,32x128" for (rows, seq)
    AUTODIST_SERVE_MAX_WAIT_MS = ("AUTODIST_SERVE_MAX_WAIT_MS", int, 5)  # continuous-batching coalesce deadline (ms)

    def __init__(self, var_name, var_type, default):
        self.var_name = var_name
        self.var_type = var_type
        self.default = default

    @property
    def val(self):
        raw = os.environ.get(self.var_name)
        if raw is None:
            return self.default
        if self.var_type is bool:
            return raw.lower() in ("1", "true", "yes")
        return self.var_type(raw)


def ensure_working_dirs():
    for d in (DEFAULT_WORKING_DIR, DEFAULT_LOG_DIR, DEFAULT_GRAPH_DUMP_DIR):
        os.makedirs(d, exist_ok=True)
