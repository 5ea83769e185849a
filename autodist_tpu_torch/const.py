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
DEFAULT_TRACE_DIR = os.path.join(DEFAULT_WORKING_DIR, "traces")
DEFAULT_GRAPH_DUMP_DIR = os.path.join(DEFAULT_WORKING_DIR, "graphs")
DEFAULT_SERIALIZATION_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")
DEFAULT_CHECKPOINT_DIR = os.path.join(DEFAULT_WORKING_DIR, "checkpoints")

# How long a worker waits for the chief to publish the serialized strategy
# on the process group's store (the chief's capture and build can trail the
# worker's arrival); AUTODIST_STRATEGY_SHIP_TIMEOUT_MS overrides it.
STRATEGY_SHIP_TIMEOUT_MS = 120_000

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
    AUTODIST_STRATEGY = ("AUTODIST_STRATEGY", str, "")  # strategy builder by name ("ps", "parallax", "allreduce", ...; "" => PS() in AutoDist, AllReduce when serving)
    AUTODIST_STRATEGY_ID = ("AUTODIST_STRATEGY_ID", str, "")  # strategy artifact id to load (from DEFAULT_SERIALIZATION_DIR) instead of building
    AUTODIST_STRATEGY_SHIP_TIMEOUT_MS = ("AUTODIST_STRATEGY_SHIP_TIMEOUT_MS", int, 0)  # 0 => STRATEGY_SHIP_TIMEOUT_MS
    # -- resilience (resilience/, checkpoint/) ------------------------------
    AUTODIST_CHAOS = ("AUTODIST_CHAOS", str, "")             # fault injection knobs (resilience/chaos.py)
    AUTODIST_GUARD_CHECK_EVERY = ("AUTODIST_GUARD_CHECK_EVERY", int, 10)   # StepGuard host-check cadence (steps)
    AUTODIST_GUARD_MAX_STRIKES = ("AUTODIST_GUARD_MAX_STRIKES", int, 3)    # consecutive rollbacks before abort
    AUTODIST_RETRY_MAX_ATTEMPTS = ("AUTODIST_RETRY_MAX_ATTEMPTS", int, 4)  # transient-I/O retry budget (resilience/retry.py)
    AUTODIST_UNROLL = ("AUTODIST_UNROLL", int, 1)  # fused steps per dispatch (megastep: one CUDA graph of K steps; 1 => one step per dispatch)
    AUTODIST_PREFETCH_DEPTH = ("AUTODIST_PREFETCH_DEPTH", int, 2)  # DevicePrefetcher in-flight transfers (0 => passthrough)
    AUTODIST_LOADER_RING = ("AUTODIST_LOADER_RING", int, 2)        # native async assembly ring depth (0 => synchronous)
    AUTODIST_LOADER_POOL = ("AUTODIST_LOADER_POOL", int, 0)        # staging buffer pool size (0 => auto: ring + depth + 2)
    AUTODIST_SERVE_BUCKETS = ("AUTODIST_SERVE_BUCKETS", str, "")  # "8,32,128" or "8x128,32x128" for (rows, seq)
    AUTODIST_SERVE_MAX_WAIT_MS = ("AUTODIST_SERVE_MAX_WAIT_MS", int, 5)  # continuous-batching coalesce deadline (ms)
    AUTODIST_DECODE_SLOTS = ("AUTODIST_DECODE_SLOTS", int, 8)  # decode engine slot count per (slots, cache_len) bucket (a multiple of the per-replica device count)
    AUTODIST_DECODE_CACHE_LEN = ("AUTODIST_DECODE_CACHE_LEN", int, 128)  # preallocated KV-cache length per slot (prompt + generated tokens must fit)
    # -- pipeline parallelism (pipeline/) -------------------------------------
    AUTODIST_PIPELINE_STAGES = ("AUTODIST_PIPELINE_STAGES", int, 0)  # pipeline stage count S for Pipeline() with no explicit num_stages (0 => the spec's pipeline: mesh hint, else the stage cutter's choice)
    AUTODIST_MICROBATCHES = ("AUTODIST_MICROBATCHES", int, 0)  # GPipe microbatch count M (0 => 2 * stages; bubble fraction (S-1)/(S+M-1))
    AUTODIST_PIPELINE_SCHEDULE = ("AUTODIST_PIPELINE_SCHEDULE", str, "shift")  # shift (pipelined) | sequential (the bitwise unpipelined control arm) | shift-noskip (idle slots compute on garbage) | 1f1b (shift order, the stage recomputed in the backward)
    # -- tuner (tuner/calibration.py, tuner/cost_model.py) -------------------
    AUTODIST_TUNER_CALIBRATION = ("AUTODIST_TUNER_CALIBRATION", str, "")  # calibration file override (default <working_dir>/tuner_calibration.json)
    # -- goodput / run-level accounting (observability/goodput.py) -----------
    AUTODIST_RUN_ID = ("AUTODIST_RUN_ID", str, "")  # run identity carried across elastic re-exec generations (minted by the chief when unset)
    AUTODIST_RUN_GENERATION = ("AUTODIST_RUN_GENERATION", int, 0)  # process-generation index within a run
    AUTODIST_PEAK_TFLOPS = ("AUTODIST_PEAK_TFLOPS", float, 0.0)  # per-device peak TFLOP/s override for MFU (0 => built-in per-device table)
    # -- HBM memory ledger (observability/memory.py) --------------------------
    AUTODIST_HBM_GB = ("AUTODIST_HBM_GB", float, 0.0)  # per-device HBM capacity override in GiB (0 => the built-in per-device table)
    AUTODIST_MEM_HEADROOM = ("AUTODIST_MEM_HEADROOM", float, 0.9)  # feasibility fraction of HBM capacity a candidate's predicted peak may use
    # -- per-layer profile (observability/profile.py) --------------------------
    AUTODIST_PROFILE = ("AUTODIST_PROFILE", bool, True)  # per-layer device-time profiler (finalize-only cost; telemetry off => provably zero calls)
    AUTODIST_PROFILE_TOPK = ("AUTODIST_PROFILE_TOPK", int, 5)  # top-K scopes surfaced on the monitor / gauges
    # -- cluster timeline / straggler forensics (observability/skew.py) -------
    AUTODIST_CLOCK_SYNC = ("AUTODIST_CLOCK_SYNC", bool, True)  # cross-rank clock-offset ping over the c10d store (0 => no pings; traces still carry the local epoch anchor)
    AUTODIST_SKEW_RING = ("AUTODIST_SKEW_RING", int, 256)  # per-dispatch window ring for the skew decomposition (entries; 0 => no ring, no decomposition)
    # -- observability (observability/) ---------------------------------------
    AUTODIST_TELEMETRY = ("AUTODIST_TELEMETRY", bool, True)  # master switch: metrics + spans + flight recorder
    AUTODIST_TRACE = ("AUTODIST_TRACE", str, "chrome")       # chrome | profiler (adds the torch.profiler bridge) | 0 (off)
    AUTODIST_METRICS_WINDOW = ("AUTODIST_METRICS_WINDOW", int, 256)  # histogram window (last-N observations)
    AUTODIST_MONITOR_PORT = ("AUTODIST_MONITOR_PORT", int, 0)  # chief HTTP monitor (/metrics + /status); 0 => no server, no thread
    AUTODIST_ANOMALY_ZSCORE = ("AUTODIST_ANOMALY_ZSCORE", float, 3.0)  # per-host latency z-score threshold for the anomaly detector
    AUTODIST_FLIGHT_MAX_MB = ("AUTODIST_FLIGHT_MAX_MB", int, 64)  # total on-disk cap across logs/flight_*.jsonl (oldest-file eviction)
    AUTODIST_SERVE_SLO_MS = ("AUTODIST_SERVE_SLO_MS", int, 50)  # serving p99 SLO target (the serve.slo_burn gauge)

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


def strategy_ship_timeout_ms():
    """Effective ship timeout: the typed ENV override, else the default."""
    return ENV.AUTODIST_STRATEGY_SHIP_TIMEOUT_MS.val or \
        STRATEGY_SHIP_TIMEOUT_MS


def ensure_working_dirs():
    for d in (DEFAULT_WORKING_DIR, DEFAULT_SERIALIZATION_DIR,
              DEFAULT_LOG_DIR, DEFAULT_TRACE_DIR, DEFAULT_GRAPH_DUMP_DIR):
        os.makedirs(d, exist_ok=True)
