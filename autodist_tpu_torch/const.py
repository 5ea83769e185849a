"""Mesh-axis names and the typed environment knobs the port reads.

Counterpart of ``autodist_tpu/const.py``: the same axis names and, for the
knobs kept here, the same variable names, types and defaults, so one
environment configures both packages. One default differs: the working
directory is ``<tmp>/autodist_tpu_torch`` (the JAX package's is
``/tmp/autodist_tpu``), so the two packages' artifacts (report pages and
their ``report.html`` alias, traces, flight logs, calibration) share a
directory only where ``AUTODIST_WORKING_DIR`` names one for both.
"""
import enum
import os
import tempfile

DEFAULT_WORKING_DIR = os.environ.get(
    "AUTODIST_WORKING_DIR",
    os.path.join(tempfile.gettempdir(), "autodist_tpu_torch"))
DEFAULT_LOG_DIR = os.path.join(DEFAULT_WORKING_DIR, "logs")
DEFAULT_TRACE_DIR = os.path.join(DEFAULT_WORKING_DIR, "traces")
DEFAULT_GRAPH_DUMP_DIR = os.path.join(DEFAULT_WORKING_DIR, "graphs")
DEFAULT_SERIALIZATION_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")
DEFAULT_CHECKPOINT_DIR = os.path.join(DEFAULT_WORKING_DIR, "checkpoints")

# The chief's port when a launched spec names no ``coordinator:`` (the JAX
# package's default): the world's c10d TCP store listens there.
DEFAULT_COORDINATOR_PORT = 15500

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
# Nested sub-axes of the data axis for hierarchical collectives
# (Cluster.build_hierarchical_mesh / kernel/synchronization/hierarchical.py):
# dcn spans hosts (slow leg), ici spans devices within a host (fast leg).
MESH_AXIS_DCN = "dcn"
MESH_AXIS_ICI = "ici"


class ENV(enum.Enum):
    """Typed environment variables (``name``, type, default)."""

    # -- the chief->worker launch contract (coordinator.py, cluster.py) ------
    AUTODIST_WORKER = ("AUTODIST_WORKER", str, "")           # non-empty => this process is a worker, value = its node's address
    AUTODIST_PROCESS_ID = ("AUTODIST_PROCESS_ID", int, 0)    # this process's rank, assigned by the launcher
    AUTODIST_NUM_PROCESSES = ("AUTODIST_NUM_PROCESSES", int, 1)
    AUTODIST_COORDINATOR = ("AUTODIST_COORDINATOR", str, "") # "host:port" of the chief's c10d TCP store
    AUTODIST_IS_TESTING = ("AUTODIST_IS_TESTING", bool, False)
    AUTODIST_SSH_BIN = ("AUTODIST_SSH_BIN", str, "ssh")      # ssh client override (tests: loopback shim)
    AUTODIST_SCP_BIN = ("AUTODIST_SCP_BIN", str, "scp")      # scp client override
    AUTODIST_DEBUG_REMOTE = ("AUTODIST_DEBUG_REMOTE", bool, False)  # log the ssh argv instead of running it
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
    AUTODIST_SUPERVISION = ("AUTODIST_SUPERVISION", str, "abort")          # abort | restart-worker | checkpoint-and-exit | elastic
    AUTODIST_MAX_WORKER_RESTARTS = ("AUTODIST_MAX_WORKER_RESTARTS", int, 2)  # per-worker respawn budget (restart-worker)
    AUTODIST_ELASTIC_MIN_WORLD = ("AUTODIST_ELASTIC_MIN_WORLD", int, 1)  # elastic supervision never shrinks below this world size (escalates to abort)
    AUTODIST_ELASTIC_WORLD = ("AUTODIST_ELASTIC_WORLD", int, 0)  # re-formed world-size override applied to the resource spec (set by Coordinator.reform_now; 0 => spec as written)
    # -- overlap scheduler (kernel/overlap.py, runner.py) ---------------------
    AUTODIST_OVERLAP = ("AUTODIST_OVERLAP", bool, False)  # issue each grad-sync bucket asynchronously as its last gradient is produced in the backward, waited on before the update; under a megastep also the zero1 weight all-gather reorder
    AUTODIST_ZERO1_AG_SCOPE = ("AUTODIST_ZERO1_AG_SCOPE", str, "step")  # weight-AG reorder granularity under AUTODIST_OVERLAP and unroll > 1: step (every zero1 param gathered at the start of the next step's forward) | use (each param gathered at its first forward use)
    AUTODIST_AR_BUCKET_MB = ("AUTODIST_AR_BUCKET_MB", int, 0)  # fusion-bucket size cap in MiB (0 => one bucket per strategy group/compressor/codec/dtype)
    # -- hierarchical collectives (kernel/synchronization/hierarchical.py) ----
    AUTODIST_HIER_ICI = ("AUTODIST_HIER_ICI", int, 0)  # ICI-leg size (devices per host) override for the execution-side leg split (0 => ResourceSpec.devices_per_host; testing/bench knob)
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
