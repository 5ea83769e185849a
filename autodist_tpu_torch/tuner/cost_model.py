"""Analytic cost model: (Strategy, GraphItem, Topology) -> predicted step
time and per-device memory.

Counterpart of the part of ``autodist_tpu/tuner/cost_model.py`` the
ledgers price with (``observability/attribution.py``, ``memory.py``):
:class:`Topology` with its collective costs and HBM capacity,
:meth:`CostModel.strategy_cost` (with the overlap schedule, the bucket cap
and the hierarchical ``hier=`` codec), :meth:`CostModel.strategy_memory`
and the stage-cut imbalance. The strategy search, ``serve_cost``, the
pipeline ``microbatches=`` knob and the Automap plan pricing come with the
tuner's search (ROADMAP.md, A12).

One training step of a candidate strategy is priced as

    step = compute + per-variable sync (collectives) + optimizer update

with every collective priced on a **hierarchical ring**: the intra-host
leg rides NVLink-class links, and when the collective group spans hosts
the inter-host leg pays the network's bandwidth and latency on the
host-reduced shard. The absolute numbers are seeded from the NVIDIA H100
SXM's datasheet (the JAX package's seeds are TPU v5e figures and do not
carry over) and refined by :mod:`~autodist_tpu_torch.tuner.calibration`;
*ranking* needs only the relative structure:

* more bytes        => cost is non-decreasing (bandwidth terms are linear),
* faster link       => cost is non-increasing (bandwidth in the denominator),
* cross-host groups => cost >= the same group confined to one host.
"""
import enum
import os
from collections import namedtuple

from autodist_tpu_torch import const


class Connectivity(enum.Enum):
    """Relative link quality between two devices (best -> worst): the JAX
    package's ``resource_spec.Connectivity``."""
    SAME_DEVICE = 0
    ICI = 1          # NVLink-class intra-host interconnect
    LOCAL = 2        # same host, PCIe/host memory
    DCN = 3          # cross-host network

# Seed link parameters (bandwidth bytes/s per direction, latency s) per
# connectivity tier, from the NVIDIA H100 SXM5 datasheet (NVIDIA H100
# Tensor Core GPU datasheet, 2023): NVLink 4 at 900 GB/s total per GPU,
# 450 GB/s each way; PCIe Gen5 x16 at 128 GB/s total, 64 GB/s each way;
# and one 400 Gb/s NDR InfiniBand port per GPU (DGX H100), 50 GB/s. The
# latencies are round seeds, not measurements (the network's, 50 us, is
# the JAX package's DCN seed, which keeps a group across hosts no cheaper
# than the same group on one). Calibration overrides them.
DEFAULT_LINKS = {
    Connectivity.ICI: (450e9, 5e-6),
    Connectivity.LOCAL: (64e9, 5e-6),
    Connectivity.DCN: (50e9, 50e-6),
}

# Per-device compute seeds, the same datasheet: dense bf16 Tensor Core
# FLOP/s and HBM3 bandwidth of the H100 SXM5.
DEFAULT_DEVICE_FLOPS = 989e12
DEFAULT_HBM_BYTES_PER_S = 3.35e12

# Last-resort per-device HBM capacity (GiB) when the capacity table in
# observability/goodput.py is unreachable: its H100 row.
PLATFORM_FALLBACK_HBM_GB = 80.0

# Bytes touched per parameter element by an elementwise optimizer update
# (read grad + read/write param + read/write two moments, f32): the
# coefficient that makes sharded updates (1/N of the elements) beat
# replicated updates for huge variables.
UPDATE_BYTES_PER_ELEM = 24.0

# Host-side PER-DISPATCH floor (ms): Python dispatch + batch placement +
# clock reads. A seed, not a measurement on any device.  Common to every candidate at unroll=1; fused
# multi-step dispatch (``Runner.run(unroll=K)``) pays it once per K
# steps, which is how the model ranks unroll factors: the per-step term
# is DISPATCH_MS / K, so unroll matters exactly when DISPATCH_MS is
# comparable to the compute+sync terms (small models, host-bound steps).
DISPATCH_MS = 0.05

LinkParams = namedtuple("LinkParams", ["bandwidth", "latency"])


class Topology:
    """Interconnect abstraction the cost model prices against.

    Constructed for a Runner's mesh (:meth:`for_mesh`: device and host
    counts, the seed links, then calibration), or directly in tests with
    synthetic shapes.
    """

    def __init__(self, num_devices, num_hosts=1, links=None,
                 device_flops=DEFAULT_DEVICE_FLOPS,
                 hbm_bytes_per_s=DEFAULT_HBM_BYTES_PER_S,
                 hbm_capacity_bytes=None):
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        self.num_devices = int(num_devices)
        self.num_hosts = max(1, min(int(num_hosts), self.num_devices))
        self.devices_per_host = max(1, self.num_devices // self.num_hosts)
        self.links = {tier: LinkParams(*p)
                      for tier, p in {**DEFAULT_LINKS, **(links or {})}.items()}
        self.device_flops = float(device_flops)
        self.hbm_bytes_per_s = float(hbm_bytes_per_s)
        self._hbm_capacity_bytes = (float(hbm_capacity_bytes)
                                    if hbm_capacity_bytes else None)

    @property
    def hbm_capacity_bytes(self):
        """Per-device HBM capacity the memory ledger prices against.

        Resolution order: the ``AUTODIST_HBM_GB`` env override -> the
        constructor's ``hbm_capacity_bytes`` -> the per-device capacity
        table next to the peak-FLOPs table in observability/goodput.py.
        """
        env_gb = const.ENV.AUTODIST_HBM_GB.val
        if env_gb and env_gb > 0:
            return float(env_gb) * (1 << 30)
        if self._hbm_capacity_bytes:
            return self._hbm_capacity_bytes
        try:
            from autodist_tpu_torch.observability import goodput
            return float(goodput.peak_hbm_bytes_per_device())
        except Exception:  # noqa: BLE001 - capacity lookup is best-effort
            return float(PLATFORM_FALLBACK_HBM_GB) * (1 << 30)

    @classmethod
    def for_mesh(cls, mesh, calibration=None):
        """The topology of a Runner's mesh: its device count, over the hosts
        of the ``torch.distributed`` world (``WORLD_SIZE / LOCAL_WORLD_SIZE``
        under torchrun, else one host), with the seed links (and the
        calibration's link overrides)."""
        n = max(1, int(getattr(mesh, "size", 1) or 1))
        world = int(os.environ.get("WORLD_SIZE", "0") or 0)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
        hosts = world // local if world and local else 1
        links = dict(DEFAULT_LINKS)
        if calibration is not None:
            links = calibration.apply_link_overrides(links)
        return cls(n, num_hosts=max(1, hosts), links=links)

    def link(self, tier):
        return self.links[tier]

    # -- collective primitives (hierarchical-ring aware) ---------------------

    def _hosts_spanned(self, group_size):
        """Hosts a data-axis collective group of this size crosses.

        The mesh lays devices out host-major with ``data`` outermost, so a
        group of g devices strides across min(num_hosts, g) hosts — the
        pessimistic-but-realistic assumption for pure DP (spans every
        host) and carved meshes alike.
        """
        return max(1, min(self.num_hosts, int(group_size)))

    def _ring_leg(self, nbytes, steps, denom, tier):
        """One ring leg: ``steps`` hops moving ``nbytes * steps/denom``."""
        if steps <= 0:
            return 0.0
        bw, lat = self.link(tier)
        return (float(nbytes) * steps / denom) / bw + steps * lat

    def _hierarchical(self, nbytes, group_size, phases):
        """Price a collective of ``phases`` x (reduce-scatter-equivalent
        ring sweeps) over a group, splitting intra-host / inter-host legs.

        ``phases=2`` is an all-reduce (RS + AG), ``phases=1`` a
        reduce-scatter or all-gather.
        """
        g = max(1, int(group_size))
        if g == 1:
            return 0.0
        h = self._hosts_spanned(g)
        intra_tier = (Connectivity.ICI
                      if Connectivity.ICI in self.links else Connectivity.LOCAL)
        if h == 1:
            return phases * self._ring_leg(nbytes, g - 1, g, intra_tier)
        d = max(1, g // h)  # group members per host
        cost = 0.0
        if d > 1:  # intra-host sweep over the full payload
            cost += phases * self._ring_leg(nbytes, d - 1, d, intra_tier)
        # inter-host sweep over the host-reduced shard
        cost += phases * self._ring_leg(nbytes / d, h - 1, h, Connectivity.DCN)
        return cost

    def all_reduce_cost(self, nbytes, group_size):
        return self._hierarchical(nbytes, group_size, phases=2)

    def reduce_scatter_cost(self, nbytes, group_size):
        return self._hierarchical(nbytes, group_size, phases=1)

    def all_gather_cost(self, nbytes, group_size):
        return self._hierarchical(nbytes, group_size, phases=1)

    def hierarchical_ar_cost(self, nbytes, group_size, dcn_factor=1.0):
        """Two-level all-reduce (``kernel/synchronization/hierarchical.py``):
        full-precision reduce-scatter + all-gather on the intra-host leg,
        codec-compressed all-reduce of the 1/d shard on the DCN leg.
        ``dcn_factor`` is the codec's wire fraction (:func:`hier_dcn_factor`).
        At one host, or at factor 1, this equals :meth:`all_reduce_cost`
        term for term; otherwise it is strictly decreasing in
        ``dcn_factor`` and increasing in ``nbytes`` and the hosts
        spanned."""
        g = max(1, int(group_size))
        if g == 1:
            return 0.0
        h = self._hosts_spanned(g)
        intra_tier = (Connectivity.ICI
                      if Connectivity.ICI in self.links else Connectivity.LOCAL)
        if h == 1:
            return 2.0 * self._ring_leg(nbytes, g - 1, g, intra_tier)
        d = max(1, g // h)
        cost = 0.0
        if d > 1:
            cost += 2.0 * self._ring_leg(nbytes, d - 1, d, intra_tier)
        cost += self._ring_leg(float(nbytes) * float(dcn_factor) / d,
                               2 * (h - 1), h, Connectivity.DCN)
        return cost

    # -- per-leg wire accounting --------------------------------------------
    # "Wire bytes" here means bytes RECEIVED per device per step on a leg;
    # these formulas are mirrored byte for byte by the execution-side wire
    # tally (``hierarchical._tally_hier`` / ``_tally_flat``).

    def flat_wire_split(self, total_wire_bytes, group_size):
        """Split one FLAT collective's wire bytes (phase- and compression-
        weighted payload) across the legs its host-major ring crosses:
        (d-1)/d of it stays intra-host, the 1/d shard's (h-1)/h sweep
        crosses DCN."""
        w = max(0.0, float(total_wire_bytes))
        g = max(1, int(group_size))
        if g == 1 or w == 0.0:
            return {"ici": 0.0, "dcn": 0.0}
        h = self._hosts_spanned(g)
        if h == 1:
            return {"ici": w * (g - 1) / g, "dcn": 0.0}
        d = max(1, g // h)
        return {"ici": w * (d - 1) / d, "dcn": (w / d) * (h - 1) / h}

    def hier_wire_split(self, nbytes, group_size, codec):
        """Per-leg wire bytes of ONE hierarchical all-reduce of an
        ``nbytes`` f32 payload: full-precision RS + AG on ICI, the codec's
        compressed shard on DCN (int8 at small host counts takes the
        gather transport, (h-1) quantized shards received; past the
        crossover the codec switches to the bf16 wire, as execution
        does)."""
        g = max(1, int(group_size))
        nbytes = float(nbytes)
        if g == 1:
            return {"ici": 0.0, "dcn": 0.0}
        h = self._hosts_spanned(g)
        f = HIER_CODEC_FACTORS.get(codec, 1.0)
        if h == 1:  # degenerate: the flat codec path
            return self.flat_wire_split(2.0 * nbytes * f, g)
        d = max(1, g // h)
        shard = nbytes / d
        if codec.startswith("int8") and h <= _INT8_MAX_AXIS:
            dcn = (h - 1) * shard * f
        else:
            dcn = 2.0 * shard * hier_dcn_factor(codec, h) * (h - 1) / h
        return {"ici": 2.0 * nbytes * (d - 1) / d, "dcn": dcn}


# Blockwise-int8 wire overhead: 1 byte/element + one f32 scale per block
# (kernel/synchronization/compressor.py ``_INT8_BLOCK``).
_INT8_BLOCK = 256
_INT8_FACTOR = (1.0 + 4.0 / _INT8_BLOCK) / 4.0

# DCN-leg codec wire fractions + the int8 gather-transport crossover of the
# hierarchical collectives; kept equal to
# kernel/synchronization/{hierarchical,compressor}.py's.
HIER_CODEC_FACTORS = {"f32": 1.0, "bf16": 0.5,
                      "int8": _INT8_FACTOR, "int8ef": _INT8_FACTOR}
_INT8_MAX_AXIS = 8


def hier_dcn_factor(codec, hosts):
    """Effective DCN wire fraction of a hierarchical codec on a leg of
    ``hosts``: int8 past the gather-transport crossover switches to the
    bf16 wire (``hierarchical._dcn_leg``), so its factor does too."""
    if codec.startswith("int8") and int(hosts) > _INT8_MAX_AXIS:
        return HIER_CODEC_FACTORS["bf16"]
    return HIER_CODEC_FACTORS.get(codec, 1.0)


def _hier_codec_for(node):
    """The DCN codec an all-reduce node with ``spec: DCN`` selects (its
    compressor names it; all_reduce_synchronizer._HIER_CODECS), else
    None."""
    from autodist_tpu_torch.kernel.synchronization.all_reduce_synchronizer \
        import hier_codec
    return hier_codec(node)

# Wire-format factor per compressor enum value (fraction of f32 bytes on
# the wire); EF variants pay the same wire plus a small local epsilon that
# does not change ranking.  ``var`` (when given) makes PowerSGD exact:
# its wire is the rank-r factors P (m x r) + Q (n x r), not the m x n
# gradient — r*(m+n)/(m*n) of the dense bytes.
def _compressor_factor(compressor, var=None, powersgd_rank=2):
    from autodist_tpu_torch.proto import strategy_pb2
    C = strategy_pb2.AllReduceSynchronizer.Compressor
    if compressor == C.PowerSGDCompressor:
        shape = tuple(getattr(var, "shape", ()) or ())
        if len(shape) >= 2:
            m = float(shape[0])
            n = 1.0
            for d in shape[1:]:
                n *= float(d)
            return min(1.0, powersgd_rank * (m + n) / (m * n))
        return 1.0  # vectors/scalars reduce uncompressed
    return {C.NoneCompressor: 1.0,
            C.HorovodCompressor: 0.5, C.HorovodCompressorEF: 0.5,
            C.Int8Compressor: _INT8_FACTOR,
            C.Int8CompressorEF: _INT8_FACTOR}.get(compressor, 1.0)


# f32 optimizer-state arrays held per parameter element, by optimizer
# family: adam-class keeps two moments, momentum-sgd one buffer.  The
# conservative default (2) matches the UPDATE_BYTES_PER_ELEM read/write
# economics above — an unknown optimizer is priced like adam, so the
# feasibility pruner errs toward refusing, never toward OOM.
def _optimizer_state_factor(graph_item):
    name = (getattr(graph_item, "optimizer_name", "") or "").lower()
    if not name and getattr(graph_item, "optimizer", None) is None:
        return 0.0
    if "sgd" in name or "momentum" in name:
        return 1.0
    return 2.0


def _parse_partitioner(text):
    """'axis:num[:mesh_axis]' -> (axis, num_shards, mesh_axis).

    Multi-entry strings ('1:2:model,0:4:expert' — automap's composed
    plans) resolve to their FIRST entry here; callers that must see
    every entry use :func:`_parse_partitioner_multi`.
    """
    entries = _parse_partitioner_multi(text)
    return entries[0] if entries else None


def _parse_partitioner_multi(text):
    """Full multi-entry parse: '1:2:model,0:4:expert' ->
    [(1, 2, 'model'), (0, 4, 'expert')]; [] for unpartitioned."""
    if not text:
        return []
    out = []
    for entry in str(text).split(","):
        parts = entry.split(":")
        axis, num = int(parts[0]), int(parts[1])
        mesh_axis = parts[2] if len(parts) > 2 else const.MESH_AXIS_DATA
        out.append((axis, num, mesh_axis))
    return out


class CostBreakdown(dict):
    """Per-candidate cost terms (ms); ``total_ms`` is the ranking key."""

    @property
    def total_ms(self):
        return self.get("total_ms", float("inf"))


class MemoryBreakdown(dict):
    """Predicted per-device HBM footprint of a candidate, split into the
    ledger classes.  The classes partition the estimate:
    ``peak_bytes`` is their exact sum by construction, which the tier-1
    ledger test pins — every byte the model predicts is attributable to
    a named class, never a fudge term."""

    #: The ledger classes, in report stacking order.  ``peak_bytes`` ==
    #: sum of exactly these keys.
    CLASSES = ("params_bytes", "optimizer_bytes", "gradients_bytes",
               "sync_state_bytes", "activations_bytes", "staging_bytes",
               "kv_cache_bytes")

    @property
    def peak_bytes(self):
        return float(sum(self.get(c, 0.0) for c in self.CLASSES))

    @property
    def peak_gb(self):
        return self.peak_bytes / (1 << 30)

    def dominant_class(self):
        """Name of the largest ledger class (OOM forensics headline)."""
        return max(self.CLASSES, key=lambda c: self.get(c, 0.0))


class CostModel:
    """Prices one training step of a candidate strategy."""

    def __init__(self, topology, calibration=None):
        self.topology = topology
        self.calibration = calibration

    # -- per-variable sync cost ---------------------------------------------

    def _var_sync_cost(self, var, node, n_data, ar_buckets, hier=None):
        """Per-variable collective time split by overlap class, OR defer
        fused all-reduce bytes into ``ar_buckets`` (per fusion group:
        ``[wire_bytes, raw_bytes, dcn_codec, sparse_wire_bytes]``; the
        codec is the ``hier`` override, else the node's own ``spec: DCN``
        selection, else None = flat; sparse-access bytes ride the last
        slot, exempt from the codec).  Returns ``(rs_s, ag_s, other_s,
        elements_updated_per_device, wire_bytes)``: reduce-scatter-class
        time overlaps the backward, all-gather-class time the NEXT forward
        (inside a megastep), ``other`` never (stale-period averages)."""
        topo = self.topology
        size = float(var.size_bytes)
        if node is None:  # replicated, no sync recorded
            return 0.0, 0.0, 0.0, var.num_elements, 0.0
        part = _parse_partitioner(node.partitioner)
        shard_axis_n = 1
        for _, num, mesh_axis in _parse_partitioner_multi(node.partitioner):
            if mesh_axis != const.MESH_AXIS_DATA:
                # Storage sharded over a non-data axis (TP/pipe overlay,
                # multiplied across every carved axis for automap's
                # composed partitioners): the data-axis sync moves only
                # this device's shard.
                shard_axis_n *= max(1, num)
        size /= shard_axis_n
        which = node.WhichOneof("synchronizer")
        if which == "all_reduce_synchronizer":
            ar = node.all_reduce_synchronizer
            wire = size * _compressor_factor(ar.compressor, var)
            if part is not None and part[2] == const.MESH_AXIS_DATA:
                # FSDP-flavored: param all-gathered for compute, gradient
                # born reduce-scattered by the gather VJP; shard update.
                return (topo.reduce_scatter_cost(size, n_data),
                        topo.all_gather_cost(size, n_data),
                        0.0, var.num_elements / max(1, n_data), size * 2)
            # Dense all-reduce: fusion groups share one collective:
            # accumulate bytes, pay latency once per bucket. Sparse-access
            # variables (embeddings) never take the hier codec discount
            # (their outlier rows defeat blockwise int8 scales): their
            # bytes ride the entry's sparse slot, fused into the group's
            # flat ring, or their own flat collective beside a two-level
            # bucket.
            entry = ar_buckets.setdefault(ar.group, [0.0, 0.0, None, 0.0])
            if getattr(var, "sparse_access", False):
                entry[3] += wire
            else:
                codec = hier or _hier_codec_for(node)
                entry[0] += wire
                entry[1] += size
                if codec:
                    entry[2] = codec
            return (0.0, 0.0, 0.0,
                    var.num_elements / max(1, shard_axis_n), wire * 2)
        if which == "ps_synchronizer":
            ps = node.ps_synchronizer
            if ps.staleness > 0:
                # Local SGD: a full-variable average every s+1 steps,
                # full local update every step.
                period = ps.staleness + 1
                return (0.0, 0.0, topo.all_reduce_cost(size, n_data) / period,
                        var.num_elements, size * 2 / period)
            # ZeRO-1/3: reduce-scatter the gradient onto the state shard,
            # update 1/N of the elements, all-gather the parameter.
            return (topo.reduce_scatter_cost(size, n_data),
                    topo.all_gather_cost(size, n_data),
                    0.0, var.num_elements / max(1, n_data), size * 2)
        return 0.0, 0.0, 0.0, var.num_elements, 0.0

    # -- whole-candidate cost -----------------------------------------------

    def strategy_cost(self, strategy, graph_item, unroll=1, overlap=False,
                      bucket_bytes=0, hier=None):
        """Predicted per-step cost of ``strategy`` on this topology.

        ``unroll=K`` amortizes the per-dispatch host overhead over K
        fused steps (``dispatch_ms = DISPATCH_MS / K`` in the breakdown)
        — call with several K values to rank unroll factors for a
        given strategy/model.  A pipe axis prices the artifact's GPipe
        microbatches.

        ``hier="bf16"|"int8"|"int8ef"`` prices the dense all-reduce buckets
        as two-level collectives with that DCN-leg codec; without it, nodes
        that carry ``spec: DCN`` are priced hierarchically anyway.

        ``overlap=True`` prices the overlap scheduler
        (``AUTODIST_OVERLAP``): grad-sync buckets and reduce-scatters are
        issued as gradients become available, so only ``exposed = max(0,
        bucket_comms - overlappable_backward_compute)`` accumulated per
        bucket hits the step; ZeRO weight all-gathers overlap the NEXT
        step's forward inside a megastep (``unroll > 1``). With
        ``bucket_bytes`` each fusion group splits into ceil(bytes/cap)
        buckets, each paying its own collective latency.
        """
        topo = self.topology
        unroll = max(1, int(unroll))
        axes = dict(strategy.graph_config.mesh_axes) or \
            {const.MESH_AXIS_DATA: topo.num_devices}
        n_data = max(1, axes.get(const.MESH_AXIS_DATA, topo.num_devices))

        rs_s, ag_s, other_s, update_elems, wire_bytes = 0, 0, 0, 0.0, 0.0
        ar_buckets = {}
        for var in graph_item.trainable_variables:
            node = strategy.node_by_name(var.name)
            rs, ag, oth, elems, wire = self._var_sync_cost(
                var, node, n_data, ar_buckets, hier=hier)
            rs_s += rs
            ag_s += ag
            other_s += oth
            update_elems += elems
            wire_bytes += wire
        bucket_costs = []
        cap = max(0, int(bucket_bytes or 0))
        hosts = topo._hosts_spanned(n_data)
        hier_applied = None
        leg_ici = leg_dcn = 0.0
        for group in sorted(ar_buckets):  # deterministic issue order
            nbytes, raw_bytes, codec, sparse_wire = ar_buckets[group]
            if codec and hosts > 1:
                # Two-level bucket: raw bytes on the ICI legs, the codec's
                # shard on DCN; sparse-access bytes pay their own flat
                # ring beside it.
                n_buckets = (max(1, -(-int(nbytes) // cap)) if cap else 1)
                for _ in range(n_buckets):
                    bucket_costs.append(topo.hierarchical_ar_cost(
                        raw_bytes / n_buckets, n_data,
                        hier_dcn_factor(codec, hosts)))
                hier_applied = codec
                if sparse_wire:
                    bucket_costs.append(
                        topo.all_reduce_cost(sparse_wire, n_data))
                split = topo.hier_wire_split(raw_bytes, n_data, codec)
                flat = topo.flat_wire_split(2.0 * sparse_wire, n_data)
                leg_ici += split["ici"] + flat["ici"]
                leg_dcn += split["dcn"] + flat["dcn"]
            else:
                # Flat (or degenerate one-host hierarchical, which runs as
                # the flat codec): the compressed-wire ring, the sparse
                # bytes fused into the same bucket.
                total = nbytes + sparse_wire
                n_buckets = (max(1, -(-int(total) // cap)) if cap else 1)
                for _ in range(n_buckets):
                    bucket_costs.append(
                        topo.all_reduce_cost(total / n_buckets, n_data))
                split = topo.flat_wire_split(2.0 * total, n_data)
                leg_ici += split["ici"]
                leg_dcn += split["dcn"]
        # Non-bucket wire (RS/AG pairs, stale averages) rides flat rings.
        other_wire = max(0.0, wire_bytes - 2.0 * sum(
            entry[0] + entry[3] for entry in ar_buckets.values()))
        split = topo.flat_wire_split(other_wire, n_data)
        leg_ici += split["ici"]
        leg_dcn += split["dcn"]

        update_s = update_elems * UPDATE_BYTES_PER_ELEM / topo.hbm_bytes_per_s

        # fwd + bwd ~= 3x the forward FLOPs, spread over every device.
        compute_s = 3.0 * graph_item.flops_estimate() / \
            (topo.num_devices * topo.device_flops)
        n_pipe = axes.get(const.MESH_AXIS_PIPELINE, 1)
        mb = int(strategy.graph_config.pipeline_microbatches or 0)
        bubble_ms = imbalance = 0.0

        # (The JAX package's Automap candidates carry a per-op plan priced
        # in place of the terms below; Automap is not ported: A12.)
        if n_pipe > 1:
            mb = mb or 2 * n_pipe
            # GPipe bubble: (S-1)/(S+M-1) of the schedule is fill/drain,
            # so per-step compute stretches by 1/(1-bubble) = (M+S-1)/M —
            # further stretched by the stage cut's predicted imbalance
            # (the slowest stage paces every tick; per-scope profiler
            # calibration refines each scope's weight in the cut).
            imbalance = self._pipeline_imbalance(graph_item, n_pipe)
            busy_s = compute_s * (1.0 + imbalance)
            compute_s = busy_s * (mb + n_pipe - 1) / mb
            bubble_ms = (compute_s - busy_s) * 1e3

        # Serialized comms (the schedule without overlap): all in line.
        serial_sync_s = sum(bucket_costs) + rs_s + ag_s + other_s
        sync_s = serial_sync_s
        if overlap:
            # The backward hides grad-sync buckets and reduce-scatters,
            # consumed in issue order; the next step's forward hides the
            # ZeRO weight all-gather, but only when a megastep holds both
            # steps (unroll > 1).
            backward_s = compute_s * 2.0 / 3.0
            exposed = 0.0
            budget = backward_s
            for c in bucket_costs + [rs_s]:
                exposed += max(0.0, c - budget)
                budget = max(0.0, budget - c)
            if unroll > 1:
                exposed += max(0.0, ag_s - compute_s / 3.0)
            else:
                exposed += ag_s
            sync_s = exposed + other_s

        # Non-data overlay axes (model/seq/expert) move activations every
        # step: a coarse per-axis term on the captured batch footprint.
        overlay_s = 0.0
        batch_bytes = _batch_bytes(graph_item)
        for axis, k in axes.items():
            if axis in (const.MESH_AXIS_DATA, const.MESH_AXIS_PIPELINE) \
                    or k <= 1:
                continue
            overlay_s += 2.0 * topo.all_gather_cost(batch_bytes, k)

        # Per-class calibration (attribution feedback): compute/update
        # terms and collective terms each carry their own refined scale
        # (global scale x per-term EMA); with no per-term history both
        # reduce to the legacy single global scale.
        cal = self.calibration
        scale = cal.scale if cal is not None else 1.0
        cscale = cal.compute_scale if cal is not None else 1.0
        mscale = cal.comms_scale if cal is not None else 1.0
        dispatch_ms = DISPATCH_MS / unroll
        total_ms = ((sync_s + overlay_s) * 1e3 * mscale +
                    (update_s + compute_s) * 1e3 * cscale + dispatch_ms)
        extra = {}
        if hier_applied:
            extra["hier_codec"] = hier_applied
        if n_pipe > 1:
            extra.update(bubble_ms=bubble_ms * cscale,
                         pipeline_imbalance=imbalance,
                         microbatches=mb, pipeline_stages=n_pipe)
        return CostBreakdown(
            total_ms=total_ms,
            sync_ms=serial_sync_s * 1e3,
            exposed_sync_ms=sync_s * 1e3,
            update_ms=update_s * 1e3,
            compute_ms=compute_s * 1e3,
            overlay_ms=overlay_s * 1e3,
            **extra,
            dispatch_ms=dispatch_ms,
            unroll=unroll,
            overlap=bool(overlap),
            bucket_mb=(cap / (1 << 20) if cap else 0),
            n_buckets=len(bucket_costs),
            wire_mb=wire_bytes / 1e6,
            wire_ici_mb=leg_ici / 1e6,
            wire_dcn_mb=leg_dcn / 1e6,
            data_axis=n_data,
            calibration_scale=scale,
            calibration_compute_scale=cscale,
            calibration_comms_scale=mscale,
        )

    # -- whole-candidate memory ----------------------------------------------

    def strategy_memory(self, strategy, graph_item, unroll=1, bucket_bytes=0,
                        batch_rows=None, kv_cache_bytes=0):
        """Predicted peak per-device HBM of ``strategy`` — the companion
        to :meth:`strategy_cost` the memory ledger
        (observability/memory.py) consumes.

        Walks the same per-variable branch structure ``_var_sync_cost``
        prices time with, but accumulates *bytes held* instead of seconds:

        * ``params_bytes``    — stored parameters (FSDP shards at 1/N,
          non-data shards at 1/k, everything else replicated in full);
        * ``optimizer_bytes`` — f32 state over exactly the elements the
          update-HBM term says this device updates (zero1/FSDP at 1/N);
        * ``gradients_bytes`` — the backward-materialized gradient
          (born reduce-scattered at 1/N for FSDP/zero1);
        * ``sync_state_bytes``— compressor residuals (error feedback)
          and PowerSGD P/Q factors;
        * ``activations_bytes`` — the forward's live-set peak
          (``GraphItem.activation_live_bytes``, aten outputs) at the sharded
          per-device batch; under a pipe axis the per-stage microbatch
          hold (GPipe retains M in-flight microbatches, so the stage's
          1/S slice of each stays resident — visible as ``hold_depth``);
        * ``staging_bytes``   — host->device input staging (``unroll=K``
          stacks K batches per dispatch, prefetch holds more) plus the
          largest in-flight all-reduce fusion bucket (capped at
          ``bucket_bytes`` when the bucket-size knob is set);
        * ``kv_cache_bytes``  — the decode engine's preallocated KV cache
          (``kv_cache_bytes``: the total bytes of one (slots, cache_len)
          lane, sharded over the data axis like any batch operand, so
          ``kv_cache_bytes / n_data`` per device).

        ``batch_rows`` rescales the batch-proportional classes (the
        activations and the input staging) to a different leading
        dimension (the serve engines' bucket check); default is the
        captured batch.

        The classes sum exactly to ``peak_bytes`` — no hidden terms.
        """
        unroll = max(1, int(unroll))
        axes = dict(strategy.graph_config.mesh_axes) or \
            {const.MESH_AXIS_DATA: self.topology.num_devices}
        n_data = max(1, axes.get(const.MESH_AXIS_DATA,
                                 self.topology.num_devices))
        n_pipe = axes.get(const.MESH_AXIS_PIPELINE, 1)

        from autodist_tpu_torch.proto import strategy_pb2
        C = strategy_pb2.AllReduceSynchronizer.Compressor
        opt_factor = _optimizer_state_factor(graph_item)

        params = opt = grads = sync_state = 0.0
        ar_buckets = {}
        for var in graph_item.trainable_variables:
            node = strategy.node_by_name(var.name)
            size = float(var.size_bytes)
            elems = float(var.num_elements)
            if node is None:  # replicated, full local update
                params += size
                opt += opt_factor * 4.0 * elems
                grads += size
                continue
            entries = _parse_partitioner_multi(node.partitioner)
            part = entries[0] if entries else None
            shard_axis_n = 1
            for _axis, num, mesh_axis in entries:
                if mesh_axis != const.MESH_AXIS_DATA:
                    shard_axis_n *= max(1, num)
            if shard_axis_n > 1:
                size /= shard_axis_n
                elems /= shard_axis_n
            which = node.WhichOneof("synchronizer")
            if which == "all_reduce_synchronizer":
                ar = node.all_reduce_synchronizer
                if part is not None and part[2] == const.MESH_AXIS_DATA:
                    # FSDP-flavored: the stored shard is 1/N of the
                    # variable; the gradient is born reduce-scattered by
                    # the gather VJP, state shards with the param.
                    params += size / n_data
                    opt += opt_factor * 4.0 * elems / n_data
                    grads += size / n_data
                    continue
                # Dense all-reduce: replicated storage, full gradient;
                # compressors hold extra local state.
                params += size
                opt += opt_factor * 4.0 * elems
                grads += size
                wire = size * _compressor_factor(ar.compressor, var)
                if ar.compressor in (C.HorovodCompressorEF,
                                     C.Int8CompressorEF):
                    # Error-feedback residual: one f32 gradient-shaped
                    # buffer per variable, except the hierarchical family
                    # (spec: DCN), whose residual lives on the DCN-leg
                    # shard: 1/d of the gradient per device.
                    if _hier_codec_for(node) and \
                            self.topology.devices_per_host > 1 and \
                            self.topology.num_hosts > 1:
                        sync_state += size / self.topology.devices_per_host
                    else:
                        sync_state += size
                elif ar.compressor == C.PowerSGDCompressor:
                    # P/Q low-rank factors persist across steps.
                    sync_state += wire
                ar_buckets[ar.group] = ar_buckets.get(ar.group, 0.0) + wire
                continue
            if which == "ps_synchronizer":
                ps = node.ps_synchronizer
                if ps.staleness > 0:
                    # Stale local SGD: fully local replica + full state.
                    params += size
                    opt += opt_factor * 4.0 * elems
                    grads += size
                    continue
                # ZeRO-1: params replicated for compute, optimizer state
                # and the reduce-scattered gradient shard at 1/N.
                params += size
                opt += opt_factor * 4.0 * elems / n_data
                grads += size / n_data
                continue
            params += size
            opt += opt_factor * 4.0 * elems
            grads += size

        # Activation live set at the per-device batch shard.
        captured = max(1, graph_item.batch_size or 1)
        rows = max(1, int(batch_rows) if batch_rows else captured)
        row_scale = rows / captured
        acts = graph_item.activation_live_bytes() * row_scale / n_data
        detail = {}
        mb = int(strategy.graph_config.pipeline_microbatches or 0)
        if n_pipe > 1:
            mb = mb or 2 * n_pipe
            # GPipe: each stage holds its 1/S activation slice of every
            # in-flight microbatch until that microbatch's backward —
            # M microbatches deep, each 1/M of the device batch, so the
            # stage's resident hold is A_dev/S regardless of M.  1F1B
            # caps the in-flight depth at min(S, M): a stage starts a
            # microbatch's backward before admitting the next, so the
            # hold shrinks to A_dev/S * min(S,M)/M.  The retention DEPTH
            # (the schedule's memory-vs-bubble trade) is surfaced so
            # rankings show what M and the schedule buy.
            schedule = (const.ENV.AUTODIST_PIPELINE_SCHEDULE.val or
                        "shift").strip().lower()
            hold = min(n_pipe, mb) if schedule == "1f1b" else mb
            acts = acts / n_pipe * (hold / float(mb))
            detail = {"hold_depth": hold, "microbatches": mb,
                      "pipeline_stages": n_pipe}

        # Input staging: K unrolled batches per dispatch, plus the
        # prefetch pipeline's in-flight copies, at the per-device shard.
        batch_dev = _batch_bytes(graph_item) * row_scale / n_data
        prefetch = max(0, int(const.ENV.AUTODIST_PREFETCH_DEPTH.val))
        staging = batch_dev * unroll * (1 + prefetch)
        # Largest in-flight collective staging buffer: one fusion bucket
        # (capped by the bucket-size knob when set).
        cap = max(0, int(bucket_bytes or 0))
        if ar_buckets:
            largest = max(ar_buckets.values())
            staging += min(largest, cap) if cap else largest

        return MemoryBreakdown(
            params_bytes=params,
            optimizer_bytes=opt,
            gradients_bytes=grads,
            sync_state_bytes=sync_state,
            activations_bytes=acts,
            staging_bytes=staging,
            kv_cache_bytes=max(0.0, float(kv_cache_bytes or 0)) / n_data,
            unroll=unroll,
            data_axis=n_data,
            batch_rows=rows,
            capacity_bytes=self.topology.hbm_capacity_bytes,
            **detail,
        )

    def _pipeline_imbalance(self, graph_item, num_stages):
        """Stage-cut imbalance (max/mean - 1) for the bubble term; cached
        per (graph_item, S).  0.0 when the program is untraceable."""
        cache = getattr(graph_item, "_pipeline_imbalance_cache", None)
        if cache is None:
            cache = {}
            try:
                graph_item._pipeline_imbalance_cache = cache
            except Exception:  # noqa: BLE001 - cache is an optimization
                pass
        if num_stages not in cache:
            try:
                from autodist_tpu_torch.pipeline import cutter
                cache[num_stages] = cutter.cut_stages(
                    graph_item, num_stages,
                    calibration=self.calibration).imbalance
            except Exception:  # noqa: BLE001 - imbalance is advisory
                cache[num_stages] = 0.0
        return cache[num_stages]


def _batch_bytes(graph_item):
    """Per-step batch footprint in bytes (0 when unknown)."""
    import numpy as np
    total = 0.0
    bs = graph_item.batch_size or 1
    for t in (graph_item.batch_spec or []):
        dims = [bs if s is None else s for s in t.shape] or [1]
        total += float(np.prod(dims, dtype=np.float64)) * t.dtype.itemsize
    return total

