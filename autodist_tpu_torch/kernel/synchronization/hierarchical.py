"""Two-level topology-aware collectives: full precision inside a host,
quantized across hosts.

Counterpart of ``autodist_tpu/kernel/synchronization/hierarchical.py``. One
gradient mean over the data group is split into three legs over the
topology (the EQuARX family: quantize inside the collective):

  1. a full-precision reduce-scatter over the intra-host (ICI) group;
  2. the all-reduce of the 1/d shard across hosts (DCN), its wire the DCN
     codec's: ``f32``, ``bf16``, ``int8`` or ``int8ef`` (int8 with error
     feedback on the shard);
  3. a full-precision all-gather back over the ICI group.

The ICI leg carries full-precision bytes and the DCN leg ``codec_factor x
(1/d)`` of the gradient: what ``Topology.hierarchical_ar_cost`` prices.

Leg layout over the data group's ranks in order (host-major, as the
resource spec lays them out): with d ranks a host and h hosts, ICI group
g_h = [h d .. h d + d - 1] and DCN group g_i = [i, d + i, 2d + i, ...].
The grouped transport runs each leg over a process subgroup (one
``new_group`` per ICI group and per DCN group, every rank making every
group in one order: :func:`leg_groups`, called where the mesh makes its
groups, ``Mesh.hier_groups``). The ring transport (``grouped=False``, the
JAX package's ppermute fallback) runs the same schedule as neighbour
exchanges over the data group itself (``all_to_all_single`` with zero
splits but one, ``parallel/collectives.exchange``).
:func:`hier_mean_nested` is the same schedule over the groups of an
explicit nested ``(dcn, ici)`` mesh (``Cluster.build_hierarchical_mesh``).

One host (h == 1) degenerates to the flat codec path, bitwise. The bf16
wire is real on NCCL and emulated on gloo (a cast round trip, the
collective in f32), as in ``compressor.py``.

The wire tally counts each reduce's per-rank received bytes per leg as it
runs (the JAX package counts them once per trace): read it around eager
steps, since a CUDA graph's replay runs no Python and adds nothing.
"""
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.partitioner import data_dim
from autodist_tpu_torch.kernel.synchronization import compressor as _comp
from autodist_tpu_torch.kernel.synchronization.compressor import (
    _INT8_BLOCK, _int8_quantize, int8_transport, mean_bf16_wire,
    mean_int8_wire, nccl_wire)

# DCN-leg wire bytes as a fraction of f32 (int8: 1 byte/elem + one f32
# scale per _INT8_BLOCK elems; kept equal to tuner/cost_model.py's).
CODEC_FACTORS = {
    "f32": 1.0,
    "bf16": 0.5,
    "int8": (1.0 + 4.0 / _INT8_BLOCK) / 4.0,
    "int8ef": (1.0 + 4.0 / _INT8_BLOCK) / 4.0,
}


def resolve_legs(world, devices_per_host=None):
    """Split a flat data group of ``world`` ranks into (ici, dcn) legs:
    ``(d, h)`` with ``d * h == world``. ``AUTODIST_HIER_ICI`` overrides the
    resource spec's hint (a knob to fake several hosts on one). Any invalid
    split (unknown, not a divisor, or >= world) degenerates to
    ``(world, 1)``: one all-ICI leg, the flat path."""
    world = int(world)
    d = int(const.ENV.AUTODIST_HIER_ICI.val or 0) or int(devices_per_host or 0)
    if d <= 0 or d >= world or world % d:
        return world, 1
    return d, world // d


def ici_groups(world, d):
    """Host-major intra-host groups: [[0..d-1], [d..2d-1], ...]."""
    return [[h * d + i for i in range(d)] for h in range(world // d)]


def dcn_groups(world, d):
    """Cross-host groups at equal ICI position: [[0, d, 2d..], [1, d+1..]]."""
    return [[h * d + i for h in range(world // d)] for i in range(d)]


def leg_groups(ranks, d, me=None):
    """Make the ICI and DCN process groups of a data group whose ranks (in
    data order) are ``ranks``: every ICI group, then every DCN group, each
    over the global ranks at those positions. ``new_group`` is collective
    over the world, so every rank calls this for every data group, in one
    order. Returns this rank's ``(ici, dcn)`` groups (None, None when it is
    not in ``ranks``)."""
    me = dist.get_rank() if me is None else me
    world = len(ranks)
    mine = [None, None]
    for slot, groups in enumerate((ici_groups(world, d),
                                   dcn_groups(world, d))):
        for positions in groups:
            members = [int(ranks[p]) for p in positions]
            group = dist.new_group(members)
            if me in members:
                mine[slot] = group
    return tuple(mine)


# ---------------------------------------------------------------------------
# The wire tally: every hierarchical (and degenerate-flat) reduce adds its
# per-rank received bytes per leg as it runs.
# ---------------------------------------------------------------------------
_WIRE_TALLY = {"ici": 0.0, "dcn": 0.0}


def reset_wire_tally():
    _WIRE_TALLY["ici"] = 0.0
    _WIRE_TALLY["dcn"] = 0.0


def wire_tally():
    """Per-rank wire bytes received per leg, summed over the reduces since
    the last :func:`reset_wire_tally`."""
    return dict(_WIRE_TALLY)


def _tally(leg, nbytes):
    _WIRE_TALLY[leg] += float(nbytes)


def _tally_hier(nbytes, d, h, codec):
    """Per-rank received bytes for one hierarchical reduce of ``nbytes``
    (f32 payload): RS + AG full precision on ICI, the codec's shard on DCN.
    Mirrors ``Topology.hier_wire_split`` exactly."""
    _tally("ici", 2.0 * nbytes * (d - 1) / d)
    f = CODEC_FACTORS[codec]
    shard = nbytes / d
    if codec.startswith("int8") and int8_transport(h) == "allgather":
        _tally("dcn", (h - 1) * shard * f)
    else:
        if codec.startswith("int8"):  # wide DCN leg: the bf16 switch
            f = CODEC_FACTORS["bf16"]
        _tally("dcn", 2.0 * shard * f * (h - 1) / h)


def _tally_flat(nbytes, d, h, factor=1.0):
    """Per-rank received bytes for a flat ring all-reduce of ``nbytes``
    whose ring spans ``h`` hosts."""
    w = nbytes * factor
    _tally("ici", 2.0 * w * (d - 1) / d)
    if h > 1:
        _tally("dcn", 2.0 * (w / d) * (h - 1) / h)


# ---------------------------------------------------------------------------
# DCN-leg codecs. Each takes this rank's full-precision intra-host shard sum
# ``rs`` (f32, 1-D, a multiple of _INT8_BLOCK long) and the EF state, with
# two transports:
#   psum_fn(x)   -> the sum of x over the h hosts of this rank's DCN group
#   gather_fn(x) -> x of the h hosts stacked, shape (h,) + x.shape
# and returns (the sum over all W ranks of this shard, new state).
# ---------------------------------------------------------------------------


def _bf16_psum(v, psum_fn, nccl):
    wire = v.to(torch.bfloat16)
    if nccl:
        return psum_fn(wire).to(v.dtype)
    return psum_fn(wire.to(v.dtype))


def _dcn_leg(rs, state, codec, h, psum_fn, gather_fn, nccl):
    if codec == "f32":
        return psum_fn(rs), state
    if codec == "bf16":
        return _bf16_psum(rs, psum_fn, nccl), state
    # The int8 family. A DCN leg past the transport crossover switches to
    # the bf16 wire, the flat Int8CompressorEF's policy.
    if int8_transport(h) == "ring":
        if codec == "int8ef":
            corrected = rs + state
            residual = corrected - corrected.to(torch.bfloat16).to(rs.dtype)
            return _bf16_psum(corrected, psum_fn, nccl), residual
        return _bf16_psum(rs, psum_fn, nccl), state
    corrected = rs + state if codec == "int8ef" else rs
    q, scale, pad = _int8_quantize(corrected)
    qs = gather_fn(q)                                   # (h, nblk, block) i8
    ss = gather_fn(scale)                               # (h, nblk, 1) f32
    summed = (qs.float() * ss).sum(dim=0).reshape(-1)
    if pad:
        summed = summed[:-pad]
    if codec == "int8ef":
        deq = (q.float() * scale).reshape(-1)
        if pad:
            deq = deq[:-pad]
        # The residual from the same (q, scale) that went on the wire.
        return summed, corrected - deq
    return summed, state


def _flat_degenerate(x, group, codec, state):
    """h == 1: the flat codec path, bitwise the compressors'."""
    if codec == "f32":
        return _comp.all_reduce_mean_(x.clone(), group), state
    if codec == "bf16":
        return mean_bf16_wire(x, group), state
    if codec == "int8":
        return mean_int8_wire(x, group), state
    # int8ef, flat: Int8CompressorEF.reduce (a full-gradient state).
    return _comp.Int8CompressorEF().reduce(x, state, group)


def padded_shard_len(n, d):
    """Length of the per-rank ICI shard of an n-element gradient: the flat
    vector is padded so every shard is whole int8 blocks (quantization
    blocks then never straddle shard boundaries)."""
    return (n + (-n) % (d * _INT8_BLOCK)) // d


def init_hier_state(n, d, h, codec, dtype=torch.float32, device=None):
    """EF state of one variable: a DCN-shard-shaped residual when the legs
    are real, the whole (flat) gradient when degenerate (flat EF)."""
    if codec != "int8ef":
        return ()
    if h == 1:
        return torch.zeros((n,), dtype=dtype, device=device)
    return torch.zeros((padded_shard_len(n, d),), dtype=torch.float32,
                       device=device)


def _pad_flat(x, d):
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    shard = padded_shard_len(n, d)
    pad = shard * d - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n, shard, pad


def _grouped_legs(flat, state, codec, d, h, ici, dcn):
    """The three legs over the ICI and DCN subgroups."""
    shard = flat.shape[0] // d
    rs = flat.new_empty(shard)
    dist.reduce_scatter_tensor(rs, flat, group=ici)

    def psum(v):
        dist.all_reduce(v, group=dcn)
        return v

    def gather(v):
        return _comp._gather(v, dcn)[0]
    total, st = _dcn_leg(rs, state, codec, h, psum, gather, nccl_wire(dcn))
    mean = total / (d * h)
    out = mean.new_empty(shard * d)
    dist.all_gather_into_tensor(out, mean.contiguous(), group=ici)
    return out, st


def hier_mean(x, group, codec="bf16", devices_per_host=None, state=(),
              grouped=True, groups=None):
    """Hierarchical mean of ``x`` over the data group ``group``; returns
    ``(mean, new_state)``. ``state`` is the EF residual for ``int8ef``
    (:func:`init_hier_state`), ``()`` otherwise. ``grouped=True`` runs the
    legs over ``groups`` (this rank's ``(ici, dcn)`` process groups,
    ``Mesh.hier_groups`` / :func:`leg_groups`); ``grouped=False`` over
    neighbour exchanges within ``group``."""
    w = dist.get_world_size(group)
    d, h = resolve_legs(w, devices_per_host)
    if h == 1:
        # Degenerate: the EF state is kept 1-D (init_hier_state); the flat
        # codec works on the gradient's shape.
        st_in = state.reshape(x.shape) if codec == "int8ef" else state
        out, st = _flat_degenerate(x, group, codec, st_in)
        _tally_flat(x.numel() * 4.0, w, 1, CODEC_FACTORS[codec])
        if codec == "int8ef":
            st = st.reshape(-1)
        return out, st
    shape, dtype = x.shape, x.dtype
    flat, n, shard, pad = _pad_flat(x, d)
    _tally_hier(n * 4.0, d, h, codec)
    if grouped:
        if groups is None or None in groups:
            raise ValueError(
                "hier_mean(grouped=True) needs this rank's (ici, dcn) "
                "process groups (Mesh.hier_groups / leg_groups)")
        out, st = _grouped_legs(flat, state, codec, d, h, *groups)
    else:
        out, st = _hier_mean_ring(flat, state, group, codec, d, h, shard)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(dtype), st


def _hier_mean_ring(flat, state, group, codec, d, h, shard):
    """The ring transport: the same three legs as neighbour exchanges over
    ``group`` (every hop within one ICI or one DCN group). ``flat`` is
    padded f32 of length ``shard * d``."""
    from autodist_tpu_torch.parallel.collectives import exchange
    idx = dist.get_rank(group)
    host, pos = idx // d, idx % d
    chunks = flat.reshape(d, shard)
    ici_next = host * d + (pos + 1) % d
    ici_prev = host * d + (pos - 1) % d
    dcn_next = ((host + 1) % h) * d + pos
    dcn_prev = ((host - 1) % h) * d + pos

    def hop(t, dst, src):
        out = torch.empty_like(t)
        exchange(t.contiguous(), out, group, dst=dst, src=src)
        return out

    # Leg 1: intra-host ring reduce-scatter, full precision. After d - 1
    # hops this rank holds the host's sum of chunk (pos + 1) mod d.
    c = chunks[pos]
    for step in range(d - 1):
        c = hop(c, ici_next, ici_prev) + chunks[(pos - step - 1) % d]
    own = (pos + 1) % d

    # Leg 2: cross-host ring all-reduce of the shard, the codec's wire.
    def ring_psum(v):
        acc, buf = v, v
        for _ in range(h - 1):
            buf = hop(buf, dcn_next, dcn_prev)
            acc = acc + buf
        return acc

    def ring_gather(v):
        out = v.new_zeros((h,) + tuple(v.shape))
        out[host] = v
        buf = v
        for step in range(h - 1):
            buf = hop(buf, dcn_next, dcn_prev)
            out[(host - step - 1) % h] = buf
        return out

    total, st = _dcn_leg(c, state, codec, h, ring_psum, ring_gather,
                         nccl_wire(group))
    mean = total / (d * h)

    # Leg 3: intra-host ring all-gather of the mean chunks.
    gath = mean.new_zeros((d, shard))
    gath[own] = mean
    buf = mean
    for step in range(d - 1):
        buf = hop(buf, ici_next, ici_prev)
        gath[(pos - step) % d] = buf
    return gath.reshape(-1), st


def hier_mean_nested(x, codec="bf16", state=(), ici_group=None,
                     dcn_group=None):
    """The same three legs over the groups of an explicit nested
    ``(dcn, ici)`` mesh (``Cluster.build_hierarchical_mesh``: its
    ``group("ici")`` and ``group("dcn")``); returns ``(mean, new_state)``."""
    d = dist.get_world_size(ici_group)
    h = dist.get_world_size(dcn_group)
    shape, dtype = x.shape, x.dtype
    flat, n, _shard, pad = _pad_flat(x, d)
    _tally_hier(n * 4.0, d, h, codec)
    out, st = _grouped_legs(flat, state, codec, d, h, ici_group, dcn_group)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(dtype), st


def program_wire_split(synchronizers, variables, world):
    """Predicted per-rank wire bytes per leg of a program's gradient
    reductions, the ``comms.wire_ici_bytes`` / ``comms.wire_dcn_bytes``
    gauges. ``variables`` maps name -> nbytes; only dense all-reduce
    synchronizers count (sharded-state and PS wire is priced by the cost
    model, not per leg here)."""
    from autodist_tpu_torch.proto import strategy_pb2
    C = strategy_pb2.AllReduceSynchronizer.Compressor
    factors = {C.NoneCompressor: 1.0, C.HorovodCompressor: 0.5,
               C.HorovodCompressorEF: 0.5,
               C.Int8Compressor: CODEC_FACTORS["int8"],
               C.Int8CompressorEF: CODEC_FACTORS["int8ef"]}
    ici = dcn = 0.0
    for name, sync in synchronizers.items():
        ckind = getattr(sync, "compressor_kind", None)
        if ckind is None or name not in variables:
            continue
        pconfig = getattr(sync, "pconfig", None)
        if pconfig is not None and pconfig.active:
            continue  # sharded-state variables: RS/AG wire, not a dense AR
        nbytes = float(variables[name])
        codec = getattr(sync, "hier_codec", None)
        d, h = resolve_legs(world, getattr(sync, "devices_per_host", None))
        if codec and h > 1:
            ici += 2.0 * nbytes * (d - 1) / d
            f = CODEC_FACTORS[codec]
            if codec.startswith("int8") and int8_transport(h) == "allgather":
                dcn += (h - 1) * (nbytes / d) * f
            elif codec.startswith("int8"):
                dcn += 2.0 * (nbytes / d) * CODEC_FACTORS["bf16"] * (h - 1) / h
            else:
                dcn += 2.0 * (nbytes / d) * f * (h - 1) / h
        else:
            f = factors.get(ckind, 1.0)
            w = nbytes * f
            ici += 2.0 * w * (d - 1) / d
            if h > 1:
                dcn += 2.0 * (w / d) * (h - 1) / h
    return {"ici": ici, "dcn": dcn}


def gather_wire_split(synchronizers, variables, world):
    """Predicted per-rank wire bytes per leg of one serve dispatch's
    parameter all-gathers (storage sharded over the data axis is gathered
    on every request): one (g-1)/g sweep whose shard hops cross hosts as
    the flat ring's do (``Topology.ag_wire_split``)."""
    ici = dcn = 0.0
    if world <= 1:
        return {"ici": ici, "dcn": dcn}
    for name, sync in synchronizers.items():
        if name not in variables:
            continue
        pconfig = getattr(sync, "pconfig", None)
        if pconfig is None or not pconfig.active:
            continue
        try:
            if data_dim(sync.param_spec()) is None:
                continue  # model / seq pieces: activations move, not params
        except Exception:  # noqa: BLE001 - axis missing from mesh etc.
            continue
        nbytes = float(variables[name])
        d, h = resolve_legs(world, getattr(sync, "devices_per_host", None))
        ici += nbytes * (d - 1) / d
        if h > 1:
            dcn += (nbytes / d) * (h - 1) / h
    return {"ici": ici, "dcn": dcn}
