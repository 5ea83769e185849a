"""Stage cutter: balanced pipeline stages from per-scope predicted costs.

Counterpart of ``autodist_tpu/pipeline/cutter.py``. The cutter answers
"where do the pipeline stages go, and how balanced are they" from the
captured program alone: :meth:`GraphItem.op_provenance` gives every traced
op's :func:`~autodist_tpu_torch.utils.scope.named_scope` path and FLOPs,
:func:`top_level_costs` sums them per *top-level* scope in trace order,
:func:`cut_stages` finds the repeated-layer run (``layer0..layerN``
sibling scopes, or the single ``blocks`` scope of the stacked layout) and
partitions it into S contiguous stages minimizing the max stage cost
(exact DP over the cut points, with the JAX package's deterministic
``(rounded cost, boundaries)`` tie-break), and :func:`resolve_stages`
picks S itself when nothing else fixes it.

Ops with no scope are charged to the nearest enclosing top-level scope in
trace order (the prelude before any scope to the first group), never
dropped, so the stages sum EXACTLY to ``flops_estimate()``. A
calibration's ``scope_scales()`` (duck-typed, as in the JAX package)
scales each scope's compute before the cut.

One difference from the JAX package: its ``blocks`` scope traces the scan
body once, the port's runs all L layers. So the stacked layout's L layers
``blocks[i]`` are each the ``blocks`` group divided by L: the cut's JSON
is the JAX one, and the port's stages still sum to its own
``flops_estimate()`` (which, unlike the JAX one, counts every layer).
"""
import re

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

#: Scope name of a repeated block: any prefix and a trailing integer index
#: ("layer3"; top-levels like "stage2").
_INDEXED = re.compile(r"^(?P<prefix>.*?)(?P<idx>\d+)$")

# Last StageCut produced in this process.
_last_cut = None


def last_cut():
    return _last_cut


def set_last_cut(cut):
    global _last_cut
    _last_cut = cut


class StageCut:
    """An assignment of model scopes to S pipeline stages."""

    def __init__(self, stages, total_flops, num_layers, layer_prefix,
                 source="auto"):
        self.stages = stages            # [{"scopes", "flops", "bytes"}]
        self.total_flops = total_flops  # == the sum of the ops' flops
        self.num_layers = num_layers
        self.layer_prefix = layer_prefix  # "" for a program without layers
        self.source = source            # "explicit" | "env" | "hint" | "auto"

    @property
    def num_stages(self):
        return len(self.stages)

    @property
    def imbalance(self):
        """max stage cost / mean stage cost - 1 over the pipelined layers
        (0.0 == perfectly even)."""
        costs = [s.get("layer_flops", s["flops"]) for s in self.stages]
        mean = sum(costs) / max(1, len(costs))
        if mean <= 0:
            return 0.0
        return max(costs) / mean - 1.0

    def to_json(self):
        return {
            "num_stages": self.num_stages,
            "num_layers": self.num_layers,
            "layer_prefix": self.layer_prefix,
            "source": self.source,
            "imbalance": round(self.imbalance, 4),
            "total_flops": self.total_flops,
            "stages": [{"scopes": list(s["scopes"]),
                        "flops": s["flops"],
                        "share": (round(s["flops"] / self.total_flops, 4)
                                  if self.total_flops else 0.0)}
                       for s in self.stages],
        }


def top_level_costs(graph_item, calibration=None):
    """Per top-level-scope predicted FLOPs, in trace order:
    ``[(scope, flops, bytes)]``. Scope-less ops are charged to the nearest
    enclosing group (the most recent top-level scope in trace order, or
    the FIRST group for the prelude), never dropped, so ``sum(flops)`` is
    exactly the sum of every traced op's. A calibration's
    ``scope_scales()`` ratios multiply the matching scope's compute."""
    records = graph_item.op_provenance()
    if not records:
        return []
    order, agg = [], {}
    prelude = []  # records before the first scoped op
    current = None
    for rec in records:
        top = rec["scope"].split("/", 1)[0] if rec["scope"] else ""
        if not top:
            top = current  # nearest enclosing scope, in trace order
        if top is None:
            prelude.append(rec)
            continue
        if top not in agg:
            order.append(top)
            agg[top] = {"flops": 0.0, "bytes": 0.0}
        current = top if rec["scope"] else current
        agg[top]["flops"] += rec["flops"]
        agg[top]["bytes"] += rec["bytes"]
    if not order:
        # A fully scope-less program: one synthetic group holds everything.
        order.append("")
        agg[""] = {"flops": 0.0, "bytes": 0.0}
    for rec in prelude:  # the pre-scope prelude rides with the first group
        agg[order[0]]["flops"] += rec["flops"]
        agg[order[0]]["bytes"] += rec["bytes"]
    scales = {}
    if calibration is not None:
        try:
            scales = calibration.scope_scales()
        except Exception as e:  # noqa: BLE001 - calibration is best-effort
            logging.debug("scope scales unavailable: %s", e)
    out = []
    for scope in order:
        scale = float(scales.get(scope, {}).get("compute", 1.0))
        out.append((scope, agg[scope]["flops"] * scale,
                    agg[scope]["bytes"]))
    return out


def _layer_run(groups):
    """Longest run of consecutive same-prefix indexed scopes: ``(start,
    end, prefix)``, the half-open range in ``groups``, or ``None`` when
    the model has none (the stacked ``blocks`` layout among them)."""
    best = None
    i = 0
    while i < len(groups):
        m = _INDEXED.match(groups[i][0])
        if not m:
            i += 1
            continue
        prefix, idx = m.group("prefix"), int(m.group("idx"))
        j = i + 1
        nxt = idx + 1
        while j < len(groups):
            m2 = _INDEXED.match(groups[j][0])
            if not m2 or m2.group("prefix") != prefix or \
                    int(m2.group("idx")) != nxt:
                break
            nxt += 1
            j += 1
        if j - i >= 2 and (best is None or j - i > best[1] - best[0]):
            best = (i, j, prefix)
        i = j if j > i + 1 else i + 1
    return best


def _balanced_partition(costs, k):
    """Cut ``costs`` into k contiguous groups minimizing the max group
    sum. Exact DP; ties broken by the lexicographically smallest boundary
    tuple on the ROUNDED cost, so every process computes the same cut.
    Returns the list of boundary indices (length k-1)."""
    n = len(costs)
    k = max(1, min(k, n))
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def span(i, j):  # cost of [i, j)
        return prefix[j] - prefix[i]

    best = {(0, 0): (0.0, ())}
    for g in range(1, k + 1):
        for j in range(g, n - (k - g) + 1):
            cand = None
            for i in range(g - 1, j):
                prev = best.get((i, g - 1))
                if prev is None:
                    continue
                cost = max(prev[0], round(span(i, j), 6))
                bounds = prev[1] + ((i,) if g > 1 else ())
                key = (cost, bounds)
                if cand is None or key < cand:
                    cand = key
            if cand is not None:
                best[(j, g)] = cand
    return list(best[(n, k)][1])


def cut_stages(graph_item, num_stages, calibration=None, source="auto"):
    """Partition the model's repeated-layer run into ``num_stages``
    balanced stages; returns a :class:`StageCut`.

    The indexed layout (``layer0..layerN``) is cut by predicted per-layer
    FLOPs. The stacked layout's ``blocks`` group holds its L layers, so
    each ``blocks[i]`` is 1/L of it: homogeneous, so the cut is the
    contiguous L/S split ``scan_blocks`` runs and the imbalance reflects
    only a layer count S does not divide. A program with no provenance
    (a metadata-only item) gets a uniform synthetic cut (imbalance 0)."""
    num_stages = max(1, int(num_stages))
    groups = top_level_costs(graph_item, calibration)
    num_layers = _stacked_layer_count(graph_item)
    if not groups:
        stages = [{"scopes": (f"stage{i}",), "flops": 0.0, "bytes": 0.0}
                  for i in range(num_stages)]
        return StageCut(stages, 0.0, num_layers or num_stages, "",
                        source=source)
    total = sum(f for _, f, _ in groups)

    run = _layer_run(groups)
    if run is None and num_layers:
        bi = next((i for i, (s, _, _) in enumerate(groups)
                   if s == "blocks"), None)
        if bi is not None:
            per_layer = groups[bi][1] / num_layers
            per_bytes = groups[bi][2] / num_layers
            synth = [(f"blocks[{i}]", per_layer, per_bytes)
                     for i in range(num_layers)]
            groups = groups[:bi] + synth + groups[bi + 1:]
            total = sum(f for _, f, _ in groups)
            run = (bi, bi + num_layers, "blocks[")
    if run is None:
        # No repeated run: cut the whole top-level sequence.
        run = (0, len(groups), "")

    start, end, prefix = run
    layers = groups[start:end]
    bounds = _balanced_partition([f for _, f, _ in layers], num_stages)
    edges = [0] + bounds + [len(layers)]
    stages = []
    for s in range(min(num_stages, len(layers))):
        chunk = layers[edges[s]:edges[s + 1]]
        flops = sum(f for _, f, _ in chunk)
        stages.append({"scopes": tuple(n for n, _, _ in chunk),
                       "flops": flops, "layer_flops": flops,
                       "bytes": sum(b for _, _, b in chunk)})
    while len(stages) < num_stages:  # fewer layers than stages
        stages.append({"scopes": (), "flops": 0.0, "layer_flops": 0.0,
                       "bytes": 0.0})
    # The prelude (embed, ...) rides with the first stage and the postlude
    # (final norm, head, loss) with the last: they run outside the
    # pipelined stack, but the ledger must sum to the program's total.
    for g in groups[:start]:
        stages[0]["flops"] += g[1]
        stages[0]["bytes"] += g[2]
        stages[0]["scopes"] = (g[0],) + tuple(stages[0]["scopes"])
    for g in groups[end:]:
        stages[-1]["flops"] += g[1]
        stages[-1]["bytes"] += g[2]
        stages[-1]["scopes"] = tuple(stages[-1]["scopes"]) + (g[0],)
    return StageCut(stages, total, end - start, prefix, source=source)


def _stacked_layer_count(graph_item):
    """Leading dim of the stacked ``blocks/`` variables (0 when absent)."""
    for v in graph_item.trainable_variables:
        if ("blocks/" in v.name or v.name.startswith("blocks/")) and v.shape:
            return int(v.shape[0])
    return 0


def resolve_microbatches(graph_item, num_stages, explicit=None):
    """The GPipe microbatch count M for ``num_stages``: an explicit count
    wins untouched; else ``AUTODIST_MICROBATCHES``, else ``2 *
    num_stages``, and a defaulted count that does not divide the captured
    batch falls back to the largest divisor of the batch."""
    num_microbatches = int(
        explicit or const.ENV.AUTODIST_MICROBATCHES.val or 2 * num_stages)
    batch = int(graph_item.batch_size or 0)
    if not explicit and batch and batch % num_microbatches:
        for m in range(min(num_microbatches, batch), 0, -1):
            if batch % m == 0:
                return m
    return num_microbatches


def resolve_stages(graph_item, resource_spec, explicit=None):
    """The stage count S: explicit arg > ``AUTODIST_PIPELINE_STAGES`` > the
    spec's ``pipeline:`` mesh hint > the cutter's own choice: of the
    counts 2-8 that divide both the stacked layers and the devices, the
    one with the least predicted step share a rank, ``(1 + imbalance) (M
    + S - 1) / (M S)`` at the default M = 2 S. Returns ``(num_stages,
    source)``; ``(1, "auto")`` means "don't pipeline"."""
    if explicit:
        return int(explicit), "explicit"
    env = const.ENV.AUTODIST_PIPELINE_STAGES.val
    if env and int(env) > 1:
        return int(env), "env"
    hint = int(resource_spec.mesh_hints.get(const.MESH_AXIS_PIPELINE, 0) or 0)
    n = max(1, len(resource_spec.accelerator_devices))
    if hint > 1 and n % hint == 0:
        return hint, "hint"
    layers = _stacked_layer_count(graph_item)
    if not layers:
        return 1, "auto"
    best = None
    for k in range(2, min(8, layers, n) + 1):
        if n % k or layers % k:
            continue
        cut = cut_stages(graph_item, k)
        m = 2 * k  # the default microbatch count the builder would pick
        # Per-rank step share: the bubble-stretched max-stage cost.
        share = (1.0 + cut.imbalance) * (m + k - 1) / (m * k)
        key = (round(share, 6), k)
        if best is None or key < best:
            best = (key[0], k)
    return (best[1], "auto") if best else (1, "auto")
