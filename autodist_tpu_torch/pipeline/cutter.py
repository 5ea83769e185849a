"""Stage cutter: where the pipeline stages go.

Counterpart of ``autodist_tpu/pipeline/cutter.py``. Ported: the
:class:`StageCut` record, ``last_cut`` / ``set_last_cut``, the exact
balanced partition (:func:`_balanced_partition`, with the JAX
deterministic tie-break), :func:`_stacked_layer_count`,
:func:`resolve_microbatches`, :func:`resolve_stages` (explicit, then
``AUTODIST_PIPELINE_STAGES``, then the spec's ``pipeline:`` mesh hint) and
:func:`cut_stages` for the stacked ``scan_blocks`` layout (the contiguous
L/S split ``scan_blocks`` runs) and its uniform cut for a program without
layers.

Not ported: the per-scope predicted costs. The JAX cutter reads
``GraphItem.op_provenance`` / ``scope_costs`` (ROADMAP.md, Queue A item
A4), so :func:`top_level_costs`, ``cut_stages`` under a calibration, and
``resolve_stages``'s cost-based choice for a stacked model raise
``NotImplementedError`` naming A4 rather than return a cut or a stage
count that could differ from the JAX one.
"""
from autodist_tpu_torch import const

# Last StageCut produced in this process.
_last_cut = None

_A4 = ("the per-scope cost model (GraphItem.op_provenance / scope_costs) "
       "is not ported to autodist_tpu_torch yet (ROADMAP.md, Queue A item "
       "A4)")


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
        self.total_flops = total_flops
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
    """Per top-level-scope predicted FLOPs: not ported (A4)."""
    raise NotImplementedError(f"top_level_costs: {_A4}")


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
    """The stages of ``num_stages`` for the stacked ``scan_blocks`` layout:
    L homologous layers ``blocks[i]`` cut into the contiguous L/S runs
    ``scan_blocks`` executes (equal costs: the cut is the balanced one and
    its imbalance reflects only a layer count S does not divide); a
    program without stacked layers gets the uniform synthetic cut. Without
    the per-scope cost model (A4) the stages carry no FLOPs, and a
    calibration raises."""
    if calibration is not None:
        raise NotImplementedError(f"cut_stages(calibration=): {_A4}")
    num_stages = max(1, int(num_stages))
    num_layers = _stacked_layer_count(graph_item)
    if not num_layers:
        stages = [{"scopes": (f"stage{i}",), "flops": 0.0, "bytes": 0.0}
                  for i in range(num_stages)]
        return StageCut(stages, 0.0, num_stages, "", source=source)
    bounds = _balanced_partition([1.0] * num_layers, num_stages)
    edges = [0] + bounds + [num_layers]
    stages = [{"scopes": tuple(f"blocks[{i}]" for i in
                               range(edges[s], edges[s + 1])),
               "flops": 0.0, "layer_flops": float(edges[s + 1] - edges[s]),
               "bytes": 0.0}
              for s in range(min(num_stages, num_layers))]
    while len(stages) < num_stages:  # fewer layers than stages
        stages.append({"scopes": (), "flops": 0.0, "layer_flops": 0.0,
                       "bytes": 0.0})
    return StageCut(stages, 0.0, num_layers, "blocks[", source=source)


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
    spec's ``pipeline:`` mesh hint > the cutter's own choice. Returns
    ``(num_stages, source)``; ``(1, "auto")`` means "don't pipeline": no
    stacked layers, or no stage count of 2-8 that divides both the layers
    and the devices. Where there is one, the cutter's choice prices each
    with the per-scope costs, which are not ported (A4): it raises."""
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
    if not any(n % k == 0 and layers % k == 0
               for k in range(2, min(8, layers, n) + 1)):
        return 1, "auto"  # no divisor to price: the JAX answer, no costs
    raise NotImplementedError(
        f"Pipeline's own choice of the stage count: {_A4}; pass "
        f"num_stages=, set AUTODIST_PIPELINE_STAGES, or add a 'pipeline:' "
        f"mesh hint to the resource spec")
