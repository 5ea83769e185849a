"""Tensor- and expert-parallel sharding rules (Megatron-style column / row
splits; the experts of an MoE layer).

Counterpart of ``autodist_tpu/parallel/sharding_rules.py``, with the same
rule table and the same annotation: a rule maps a parameter-name pattern
to the dim of the weight that lives on the ``model`` mesh axis, written as
the node's partitioner ``"<dim>:<size>:<mesh_axis>"``. A variable split
over two axes carries two entries (``"0:2:pipe,2:2:model"``); no builder
writes one (the JAX package's automap does), and the piece rules below
take a stacked Megatron weight's dim one further and an MoE layer's
hidden columns over ``model``.

Attention q/k/v and the MLP up projection are column-parallel (the output
dim split); attention out and the MLP down projection are row-parallel
(the input dim split; their biases stay whole); the embedding table splits
its hidden dim. The JAX package leaves the collectives to GSPMD; here the
model layers run the Megatron forms on the pieces (``models/layers.py``),
the MoE layer its experts' share (``parallel/moe.py``, whose
``EXPERT_RULES`` split over the ``expert`` axis), and the Runner gathers
every other split parameter at use (``runner.py``).
"""
import re

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging

# (regex over the logical variable name, weight dim to place on `model`).
# Kernels are (in_dim, out_dim): column-parallel => dim 1, row-parallel =>
# dim 0.
MEGATRON_RULES = (
    (r"attn/(query|key|value)/kernel$", 1),
    (r"attn/(query|key|value)/bias$", 0),
    (r"attn/out/kernel$", 0),          # row-parallel; bias replicated
    (r"mlp/up/kernel$", 1),
    (r"mlp/up/bias$", 0),
    (r"mlp/down/kernel$", 0),          # row-parallel; bias replicated
    (r"embed/embedding$", 1),          # hidden-dim sharding
)


# The rules of the weights the Megatron layers take as their pieces
# (``models/layers.py``: ``mha`` and the MLP of ``transformer.block_apply``):
# every rule but the embedding table's, which is gathered at use.
_LAYER_RULES = tuple((re.compile(p), dim) for p, dim in MEGATRON_RULES
                     if not p.startswith("embed"))


def megatron_rules():
    return MEGATRON_RULES


def megatron_pieces(names, split, stacked=frozenset()):
    """The variables of ``names`` that reach the Megatron layers as their
    pieces, given ``split`` ({name: dim} of the variables split over the
    model axis): each weight of an ``attn`` or ``mlp`` scope that a layer
    rule names, where every such weight of that scope is split on its
    rule's dim. A weight of ``stacked`` (a stacked block variable, split
    over ``pipe`` on its layer dim 0) is split one dim further: its rule's
    dim + 1. A scope split otherwise (custom rules, an indivisible width)
    has its split weights gathered at use."""
    scopes = {}
    for name in names:
        for pat, dim in _LAYER_RULES:
            match = pat.search(name)
            if match:
                scope = name[:match.start()] + match.group(0).split("/")[0]
                scopes.setdefault(scope, []).append(
                    (name, dim + (name in stacked)))
                break
    return frozenset(name for members in scopes.values()
                     if all(split.get(n) == d for n, d in members)
                     for name, _ in members)


_EXPERT_LAYER = re.compile(r"moe/(up|down)/kernel$")

# The dims of an MoE layer's expert kernels (up (E, d, h), down (E, h, d))
# that each axis splits when the layer takes them as its pieces: the experts
# over ``expert``; the hidden columns of up and the rows of down over
# ``model`` (the Megatron column / row split of every expert's FFN).
_EXPERT_DIMS = {const.MESH_AXIS_EXPERT: {"up": 0, "down": 0},
                const.MESH_AXIS_MODEL: {"up": 2, "down": 1}}


def expert_pieces(names, split, axis=const.MESH_AXIS_EXPERT):
    """The variables of ``names`` that reach the MoE layer
    (``parallel/moe.py``) as their pieces over ``axis``, given ``split``
    ({name: dim} of the variables split over that axis): a ``moe`` scope's
    ``up/kernel`` and ``down/kernel`` where both are split on the axis's
    dims (``expert``: dim 0 of each, the experts; ``model``: up's dim 2
    and down's dim 1, each expert's hidden columns). The gate kernel,
    split on its expert dim 1 by ``moe.EXPERT_RULES``, is gathered at use
    (d x E: small); so is a scope split otherwise."""
    want = _EXPERT_DIMS[axis]
    scopes = {}
    for name in names:
        match = _EXPERT_LAYER.search(name)
        if match:
            scopes.setdefault(name[:match.start()], []).append(
                (name, want[match.group(1)]))
    return frozenset(
        name for members in scopes.values() if len(members) == 2 and
        all(split.get(n) == d for n, d in members) for name, _ in members)


def apply_sharding_rules(strategy, graph_item, model_axis_size, rules=None,
                         mesh_axis=None):
    """Annotate a Strategy's node configs with TP / EP partitioners.

    For every trainable variable whose name matches a rule (the first rule
    that matches decides), set ``partitioner = "<dim>:<size>[:<mesh_axis>]"``.
    A dim that the axis does not divide stays replicated.
    """
    rules = rules or MEGATRON_RULES
    compiled = [(re.compile(p), axis) for p, axis in rules]
    nodes = {n.var_name: n for n in strategy.node_config}
    suffix = f":{mesh_axis}" if mesh_axis else ""
    n_applied = 0
    for var in graph_item.trainable_variables:
        for pat, axis in compiled:
            if pat.search(var.name):
                node = nodes.get(var.name)
                if node is None:
                    continue
                if axis < len(var.shape) and \
                        var.shape[axis] % model_axis_size == 0:
                    node.partitioner = f"{axis}:{model_axis_size}{suffix}"
                    n_applied += 1
                break
    logging.info("sharding rules: tensor-partitioned %d variables %d-way%s",
                 n_applied, model_axis_size,
                 f" on '{mesh_axis}'" if mesh_axis else "")
    return strategy
