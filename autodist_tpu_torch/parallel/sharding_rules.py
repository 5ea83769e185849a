"""Tensor- and expert-parallel sharding rules (Megatron-style column / row
splits; the experts of an MoE layer).

Counterpart of ``autodist_tpu/parallel/sharding_rules.py``, with the same
rule table and the same annotation: a rule maps a parameter-name pattern
to the dim of the weight that lives on the ``model`` mesh axis, written as
the node's partitioner ``"<dim>:<size>:<mesh_axis>"``.

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


def megatron_pieces(names, split):
    """The variables of ``names`` that reach the Megatron layers as their
    pieces, given ``split`` ({name: dim} of the variables split over the
    model axis): each weight of an ``attn`` or ``mlp`` scope that a layer
    rule names, where every such weight of that scope is split on its
    rule's dim. A scope split otherwise (custom rules, an indivisible
    width) has its split weights gathered at use."""
    scopes = {}
    for name in names:
        for pat, dim in _LAYER_RULES:
            match = pat.search(name)
            if match:
                scope = name[:match.start()] + match.group(0).split("/")[0]
                scopes.setdefault(scope, []).append((name, dim))
                break
    return frozenset(name for members in scopes.values()
                     if all(split.get(n) == d for n, d in members)
                     for name, _ in members)


_EXPERT_LAYER = re.compile(r"moe/(up|down)/kernel$")


def expert_pieces(names, split):
    """The variables of ``names`` that reach the MoE layer
    (``parallel/moe.py``) as their pieces, given ``split`` ({name: dim} of
    the variables split over the expert axis): a ``moe`` scope's
    ``up/kernel`` and ``down/kernel`` where both are split on dim 0 (the
    experts). The gate kernel, split on its expert dim 1 by
    ``moe.EXPERT_RULES``, is gathered at use (d x E: small); so is a scope
    split otherwise."""
    scopes = {}
    for name in names:
        match = _EXPERT_LAYER.search(name)
        if match:
            scopes.setdefault(name[:match.start()], []).append(name)
    return frozenset(
        name for members in scopes.values() if len(members) == 2 and
        all(split.get(n) == 0 for n in members) for name in members)


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
