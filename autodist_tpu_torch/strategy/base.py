"""Strategy representation, builder ABC, and compiler.

Counterpart of ``autodist_tpu/strategy/base.py`` on the byte-identical copy
of ``strategy_pb2``: a ``Strategy`` built here serializes to the same bytes
as the JAX package's for the same metadata (ids aside).
"""
import itertools
import os
import time
from abc import ABC, abstractmethod

from autodist_tpu_torch import const
from autodist_tpu_torch.proto import strategy_pb2
from autodist_tpu_torch.utils import logging

_strategy_counter = itertools.count()


class Strategy:
    """Wrapper of the ``Strategy`` proto."""

    def __init__(self, proto=None):
        self._proto = proto or strategy_pb2.Strategy()
        if not self._proto.id:
            # timestamp + pid + per-process counter: unique within a second.
            self._proto.id = (time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) +
                              f"-{os.getpid()}-{next(_strategy_counter)}")

    @property
    def proto(self):
        return self._proto

    @property
    def id(self):
        return self._proto.id

    @property
    def node_config(self):
        return self._proto.node_config

    @property
    def graph_config(self):
        return self._proto.graph_config

    def node_by_name(self, var_name):
        for n in self._proto.node_config:
            if n.var_name == var_name:
                return n
        return None

    def copy(self):
        new = strategy_pb2.Strategy()
        new.CopyFrom(self._proto)
        return Strategy(new)

    def __str__(self):
        return str(self._proto)


class StrategyBuilder(ABC):
    """Policy that maps (GraphItem, ResourceSpec) -> Strategy."""

    @abstractmethod
    def build(self, graph_item, resource_spec):
        """Generate the per-variable distribution strategy."""

    @staticmethod
    def _base_strategy(resource_spec, mesh_axes=None):
        """A Strategy with the replica list and mesh layout filled in;
        default layout: every accelerator device on the data axis."""
        s = Strategy()
        for d in resource_spec.accelerator_devices:
            s.graph_config.replicas.append(d.name_string())
        if not mesh_axes:
            mesh_axes = {const.MESH_AXIS_DATA:
                         len(resource_spec.accelerator_devices)}
        for axis, size in mesh_axes.items():
            s.graph_config.mesh_axes[axis] = size
        return s


class StrategyCompiler:
    """Resolve an abstract Strategy against a live mesh: prune node
    configs of variables absent from (or non-trainable in) the captured
    program and validate mesh-axis references."""

    def __init__(self, graph_item, mesh):
        self._graph_item = graph_item
        self._mesh = mesh

    def compile(self, strategy):
        strategy = strategy.copy()
        known = {v.name for v in self._graph_item.variables}
        trainable = {v.name for v in self._graph_item.trainable_variables}
        unknown = [n.var_name for n in strategy.node_config
                   if n.var_name not in known]
        if unknown:
            logging.warning(
                "StrategyCompiler: strategy names %d variable(s) absent from "
                "the captured program (stale strategy or renamed params?); "
                "pruning: %s", len(unknown), unknown[:5])
        kept = [n for n in strategy.node_config if n.var_name in trainable]
        del strategy.proto.node_config[:]
        strategy.proto.node_config.extend(kept)
        mesh_axis_names = set(self._mesh.axis_names)
        for node in strategy.node_config:
            self._check_node(node, mesh_axis_names)
        return strategy

    def _check_node(self, node, mesh_axis_names):
        if node.WhichOneof("synchronizer") == "ps_synchronizer":
            axis = node.ps_synchronizer.reduction_destination or \
                const.MESH_AXIS_DATA
            if axis not in mesh_axis_names:
                raise ValueError(
                    f"Strategy references mesh axis '{axis}' for "
                    f"{node.var_name}, but mesh has axes "
                    f"{sorted(mesh_axis_names)}")
        for part in node.part_config:
            self._check_node(part, mesh_axis_names)
