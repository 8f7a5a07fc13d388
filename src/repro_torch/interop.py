"""Hand state of the reference package to the port, by attribute.

The port never imports the JAX package. These helpers read the numpy
fields of the reference's ``Graph``, ``TreeTopology`` / ``RoutingTopology``,
``MachineSpec``, ``PartitionConfig`` and ``RefineConfig`` by name (duck
typing) and build the port's own objects, so a test can give both packages
the same inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.machine import Level, MachineSpec
from repro_torch.core.partitioner import PartitionConfig
from repro_torch.core.refine import RefineConfig
from repro_torch.core.topology import RoutingTopology, TreeTopology
from repro_torch.graph.graph import Graph


def _copy(x):
    return None if x is None else np.array(x, copy=True)


def graph_from_arrays(obj) -> Graph:
    """Port ``Graph`` with the same arrays as ``obj``."""
    return Graph(n_nodes=int(obj.n_nodes), senders=_copy(obj.senders),
                 receivers=_copy(obj.receivers),
                 edge_weight=_copy(obj.edge_weight),
                 node_weight=_copy(obj.node_weight),
                 offsets=_copy(obj.offsets))


def _machine_from(obj) -> MachineSpec:
    fields = {f.name: getattr(obj, f.name)
              for f in dataclasses.fields(MachineSpec)}
    fields["levels"] = tuple(Level(name=l.name, fanout=int(l.fanout),
                                   gbps=float(l.gbps)) for l in obj.levels)
    return MachineSpec(**fields)


def topology_from_arrays(obj):
    """Port twin of a reference ``TreeTopology``, ``RoutingTopology`` or
    ``MachineSpec`` (read by attribute)."""
    if hasattr(obj, "mesh_shape"):
        return _machine_from(obj)
    if hasattr(obj, "path_links"):
        return RoutingTopology(k=int(obj.k), n_links=int(obj.n_links),
                               path_links=_copy(obj.path_links),
                               path_frac=_copy(obj.path_frac),
                               F_l=_copy(obj.F_l))
    return TreeTopology(
        parent=_copy(obj.parent), is_router=_copy(obj.is_router),
        link_cost=_copy(obj.link_cost), compute_bins=_copy(obj.compute_bins),
        subtree=_copy(obj.subtree), link_nodes=_copy(obj.link_nodes),
        F_l=_copy(obj.F_l), bin_speed=_copy(obj.bin_speed))


def partition_config_from(obj):
    """Port ``PartitionConfig`` or ``RefineConfig`` with the same fields as
    ``obj`` (a ``PartitionConfig`` is recognised by its ``refine`` field)."""
    if hasattr(obj, "refine"):
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(PartitionConfig)}
        fields["refine"] = partition_config_from(obj.refine)
        return PartitionConfig(**fields)
    return RefineConfig(**{f.name: getattr(obj, f.name)
                           for f in dataclasses.fields(RefineConfig)})
