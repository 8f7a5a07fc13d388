"""Hand state of the reference package to the port, by attribute.

The port never imports the JAX package. These helpers read the numpy
fields of the reference's ``Graph``, ``TreeTopology`` / ``RoutingTopology``,
``MachineSpec``, ``PartitionConfig``, ``RefineConfig`` and ``ShardPlan`` by
name (duck typing), or the two-tower, GNN (EquiformerV2 too) and
transformer parameter dicts
as numpy arrays, and build the port's own objects, so a test can give both packages
the same inputs. Gradients, AdamW moments and compression residuals of
the transformer and the GNNs map through ``transformer_params_from`` and
``gnn_tree_from`` as their parameters do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.machine import Level, MachineSpec
from repro_torch.core.partitioner import PartitionConfig
from repro_torch.core.refine import RefineConfig
from repro_torch.core.topology import RoutingTopology, TreeTopology
from repro_torch.embed.sharded_table import ShardPlan
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


def shard_plan_from(obj) -> ShardPlan:
    """Port ``ShardPlan`` with the same arrays as a reference one."""
    return ShardPlan(row_to_device=_copy(obj.row_to_device),
                     n_devices=int(obj.n_devices), order=_copy(obj.order),
                     perm=_copy(obj.perm), offsets=_copy(obj.offsets),
                     makespan=float(obj.makespan), machine=obj.machine)


def recsys_params_from(params) -> Dict[str, torch.Tensor]:
    """``TwoTower`` state dict (CPU tensors, for ``load_state_dict``) from
    the reference's two-tower param dict: ``item_table``, ``cat_table`` and
    the towers' ``{"w": [...], "b": [...], "ln"?}`` lists."""
    state = {name: torch.from_numpy(_copy(params[name]))
             for name in ("item_table", "cat_table")}
    for tower in ("user_tower", "item_tower"):
        p = params[tower]
        for field in ("w", "b"):
            for i, x in enumerate(p[field]):
                state[f"{tower}.{field}.{i}"] = torch.from_numpy(_copy(x))
        if "ln" in p:
            state[f"{tower}.ln"] = torch.from_numpy(_copy(p["ln"]))
    return state


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x``'s values and type; numpy has no bfloat16 of its
    own, so a bf16 array (``ml_dtypes``) goes through float32, exactly."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(_copy(x))


def _map_leaves(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists (the
    reference's parameter trees), keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _unstack(tree, li: int):
    """Layer ``li`` of a stacked subtree: every leaf's row ``li``."""
    return _map_leaves(lambda a: _tensor(np.asarray(a)[li]), tree)


def gnn_tree_from(params) -> Dict:
    """The port's functional GNN params (``models.gnn.init``'s or
    ``models.equiformer.init``'s layout: CPU tensors) from the reference's
    param dict of any kind: ``encode``, ``decode`` and MeshGraphNet's
    ``edge_encode`` (``{"w": [...], "b": [...], "ln"?}``) as they are, and
    the ``layers`` stacked on axis 0 (GIN ``mlp`` and ``eps``, PNA ``pre``
    and ``post``, MeshGraphNet ``edge`` and ``node``, EquiformerV2's
    nested ``conv1`` / ``conv2`` SO(2) dicts, ``rbf_mlp`` and its matrices
    and norms) unstacked into one dict per layer. Any tree of the params'
    structure maps the same way (gradients, AdamW moments)."""
    out = {}
    for key, sub in params.items():
        if key != "layers":
            out[key] = _map_leaves(_tensor, sub)
            continue
        depths = []
        _map_leaves(lambda a: depths.append(np.shape(a)[0]), sub)
        out[key] = [_unstack(sub, li) for li in range(depths[0])]
    return out


def gnn_params_from(params) -> Dict[str, torch.Tensor]:
    """:func:`gnn_tree_from` flattened to ``"."``-joined names: for GIN the
    ``GIN`` module's state dict (for ``load_state_dict``), e.g.
    ``layers.1.mlp.w.0`` and ``layers.1.eps``; for PNA ``layers.0.pre.w.0``
    and ``layers.0.post.b.0``; for MeshGraphNet ``layers.0.edge.ln`` and
    ``edge_encode.w.0``."""
    return {".".join(map(str, path)): leaf
            for path, leaf in tree.flatten(gnn_tree_from(params))}


def transformer_params_from(params) -> Dict:
    """The port's transformer params (``models.transformer``: CPU tensors)
    from the reference's param dict: ``embed``, ``unembed``, ``ln_f`` and
    the layers stacked on axis 0 under ``dense_layers``, then
    ``moe_layers`` (``attn`` / ``ffn`` dicts with the GQA or MLA and the
    dense or MoE keys, ``ln1``, ``ln2``), unstacked in that order into one
    dict per layer under ``layers``. Any tree of the params' structure
    maps the same way (gradients, AdamW moments, compression
    residuals)."""
    t = _tensor
    layers = []
    for key in ("dense_layers", "moe_layers"):
        if key in params:
            stacked = params[key]
            n = np.asarray(stacked["ln1"]).shape[0]
            layers += [_unstack(stacked, li) for li in range(n)]
    return {"embed": t(params["embed"]), "unembed": t(params["unembed"]),
            "ln_f": t(params["ln_f"]), "layers": layers}
