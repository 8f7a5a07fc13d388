"""GNN family: the GIN forward on a BSR adjacency. Twin of the GIN path of
``repro/models/gnn.py`` (``GNNConfig``, ``edge_apply``, GIN's ``init`` /
``_gin_layer`` / ``forward`` / ``loss_fn``).

GIN's aggregation is the unweighted sum over arcs (v <- u) of x[u], which
is ``A @ x`` for the 0/1 adjacency of the arc list. The reference computes
it as ``edge_apply``'s gather + ``segment_sum``; the port computes it with
the hand-written ``bsr_spmm`` kernel (``kernels.ops.gnn_aggregate_bsr``)
on the batch's BSR layout, built once per graph on the host with unit
weights (:func:`gin_layout`; GIN ignores ``edge_weight``). ``edge_apply``
(direct and chunked) is ported for the later kinds; PNA and MeshGraphNet
(``segment_agg``, per-arc edge features) wait for a later slice.

Inference only: the kernel has no backward yet, so ``forward`` runs
without autograd. On one card every sharding rule of the reference
resolves to no constraint, so the port has no ``Rules``.

Batch dict convention: x [N, F] node feats; senders/receivers [E] int32
(symmetric arcs); labels [N] or [G] int32; label_mask [N] or [G];
graph_id [N] int32 (batched molecules; -1 = padding).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bsr_spmm import BsrLayout
from repro_torch.models.common import cross_entropy
from repro_torch.models.mlp import MLP


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                    # gin | pna | mgn
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    d_edge_in: int = 0           # mgn: input edge features
    mlp_layers: int = 2
    eps_learnable: bool = True   # gin
    aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")  # pna
    scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    mean_log_deg: float = 2.0    # pna normalization constant (from data)
    edge_chunk: int = 0          # 0 = direct path; else arcs per scan step
    graph_level: bool = False    # molecule: pool by graph_id
    dtype: torch.dtype = torch.float32
    remat: bool = False


def edge_apply(senders: torch.Tensor, receivers: torch.Tensor,
               msg_fn: Callable[..., torch.Tensor], x: torch.Tensor,
               n_nodes: int, out_dim: int, chunk: int = 0,
               extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[v] = sum over arcs (v <- u) of msg_fn(x[v], x[u], extra_arc).

    ``msg_fn(x_dst, x_src[, extra])`` operates on a block of arcs. With
    ``chunk > 0`` the arc list is processed in fixed blocks (padded arcs
    point at node ``n_nodes`` with zero extra), keeping live memory at
    O(chunk * d) instead of O(E * d).
    """
    senders, receivers = senders.long(), receivers.long()
    e = senders.shape[0]
    if chunk <= 0 or e <= chunk:
        m = (msg_fn(x[senders], x[receivers]) if extra is None
             else msg_fn(x[senders], x[receivers], extra))
        return torch.zeros((n_nodes,) + tuple(m.shape[1:]), dtype=m.dtype,
                           device=m.device).index_add_(0, senders, m)

    n_blocks = (e + chunk - 1) // chunk
    pad = n_blocks * chunk - e
    s_p = nn.functional.pad(senders, (0, pad), value=n_nodes)
    r_p = nn.functional.pad(receivers, (0, pad), value=n_nodes)
    x_pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if extra is not None:
        extra_p = torch.cat([extra, extra.new_zeros((pad,)
                                                    + tuple(extra.shape[1:]))])
    acc = x.new_zeros((n_nodes + 1, out_dim))
    for i in range(n_blocks):
        sl = s_p[i * chunk:(i + 1) * chunk]
        rl = r_p[i * chunk:(i + 1) * chunk]
        if extra is None:
            m = msg_fn(x_pad[sl], x_pad[rl])
        else:
            m = msg_fn(x_pad[sl], x_pad[rl], extra_p[i * chunk:(i + 1) * chunk])
        acc.index_add_(0, sl, m)
    return acc[:n_nodes]


def gin_layout(batch: Dict, block: int = 128,
               device: DeviceLike = None) -> BsrLayout:
    """The batch's BSR adjacency for GIN's sum aggregation, built on the
    host from its numpy (or CPU tensor) ``senders`` / ``receivers`` with unit
    weights and moved to ``device`` (``None`` = CUDA)."""
    senders = np.asarray(batch["senders"])
    return kops.prepare_bsr(int(batch["x"].shape[0]), senders,
                            np.asarray(batch["receivers"]),
                            np.ones(senders.shape[0], np.float32), block,
                            device)


class GINLayer(nn.Module):
    """``x' = MLP((1 + eps) * x + agg)``, MLP h -> h -> h, eps a scalar."""

    def __init__(self, h: int, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.mlp = MLP((h, h, h), generator=generator, device=device,
                       dtype=dtype)
        self.eps = nn.Parameter(torch.zeros((), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        return self.mlp((1.0 + self.eps) * x + agg)


class GIN(nn.Module):
    def __init__(self, cfg: GNNConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        """``encode`` (d_in -> h), ``n_layers`` :class:`GINLayer` and
        ``decode`` (h -> h -> n_classes), drawn in that order from
        ``generator`` on ``device`` (``None`` = CUDA); eps starts at 0."""
        if cfg.kind != "gin":
            raise NotImplementedError(
                f"GNN kind {cfg.kind!r}: PNA and MeshGraphNet (segment_agg, "
                f"edge features) come with a later slice of the port; this "
                f"one runs GIN")
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.d_hidden
        kw = dict(generator=generator, device=dev, dtype=cfg.dtype)
        self.encode = MLP((cfg.d_in, h), **kw)
        self.layers = nn.ModuleList(GINLayer(h, **kw)
                                    for _ in range(cfg.n_layers))
        self.decode = MLP((h, h, cfg.n_classes), **kw)

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.decode.w[0].device)

    @torch.no_grad()
    def forward(self, batch: Dict,
                layout: Optional[BsrLayout]) -> torch.Tensor:
        """-> logits ``[N, n_classes]`` (node-level) or ``[G, n_classes]``
        (graph-level), every layer aggregating through ``bsr_spmm`` on
        ``layout`` (:func:`gin_layout` of this batch)."""
        if layout is None:
            raise ValueError("GIN.forward needs the batch's BSR layout "
                             "(models.gnn.gin_layout(batch))")
        n = int(batch["x"].shape[0])
        if layout.n_nodes != n:
            raise ValueError(f"layout covers {layout.n_nodes} nodes, the "
                             f"batch has {n}")
        return self.forward_with(
            batch, lambda x: kops.gnn_aggregate_bsr(layout, x))

    @torch.no_grad()
    def forward_with(self, batch: Dict,
                     aggregate: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
        """The forward with ``aggregate(x) -> A @ x`` supplied by the
        caller: the reference's ``segment_sum`` formulation
        (``ops.gnn_aggregate``) for checks, or a hook on the layers'
        inputs."""
        x = self.encode(self._on_device(batch["x"]).to(self.cfg.dtype))
        for layer in self.layers:
            x = layer(x, aggregate(x))
        if self.cfg.graph_level:
            gid = self._on_device(batch["graph_id"]).long()
            n_graphs = int(batch["labels"].shape[0])
            valid = (gid >= 0).to(x.dtype)[:, None]
            idx = gid.clamp_min(0)
            pooled = x.new_zeros(n_graphs, x.shape[1]).index_add_(
                0, idx, x * valid)
            cnt = x.new_zeros(n_graphs, 1).index_add_(0, idx, valid)
            x = pooled / cnt.clamp_min(1.0)
        return self.decode(x)

    def loss(self, batch: Dict, layout: Optional[BsrLayout]) -> torch.Tensor:
        """Masked mean cross-entropy of :meth:`forward`'s logits."""
        logits = self(batch, layout)
        mask = batch.get("label_mask")
        return cross_entropy(logits, self._on_device(batch["labels"]),
                             None if mask is None else self._on_device(mask))
