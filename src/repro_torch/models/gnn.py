"""GNN family: GIN, PNA and MeshGraphNet, forward and training. Twin of
``repro/models/gnn.py`` (``GNNConfig``, ``edge_apply``, ``segment_agg``,
``init``, ``_gin_layer`` / ``_pna_layer`` / ``_mgn_layer``, ``forward`` and
``loss_fn``); EquiformerV2 is ``models/equiformer.py``.

Message passing is ``gather -> message -> index_add_`` over the arc list,
as the reference's ``segment_sum``, directly or (``cfg.edge_chunk > 0``)
over fixed arc blocks (``edge_apply``). GIN's aggregation is the
unweighted sum over arcs (v <- u) of x[u], which is ``A @ x`` for the 0/1
adjacency of the arc list: where the batch carries its BSR layouts
(``batch["bsr"]`` and ``batch["bsr_t"]``, from :func:`gin_layouts`) it runs
the hand-written ``bsr_spmm`` kernel, forward on A and backward on Aᵀ
(``kernels.ops.gnn_aggregate_bsr``); without them, on CPU tensors only,
it takes the plain ``edge_apply`` path, as the reference does (on the card
that plain path is reached only through the ``aggregate`` hook, to check
the kernel against it). GIN ignores ``edge_weight``.
PNA's and MeshGraphNet's aggregations depend on each message, so they stay
plain PyTorch (the reference has no kernel for them either).

The parameters are the reference's dict (``encode``, ``layers`` as a list
with one dict per layer, ``edge_encode`` for MeshGraphNet, ``decode``), so
``optim.adamw`` decays the leaves the reference's stacked layout decays
(every per-layer weight and bias, not GIN's ``eps``). ``cfg.remat``
recomputes each layer in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does. :class:`GIN` is the serving module
(no autograd) over the same functions. :func:`param_specs` is the
reference's spec tree, and ``forward`` / ``loss_fn`` take its ``rules``
(default ``NO_MESH``: no constraint, the plain path bitwise); on DTensors
(the placement trace) the gathers and segment sums go through
``dist.sharding.gather_rows`` / ``segment_reduce``.

Batch dict convention: x [N, F] node feats; senders/receivers [E] int32
(symmetric arcs); edge_weight [E]; degrees [N]; labels [N] or [G] int32;
label_mask [N] or [G]; graph_id [N] int32 (batched molecules; -1 =
padding); edge_feat [E, d_edge_in] (MeshGraphNet, optional).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device, tree
from repro_torch.dist.sharding import (NO_MESH, Rules, gather_rows,
                                       segment_reduce)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bsr_spmm import BsrLayout
from repro_torch.models.common import cross_entropy
from repro_torch.models.mlp import MLP, mlp_apply

Params = Dict[str, Any]


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


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as ``index_select``, whose backward is ``index_add_``
    (float atomics on the card). Autograd's backward of ``x[idx]`` is the
    sorted ``index_put_``, which sums each row's run in one warp and
    serialises on a sampled batch's sink node (46,600 padding arcs at
    minibatch_lg): 0.98 of MeshGraphNet's 1.19 s traced step on the H100.
    DTensors take ``sharding.gather_rows``."""
    return gather_rows(x, idx)


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
        xd, xs = _rows(x, senders), _rows(x, receivers)
        m = msg_fn(xd, xs) if extra is None else msg_fn(xd, xs, extra)
        return segment_reduce(m, senders, n_nodes)

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
            m = msg_fn(_rows(x_pad, sl), _rows(x_pad, rl))
        else:
            m = msg_fn(_rows(x_pad, sl), _rows(x_pad, rl),
                       extra_p[i * chunk:(i + 1) * chunk])
        acc.index_add_(0, sl, m)
    return acc[:n_nodes]


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    return segment_reduce(values, segments, n)


def segment_agg(values: torch.Tensor, segments: torch.Tensor, n: int,
                kind: str, degrees: torch.Tensor) -> torch.Tensor:
    """One PNA aggregator over arcs -> nodes (``segments`` int64). Max and
    min start from the reference's empty-segment identity, -inf / +inf,
    and zero the empty segments as its ``where(isfinite)`` does; a tie's
    gradient is split evenly, as ``jax.grad`` of ``segment_max`` splits
    it. (Starting from zeros with ``include_self=False`` would count a
    starting zero equal to the maximum into the tie: 1/3 each for two
    tied zeros, where the reference gives 1/2.) Std's floor is
    ``torch.maximum``, which passes half the gradient at a tie as
    ``jnp.maximum`` does (``clamp_min`` would pass all of it)."""
    if kind == "sum":
        return _segment_sum(values, segments, n)
    if kind == "mean":
        s = _segment_sum(values, segments, n)
        return s / torch.clamp_min(degrees, 1.0)[:, None]
    if kind in ("max", "min"):
        m = segment_reduce(values, segments, n,
                           "amax" if kind == "max" else "amin")
        return torch.where(torch.isfinite(m), m, 0.0)
    if kind == "std":
        d = torch.clamp_min(degrees, 1.0)[:, None]
        s1 = _segment_sum(values, segments, n) / d
        s2 = _segment_sum(values * values, segments, n) / d
        return torch.sqrt(torch.maximum(s2 - s1 * s1,
                                        values.new_tensor(1e-8)))
    raise ValueError(kind)


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


def gin_layouts(batch: Dict, block: int = 128,
                device: DeviceLike = None) -> Dict[str, BsrLayout]:
    """``{"bsr": A, "bsr_t": Aᵀ}`` for a training batch (``ops.
    prepare_bsr_pair`` with unit weights; one layout for both on symmetric
    arcs): merged into the batch, they make GIN aggregate through
    ``bsr_spmm`` in both directions."""
    senders = np.asarray(batch["senders"])
    lay, lay_t = kops.prepare_bsr_pair(
        int(batch["x"].shape[0]), senders, np.asarray(batch["receivers"]),
        np.ones(senders.shape[0], np.float32), block, device)
    return {"bsr": lay, "bsr_t": lay_t}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _mlp(dims, layer_norm=False, **kw) -> Params:
    """An :class:`MLP`'s draws as a detached ``{"w", "b", "ln"?}`` dict."""
    return tree.map_(lambda t: t.detach(),
                     MLP(dims, layer_norm=layer_norm, **kw).params())


def init(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Params:
    """The reference's parameter layout, drawn from ``generator`` on
    ``device`` (``None`` = CUDA) in its order: ``encode`` (d_in -> h), one
    dict per layer under ``layers`` (GIN ``mlp`` h -> h -> h and ``eps`` =
    0; PNA ``pre`` 2h -> h and ``post`` (aggregators x scalers + 1) h -> h;
    MeshGraphNet ``edge`` 3h -> h.. and ``node`` 2h -> h.., with
    LayerNorm), MeshGraphNet's ``edge_encode`` (d_edge_in -> h), then
    ``decode`` (h -> h -> n_classes). Plain tensors, not parameters."""
    if cfg.kind not in ("gin", "pna", "mgn"):
        raise ValueError(cfg.kind)
    kw = dict(generator=generator, device=resolve_device(device),
              dtype=cfg.dtype)
    h = cfg.d_hidden
    p: Params = {"encode": _mlp((cfg.d_in, h), **kw)}
    layers = []
    for _ in range(cfg.n_layers):
        if cfg.kind == "gin":
            layers.append({"mlp": _mlp((h, h, h), **kw),
                           "eps": torch.zeros((), device=kw["device"],
                                              dtype=cfg.dtype)})
        elif cfg.kind == "pna":
            n_agg = len(cfg.aggregators) * len(cfg.scalers)
            layers.append({"pre": _mlp((2 * h, h), **kw),
                           "post": _mlp((n_agg * h + h, h), **kw)})
        else:
            layers.append({
                "edge": _mlp((3 * h,) + (h,) * cfg.mlp_layers, True, **kw),
                "node": _mlp((2 * h,) + (h,) * cfg.mlp_layers, True, **kw)})
    p["layers"] = layers
    if cfg.kind == "mgn":
        p["edge_encode"] = _mlp((max(cfg.d_edge_in, 1), h), **kw)
    p["decode"] = _mlp((h, h, cfg.n_classes), **kw)
    return p


def _mlp_spec(p: Params, rules: Rules) -> Params:
    """The reference's ``_mlp_spec``: weights ``(fsdp, model)``, biases
    ``(model,)``, a LayerNorm scale replicated."""
    spec = {"w": [rules.spec("fsdp", "model") for _ in p["w"]],
            "b": [rules.spec("model") for _ in p["b"]]}
    if "ln" in p:
        spec["ln"] = rules.spec(None)
    return spec


def param_specs(cfg: GNNConfig, rules: Rules) -> Params:
    """The spec tree of :func:`init`'s params, leaf for leaf: the
    reference's ``init`` specs with its stacked layers unrolled (a stacked
    leaf's ``Spec(None, *s)`` is each layer's ``Spec(*s)``); every MLP
    through :func:`_mlp_spec`, GIN's ``eps`` replicated."""
    def spec(node):
        if isinstance(node, dict) and "w" in node:
            return _mlp_spec(node, rules)
        if isinstance(node, dict):
            return {k: spec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [spec(v) for v in node]
        return rules.spec()
    return spec(init(cfg, None, device="meta"))


# ---------------------------------------------------------------------------
# layers and the model
# ---------------------------------------------------------------------------

def _gin_layer(lp, x, aggregate):
    return mlp_apply(lp["mlp"], (1.0 + lp["eps"]) * x + aggregate(x))


def _pna_layer(lp, x, senders, receivers, deg, cfg: GNNConfig):
    n, h = x.shape

    def msg(xd, xs):
        return mlp_apply(lp["pre"], torch.cat([xd, xs], -1))

    # aggregate all kinds; sum/mean/std reuse one pass of messages
    m = (msg(_rows(x, senders), _rows(x, receivers)) if cfg.edge_chunk == 0
         else None)
    outs = []
    for a in cfg.aggregators:
        if m is not None:
            agg = segment_agg(m, senders, n, a, deg)
        elif a in ("mean", "sum"):
            # chunked: each aggregator re-walks the arcs; the
            # sum-decomposable ones (sum/mean/std via moments) share
            # edge_apply
            agg = edge_apply(senders, receivers, msg, x, n, h,
                             chunk=cfg.edge_chunk)
            if a == "mean":
                agg = agg / torch.clamp_min(deg, 1.0)[:, None]
        elif a == "std":
            s1 = edge_apply(senders, receivers, msg, x, n, h,
                            chunk=cfg.edge_chunk)
            s2 = edge_apply(senders, receivers,
                            lambda xd, xs: msg(xd, xs) ** 2, x, n, h,
                            chunk=cfg.edge_chunk)
            d1 = torch.clamp_min(deg, 1.0)[:, None]
            agg = torch.sqrt(torch.maximum(s2 / d1 - (s1 / d1) ** 2,
                                           x.new_tensor(1e-8)))
        else:  # max / min over the whole arc list (the rare path)
            agg = segment_agg(msg(_rows(x, senders), _rows(x, receivers)),
                              senders, n, a,
                              deg)
        outs.append(agg)
    feats = []
    logd = torch.log(torch.clamp_min(deg, 1.0) + 1.0)[:, None]
    for sc in cfg.scalers:
        if sc == "identity":
            scale = 1.0
        elif sc == "amplification":
            scale = logd / cfg.mean_log_deg
        else:                       # attenuation
            scale = cfg.mean_log_deg / torch.clamp_min(logd, 1e-3)
        feats.extend([o * scale for o in outs])
    z = torch.cat(feats + [x], -1)
    return x + mlp_apply(lp["post"], z)


def _mgn_layer(lp, x, e_feat, senders, receivers):
    xd, xs = _rows(x, senders), _rows(x, receivers)
    e_new = e_feat + mlp_apply(lp["edge"], torch.cat([e_feat, xd, xs], -1))
    agg = _segment_sum(e_new, senders, x.shape[0])
    x_new = x + mlp_apply(lp["node"], torch.cat([x, agg], -1))
    return x_new, e_new


def plain_aggregate(batch: Dict, chunk: int = 0) -> Callable:
    """GIN's ``A @ x`` as the reference computes it, ``edge_apply`` over
    the batch's arcs (on ``x``'s device). GIN's own aggregation on CPU
    tensors without layouts; on the card only through :func:`forward`'s /
    :func:`loss_fn`'s ``aggregate`` hook, to hold the kernel path to it."""
    def aggregate(x):
        s = torch.as_tensor(batch["senders"], device=x.device).long()
        r = torch.as_tensor(batch["receivers"], device=x.device).long()
        if chunk <= 0 or s.shape[0] <= chunk:
            # edge_apply's direct path without its unread gather of the
            # senders' rows (XLA drops it; a DTensor trace would record it)
            return segment_reduce(_rows(x, r), s, x.shape[0])
        return edge_apply(s, r, lambda xd, xs: xs, x, x.shape[0], x.shape[1],
                          chunk=chunk)
    return aggregate


def _gin_aggregate(batch: Dict, n: int, cfg: GNNConfig,
                   device: torch.device) -> Callable:
    """GIN's ``A @ x``: ``bsr_spmm`` on the batch's layouts where it
    carries them, else (CPU tensors only) :func:`plain_aggregate`."""
    if "bsr" in batch:
        lay, lay_t = batch["bsr"], batch.get("bsr_t")
        if lay.n_nodes != n:
            raise ValueError(f"layout covers {lay.n_nodes} nodes, the "
                             f"batch has {n}")
        return lambda x: kops.gnn_aggregate_bsr(lay, x, lay_t)
    if device.type == "cuda":
        raise ValueError(
            "GIN on the card aggregates through bsr_spmm: the batch needs "
            "its layouts (models.gnn.gin_layouts(batch)); a plain check "
            "passes aggregate=models.gnn.plain_aggregate(batch)")
    return plain_aggregate(batch, cfg.edge_chunk)


def forward(params: Params, batch: Dict, cfg: GNNConfig,
            aggregate: Optional[Callable] = None,
            rules: Rules = NO_MESH) -> torch.Tensor:
    """-> logits: [N, n_classes] (node-level) or [G, n_classes] (graph).
    The batch's arrays may be numpy or tensors (moved to the parameters'
    device). ``aggregate(x) -> A @ x`` replaces GIN's own aggregation
    (a hook on the layers' inputs, a check against another path).
    ``rules`` constrains the node features to ``rows`` after the encoder
    and after each layer, the reference's ``rules.shard`` sites."""
    dev = params["decode"]["w"][0].device

    def t(key):
        return torch.as_tensor(batch[key], device=dev)
    x = rules.shard(mlp_apply(params["encode"], t("x").to(cfg.dtype)),
                    "rows", None)
    n = x.shape[0]
    if cfg.kind != "gin":
        senders, receivers = t("senders").long(), t("receivers").long()

    def run(fn, *args):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)
    if cfg.kind == "mgn":
        e_in = batch.get("edge_feat")
        e_in = (t("edge_weight")[:, None] if e_in is None
                else t("edge_feat")).to(cfg.dtype)
        e = mlp_apply(params["edge_encode"], e_in)
        for lp in params["layers"]:
            x, e = run(_mgn_layer, lp, x, e, senders, receivers)
            x = rules.shard(x, "rows", None)
    elif cfg.kind == "pna":
        deg = t("degrees").to(cfg.dtype)
        for lp in params["layers"]:
            x = rules.shard(run(lambda lp, x: _pna_layer(
                lp, x, senders, receivers, deg, cfg), lp, x), "rows", None)
    elif cfg.kind == "gin":
        agg = aggregate or _gin_aggregate(batch, n, cfg, dev)
        for lp in params["layers"]:
            x = rules.shard(run(lambda lp, x: _gin_layer(lp, x, agg), lp, x),
                            "rows", None)
    else:
        raise ValueError(cfg.kind)

    if cfg.graph_level:
        gid = t("graph_id").long()
        n_graphs = int(batch["labels"].shape[0])
        valid = (gid >= 0).to(x.dtype)[:, None]
        idx = gid.clamp_min(0)
        pooled = _segment_sum(x * valid, idx, n_graphs)
        cnt = _segment_sum(valid, idx, n_graphs)
        x = pooled / torch.clamp_min(cnt, 1.0)
    return mlp_apply(params["decode"], x)


def loss_fn(params: Params, batch: Dict, cfg: GNNConfig,
            aggregate: Optional[Callable] = None,
            rules: Rules = NO_MESH) -> Tuple[torch.Tensor, Dict]:
    """Masked mean cross-entropy of :func:`forward`'s logits:
    ``(ce, {"ce": ce})``."""
    logits = forward(params, batch, cfg, aggregate, rules)
    dev = logits.device
    mask = batch.get("label_mask")
    ce = cross_entropy(logits, torch.as_tensor(batch["labels"], device=dev),
                       None if mask is None
                       else torch.as_tensor(mask, device=dev))
    return ce, {"ce": ce}


def _module_of(node) -> nn.Module:
    """A params subtree as modules whose parameters sit under the
    subtree's paths: a dict as a module, a list of tensors as an
    ``nn.ParameterList``, any other list as an ``nn.ModuleList``."""
    if isinstance(node, list):
        if all(isinstance(x, torch.Tensor) for x in node):
            return nn.ParameterList(node)
        return nn.ModuleList(_module_of(x) for x in node)
    mod = nn.Module()
    for key, sub in node.items():
        if isinstance(sub, torch.Tensor):
            mod.register_parameter(key, nn.Parameter(sub))
        else:
            mod.add_module(key, _module_of(sub))
    return mod


class GIN(nn.Module):
    """GIN serving: :func:`forward` on the module's parameters, without
    autograd, every layer aggregating through ``bsr_spmm``. The parameters
    are :func:`init`'s, registered under their paths (state dict keys
    ``encode.w.0``, ``layers.1.mlp.b.0``, ``layers.1.eps``, ...)."""

    def __init__(self, cfg: GNNConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        if cfg.kind != "gin":
            raise ValueError(
                f"GIN runs GNN kind 'gin', not {cfg.kind!r}: PNA and "
                f"MeshGraphNet are the functional models.gnn.init / "
                f"forward / loss_fn")
        super().__init__()
        self.cfg = cfg
        p = init(cfg, generator, device)
        self._like = tree.map_(lambda _: 0, p)
        for key, sub in p.items():
            self.add_module(key, _module_of(sub))

    def params(self) -> Params:
        """The module's tensors in the functional params layout (the
        parameters themselves, not copies)."""
        return tree.unflatten(self._like, [
            self.get_parameter(".".join(map(str, path)))
            for path, _ in tree.flatten(self._like)])

    @staticmethod
    def _with(batch: Dict, layout: Optional[BsrLayout]) -> Dict:
        if layout is None:
            raise ValueError("GIN.forward needs the batch's BSR layout "
                             "(models.gnn.gin_layout(batch))")
        return dict(batch, bsr=layout)

    @torch.no_grad()
    def forward(self, batch: Dict,
                layout: Optional[BsrLayout]) -> torch.Tensor:
        """-> logits ``[N, n_classes]`` (node-level) or ``[G, n_classes]``
        (graph-level), every layer aggregating through ``bsr_spmm`` on
        ``layout`` (:func:`gin_layout` of this batch)."""
        return forward(self.params(), self._with(batch, layout), self.cfg)

    @torch.no_grad()
    def forward_with(self, batch: Dict,
                     aggregate: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
        """The forward with ``aggregate(x) -> A @ x`` supplied by the
        caller: the reference's ``segment_sum`` formulation
        (``ops.gnn_aggregate``) for checks, or a hook on the layers'
        inputs."""
        return forward(self.params(), batch, self.cfg, aggregate)

    @torch.no_grad()
    def loss(self, batch: Dict, layout: Optional[BsrLayout]) -> torch.Tensor:
        """Masked mean cross-entropy of :meth:`forward`'s logits."""
        return loss_fn(self.params(), self._with(batch, layout), self.cfg)[0]
