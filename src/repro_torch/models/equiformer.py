"""EquiformerV2: equivariant graph attention via eSCN SO(2) convolutions.
Twin of ``repro/models/equiformer.py`` (``EquiformerConfig``,
``lm_indices``, ``so2_init`` / ``so2_apply``, ``equi_layer_norm``,
``gate_act``, ``init``, ``forward`` and ``loss_fn``).

The O(L^6) Clebsch–Gordan tensor product is replaced by the eSCN trick
(arXiv:2306.12059 / 2302.03655): rotate each edge's irrep features into a
frame where the edge points at +z (Wigner D from ``so3.py``), where an
SO(3)-equivariant convolution becomes *SO(2)-sparse* (order m only mixes
with order ±m), and truncate at ``m_max``. Cost per edge drops from O(L^6)
to O(L^3).

Layer = equivariant graph attention:
  rotate (x_i ‖ x_j) into edge frame -> SO(2) linear -> distance-gated
  hidden -> (a) scalar head -> per-head attention logits, (b) SO(2) linear
  -> value message -> rotate back -> segment-softmax-weighted scatter-sum
  -> output projection; then a gated equivariant FFN.

As in the reference, the pointwise S2-grid activation is replaced by the
equivariant gate nonlinearity, and the separable S2 variant is not
implemented.

Feature layout: X [N, M, C] with M = (l_max+1)^2 real-SH coefficients
ordered (l, m), m = -l..l, and C sphere channels.

The parameters are the reference's dict (``encode``, ``layers`` as a list
with one dict per layer, ``decode``), so ``optim.adamw`` decays the leaves
the reference's stacked layout decays (every per-layer leaf, ``ln1`` and
``ln2`` too). The arcs take one of the reference's two paths: the direct
segment softmax over ``senders``, or (``cfg.edge_chunk > 0`` and more arcs
than that) two passes over fixed arc blocks, whose padded arcs go to a dump
row n; under autograd the chunk loop keeps every chunk's residuals, as the
reference's ``lax.scan`` does. ``cfg.remat`` recomputes each layer in the
backward (``torch.utils.checkpoint``). Index tensors and the Wigner tables
are made once per device, not per layer. Everything is plain PyTorch: the
reference has no kernel here either. :func:`param_specs` is the
reference's spec tree, and ``forward`` / ``loss_fn`` take its ``rules``
(default ``NO_MESH``, the plain path bitwise). On DTensors (the placement
trace) the direct path's gathers and segment reductions go through
``dist.sharding``, and the chunked path runs replicated, as GSPMD
partitions the reference's scan.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device, tree
from repro_torch.dist.sharding import (NO_MESH, Rules, _is_dtensor,
                                       merge_dims, rowwise, segment_reduce,
                                       select, split_dim, whole_local)
from repro_torch.models import so3
from repro_torch.models.common import cross_entropy
from repro_torch.models.gnn import _mlp, _mlp_spec, _rows, _segment_sum
from repro_torch.models.mlp import mlp_apply

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 16
    n_classes: int = 1
    n_rbf: int = 32
    cutoff: float = 5.0
    edge_chunk: int = 0
    graph_level: bool = False
    dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def m_dim(self) -> int:
        return (self.l_max + 1) ** 2


# ---------------------------------------------------------------------------
# (l, m) index bookkeeping
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lm_indices(l_max: int, m_max: int):
    """Index arrays into the M axis for each SO(2) order m.

    Returns (rows0, rows_pos, rows_neg, l_of):
      rows0 [l_max+1] — indices of (l, 0);
      rows_pos[m] / rows_neg[m] for m = 1..m_max — indices of (l, ±m),
      l = m..l_max; ``l_of`` [M] — l of every coefficient.
    """
    idx = {}
    l_of = []
    off = 0
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            idx[(l, m)] = off
            l_of.append(l)
            off += 1
    rows0 = np.asarray([idx[(l, 0)] for l in range(l_max + 1)], np.int32)
    rows_pos = [np.asarray([idx[(l, m)] for l in range(m, l_max + 1)],
                           np.int32) for m in range(1, m_max + 1)]
    rows_neg = [np.asarray([idx[(l, -m)] for l in range(m, l_max + 1)],
                           np.int32) for m in range(1, m_max + 1)]
    return rows0, rows_pos, rows_neg, np.asarray(l_of, np.int32)


_INDICES: Dict[Tuple[int, int, str], Dict[str, Any]] = {}


def _indices(l_max: int, m_max: int, device: torch.device) -> Dict[str, Any]:
    """:func:`lm_indices` as int64 tensors on ``device``, made once per
    (l_max, m_max, device): ``rows0``, ``rows_pos`` / ``rows_neg`` (lists),
    ``l_of``, and ``place``, which puts :func:`so2_apply`'s blocks
    ``[y0, y+1, y-1, ..., y+m_max, y-m_max, 0]`` back in (l, m) order (every
    order above m_max reads the trailing zero row)."""
    key = (l_max, m_max, str(device))
    if key not in _INDICES:
        rows0, rows_pos, rows_neg, l_of = lm_indices(l_max, m_max)
        order = [rows0] + [r for m in range(m_max) for r in (rows_pos[m],
                                                             rows_neg[m])]
        flat = np.concatenate(order)
        place = np.full((l_max + 1) ** 2, flat.size, np.int64)
        place[flat] = np.arange(flat.size)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)
        _INDICES[key] = dict(rows0=t(rows0), rows_pos=[t(r) for r in rows_pos],
                             rows_neg=[t(r) for r in rows_neg],
                             l_of=t(l_of), place=t(place))
    return _INDICES[key]


def _dense(d_in: int, d_out: int, generator, device, dtype) -> torch.Tensor:
    """``repro/models/common.py:dense_init``: normal x ``1/sqrt(d_in)``."""
    return torch.randn(d_in, d_out, generator=generator, device=device,
                       dtype=dtype) * (1.0 / math.sqrt(d_in))


def so2_init(cfg: EquiformerConfig, c_in: int, c_out: int,
             generator: Optional[torch.Generator],
             device: torch.device) -> Params:
    """Parameters of one m_max-truncated SO(2) linear: ``w0`` over the m = 0
    rows, and ``w{m}_r`` / ``w{m}_i`` for m = 1..m_max."""
    rows0, rows_pos, _, _ = lm_indices(cfg.l_max, cfg.m_max)
    kw = dict(generator=generator, device=device, dtype=cfg.dtype)
    p: Params = {"w0": _dense(len(rows0) * c_in, len(rows0) * c_out, **kw)}
    for m in range(1, cfg.m_max + 1):
        nm = len(rows_pos[m - 1])
        p[f"w{m}_r"] = _dense(nm * c_in, nm * c_out, **kw)
        p[f"w{m}_i"] = _dense(nm * c_in, nm * c_out, **kw)
    return p


def so2_apply(p: Params, x: torch.Tensor, cfg: EquiformerConfig,
              c_out: int) -> torch.Tensor:
    """SO(2) linear in the edge frame. x: [E, M, C_in] -> [E, M, c_out].

    Order m of the output only reads order ±m of the input; orders above
    m_max are zero (the eSCN truncation). The output is one gather of the
    order blocks (no writes into a tensor autograd holds).
    """
    ix = _indices(cfg.l_max, cfg.m_max, x.device)
    e = x.shape[0]
    rows0 = ix["rows0"]
    x0 = merge_dims(select(x, 1, rows0), 1)
    blocks = [split_dim(x0 @ p["w0"], 1, rows0.shape[0], c_out)]
    for m in range(1, cfg.m_max + 1):
        rp, rn = ix["rows_pos"][m - 1], ix["rows_neg"][m - 1]
        nm = rp.shape[0]
        xp = merge_dims(select(x, 1, rp), 1)
        xn = merge_dims(select(x, 1, rn), 1)
        yp = xp @ p[f"w{m}_r"] - xn @ p[f"w{m}_i"]
        yn = xp @ p[f"w{m}_i"] + xn @ p[f"w{m}_r"]
        blocks += [split_dim(yp, 1, nm, c_out), split_dim(yn, 1, nm, c_out)]
    blocks.append(x.new_zeros((e, 1, c_out)))
    return select(torch.cat(blocks, 1), 1, ix["place"])


# ---------------------------------------------------------------------------
# Equivariant norm / gate
# ---------------------------------------------------------------------------

def equi_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                    l_max: int) -> torch.Tensor:
    """Per-l RMS normalization over (m, channels); learnable channel scale.
    The reference's ``segment_sum`` over l's contiguous (2l+1)-row block of
    the M axis is that block's sum."""
    sq = x * x                                           # [N, M, C]
    l_sum = torch.stack([sq[:, l * l:(l + 1) ** 2].sum(1)
                         for l in range(l_max + 1)], 1)  # [N, L+1, C]
    l_cnt = x.new_tensor([2 * l + 1 for l in range(l_max + 1)])
    mean_sq = l_sum.mean(-1) / l_cnt                     # [N, L+1]
    denom = torch.rsqrt(mean_sq + 1e-6)
    l_of = _indices(l_max, 0, x.device)["l_of"]
    return x * select(denom, 1, l_of)[..., None] * gamma


def gate_act(x: torch.Tensor, w_gate: torch.Tensor) -> torch.Tensor:
    """Equivariant nonlinearity: SiLU on l=0, sigmoid(W·scalars) gate on l>0."""
    scalars = x[:, 0]                                    # [N, C] (l=0, m=0)
    gates = torch.sigmoid(scalars @ w_gate)              # [N, C]
    scal_out = torch.nn.functional.silu(scalars)
    higher = x[:, 1:] * gates[:, None, :]
    return torch.cat([scal_out[:, None], higher], dim=1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: EquiformerConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> Params:
    """The reference's parameter layout, drawn from ``generator`` on
    ``device`` (``None`` = CUDA): ``encode`` (d_in -> C), one dict per layer
    under ``layers`` (``ln1``, ``conv1`` 2C -> C and ``conv2`` C -> C SO(2)
    linears, ``rbf_mlp`` n_rbf -> C -> 2C, ``attn_w`` C -> heads,
    ``gate_w``, ``proj``, ``ln2``, ``ffn_in`` C -> 2C, ``ffn_gate`` 2C ->
    2C, ``ffn_out`` 2C -> C), then ``decode`` (C -> C -> n_classes). Plain
    tensors, not parameters."""
    dev = resolve_device(device)
    kw = dict(generator=generator, device=dev, dtype=cfg.dtype)
    c = cfg.channels
    p: Params = {"encode": _mlp((cfg.d_in, c), **kw)}
    layers: List[Params] = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": torch.ones(c, device=dev, dtype=cfg.dtype),
            "conv1": so2_init(cfg, 2 * c, c, generator, dev),
            "conv2": so2_init(cfg, c, c, generator, dev),
            "rbf_mlp": _mlp((cfg.n_rbf, c, 2 * c), **kw),
            "attn_w": _dense(c, cfg.n_heads, **kw),
            "gate_w": _dense(c, c, **kw),
            "proj": _dense(c, c, **kw),
            "ln2": torch.ones(c, device=dev, dtype=cfg.dtype),
            "ffn_in": _dense(c, 2 * c, **kw),
            "ffn_gate": _dense(2 * c, 2 * c, **kw),
            "ffn_out": _dense(2 * c, c, **kw),
        })
    p["layers"] = layers
    p["decode"] = _mlp((c, c, cfg.n_classes), **kw)
    return p


def _so2_specs(cfg: EquiformerConfig, rules: Rules) -> Params:
    s = {"w0": rules.spec("fsdp", "model")}
    for m in range(1, cfg.m_max + 1):
        s[f"w{m}_r"] = rules.spec("fsdp", "model")
        s[f"w{m}_i"] = rules.spec("fsdp", "model")
    return s


def param_specs(cfg: EquiformerConfig, rules: Rules) -> Params:
    """The spec tree of :func:`init`'s params, leaf for leaf: the
    reference's ``init`` / ``so2_init`` specs with its stacked layers
    unrolled (a stacked leaf's ``Spec(None, *s)`` is each layer's
    ``Spec(*s)``)."""
    def mlp(n_dense):
        return _mlp_spec({"w": [None] * n_dense, "b": [None] * n_dense},
                         rules)
    return {
        "encode": mlp(1),
        "layers": [{
            "ln1": rules.spec(None), "conv1": _so2_specs(cfg, rules),
            "conv2": _so2_specs(cfg, rules),
            "rbf_mlp": mlp(2),
            "attn_w": rules.spec(None, "model"),
            "gate_w": rules.spec(None, "model"),
            "proj": rules.spec("model", None), "ln2": rules.spec(None),
            "ffn_in": rules.spec("fsdp", "model"),
            "ffn_gate": rules.spec(None, "model"),
            "ffn_out": rules.spec("model", "fsdp")}
            for _ in range(cfg.n_layers)],
        "decode": mlp(2)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

_CENTERS: Dict[Tuple[int, float, str, torch.dtype], torch.Tensor] = {}


def _rbf(dist: torch.Tensor, cfg: EquiformerConfig) -> torch.Tensor:
    key = (cfg.n_rbf, cfg.cutoff, str(dist.device), dist.dtype)
    if key not in _CENTERS:
        _CENTERS[key] = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf,
                                       dtype=dist.dtype, device=dist.device)
    width = cfg.cutoff / cfg.n_rbf
    return torch.exp(-((dist[:, None] - _CENTERS[key]) / width) ** 2)


def _rotate(d_blocks: List[torch.Tensor], x: torch.Tensor, l_max: int,
            transpose: bool = False) -> torch.Tensor:
    """Apply block-diagonal Wigner-D per l. x: [E, M, C]. ``transpose``
    applies Dᵀ, the rotation back out of the edge frame."""
    out = []
    off = 0
    for l, d in enumerate(d_blocks):
        sz = 2 * l + 1
        xl = x[:, off:off + sz]
        out.append((d.transpose(-1, -2) if transpose else d) @ xl)
        off += sz
    return torch.cat(out, dim=1)


def _edge_hidden(lp: Params, xn: torch.Tensor, pos: torch.Tensor,
                 sl: torch.Tensor, rl: torch.Tensor, cfg: EquiformerConfig):
    """-> (Wigner blocks, hidden [e, M, C], logits [e, h]) for one arc
    block: the features of both ends rotated into the edge frame, the
    first SO(2) linear, the distance gate and bias, the attention head."""
    c = cfg.channels
    vec = _rows(pos, rl) - _rows(pos, sl)
    dist = torch.linalg.vector_norm(vec, dim=-1)
    d_blocks = rowwise(lambda v: so3.wigner_d_stack(so3.edge_rotation(v),
                                                    cfg.l_max), vec)
    cat = torch.cat([_rows(xn, sl), _rows(xn, rl)], dim=-1)   # [e, M, 2C]
    cat = _rotate(d_blocks, cat, cfg.l_max)
    hid = so2_apply(lp["conv1"], cat, cfg, c)                 # [e, M, C]
    scale = mlp_apply(lp["rbf_mlp"], _rbf(dist, cfg))         # [e, 2C]
    hid = hid * scale[:, None, :c]          # distance gate (all l)
    hid = torch.cat([(hid[:, 0] + scale[:, c:])[:, None], hid[:, 1:]],
                    dim=1)                  # distance bias (scalars)
    logits = torch.nn.functional.silu(hid[:, 0]) @ lp["attn_w"]   # [e, h]
    return d_blocks, hid, logits


def _edge_values(lp: Params, d_blocks, hid: torch.Tensor,
                 cfg: EquiformerConfig) -> torch.Tensor:
    """The value messages [e, M, C]: the second SO(2) linear, rotated back
    out of the edge frame."""
    val = so2_apply(lp["conv2"], hid, cfg, cfg.channels)
    return _rotate(d_blocks, val, cfg.l_max, transpose=True)


def _attn_layer(lp: Params, x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, pos: torch.Tensor,
                cfg: EquiformerConfig) -> torch.Tensor:
    """One equivariant graph-attention + FFN block (direct or chunked
    arcs). ``senders`` / ``receivers`` int64."""
    n, m_dim, c = x.shape
    h = cfg.n_heads
    ch = c // h

    xn = equi_layer_norm(x, lp["ln1"], cfg.l_max)

    e = senders.shape[0]
    chunk = cfg.edge_chunk
    if chunk <= 0 or e <= chunk:
        d_blocks, hid, logits = _edge_hidden(lp, xn, pos, senders, receivers,
                                             cfg)
        val = _edge_values(lp, d_blocks, hid, cfg)
        # segment softmax over destination (senders = dst in arc layout),
        # its max from the empty-segment identity -inf
        lmax_seg = segment_reduce(logits, senders, n, "amax")
        lmax_seg = torch.where(torch.isfinite(lmax_seg), lmax_seg, 0.0)
        ex = torch.exp(logits - _rows(lmax_seg, senders))
        den = _segment_sum(ex, senders, n)
        alpha = ex / torch.maximum(_rows(den, senders), ex.new_tensor(1e-9))
        val_h = split_dim(val, 2, h, ch) * alpha[:, None, :, None]
        agg = _segment_sum(merge_dims(val_h, 2), senders, n)
    elif _is_dtensor(xn):
        # GSPMD replicates the chunked scan: every device walks every arc
        # block over the whole node set and weights, so the loop moves
        # nothing; the gathers (and, backward, the gradient chunks) are
        # outside it
        local = [whole_local(t)
                 for t in (xn, pos, senders, receivers)]
        lp_w = {k: tree.map_(lambda w: whole_local(w)[0], lp[k])
                for k in ("conv1", "conv2", "rbf_mlp", "attn_w")}
        agg = local[0][1](_chunked_agg(lp_w, *(v for v, _ in local), cfg))
    else:
        agg = _chunked_agg(lp, xn, pos, senders, receivers, cfg)

    agg = gate_act(agg, lp["gate_w"])
    x = x + agg @ lp["proj"]

    # gated FFN
    xn2 = equi_layer_norm(x, lp["ln2"], cfg.l_max)
    hmid = gate_act(xn2 @ lp["ffn_in"], lp["ffn_gate"])
    return x + hmid @ lp["ffn_out"]


def _chunked_agg(lp: Params, xn: torch.Tensor, pos: torch.Tensor,
                 senders: torch.Tensor, receivers: torch.Tensor,
                 cfg: EquiformerConfig) -> torch.Tensor:
    """The attention's aggregation over fixed arc blocks, two passes."""
    n, m_dim, c = xn.shape
    h = cfg.n_heads
    ch = c // h
    e = senders.shape[0]
    chunk = cfg.edge_chunk
    # two-pass chunked: (1) accumulate the segment max of the logits,
    # (2) weighted message accumulation. Arc blocks padded to n (dump).
    n_blocks = (e + chunk - 1) // chunk
    pad = n_blocks * chunk - e
    s_p = torch.nn.functional.pad(senders, (0, pad), value=n)
    r_p = torch.nn.functional.pad(receivers, (0, pad), value=0)
    s_c = torch.clamp_max(s_p, n - 1)
    valid = (s_p < n)[:, None]
    blocks = [slice(i * chunk, (i + 1) * chunk) for i in range(n_blocks)]

    mx = xn.new_full((n + 1, h), -torch.inf)
    for b in blocks:
        _, _, logits = _edge_hidden(lp, xn, pos, s_c[b], r_p[b], cfg)
        logits = torch.where(valid[b], logits, -torch.inf)
        mx = mx.scatter_reduce(0, s_p[b][:, None].expand_as(logits),
                               logits, "amax")
    mx = torch.where(torch.isfinite(mx), mx, 0.0)

    num = xn.new_zeros((n + 1, m_dim, c))
    den = xn.new_zeros((n + 1, h))
    for b in blocks:
        d_blocks, hid, logits = _edge_hidden(lp, xn, pos, s_c[b], r_p[b],
                                             cfg)
        val = _edge_values(lp, d_blocks, hid, cfg)
        ex = torch.exp(logits - _rows(mx, s_p[b]))
        ex = torch.where(valid[b], ex, 0.0)
        vh = val.reshape(chunk, m_dim, h, ch) * ex[:, None, :, None]
        num = num.index_add(0, s_p[b], vh.reshape(chunk, m_dim, c))
        den = den.index_add(0, s_p[b], ex)
    den_c = torch.repeat_interleave(
        torch.maximum(den[:n], den.new_tensor(1e-9)), ch, dim=-1)
    return num[:n] / den_c[:, None, :]


def forward(params: Params, batch: Dict, cfg: EquiformerConfig,
            rules: Rules = NO_MESH) -> torch.Tensor:
    """-> logits: [N, n_classes] (node-level) or [G, n_classes] (graph).
    The batch (``x``, ``pos``, ``senders``, ``receivers``; ``graph_id`` and
    ``labels`` when graph-level) may be numpy or tensors, moved to the
    parameters' device; ``pos`` is taken in ``cfg.dtype``. ``rules``
    constrains the irreps to ``rows`` after the embedding and after each
    layer (the reference's ``rules.shard`` sites)."""
    dev = params["decode"]["w"][0].device

    def t(key):
        return torch.as_tensor(batch[key], device=dev)
    scal = mlp_apply(params["encode"], t("x").to(cfg.dtype))
    n = scal.shape[0]
    x = torch.cat([scal[:, None], scal.new_zeros(
        (n, cfg.m_dim - 1, cfg.channels))], dim=1)       # l=0 init
    x = rules.shard(x, "rows", None, None)
    senders, receivers = t("senders").long(), t("receivers").long()
    pos = t("pos").to(cfg.dtype)

    def layer(lp, xc):
        return _attn_layer(lp, xc, senders, receivers, pos, cfg)
    for lp in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            x = layer(lp, x)
        x = rules.shard(x, "rows", None, None)

    scalars = x[:, 0]                                     # invariant readout
    if cfg.graph_level:
        gid = t("graph_id").long()
        n_graphs = int(batch["labels"].shape[0])
        valid = (gid >= 0).to(scalars.dtype)[:, None]
        idx = gid.clamp_min(0)
        pooled = _segment_sum(scalars * valid, idx, n_graphs)
        cnt = _segment_sum(valid, idx, n_graphs)
        scalars = pooled / torch.clamp_min(cnt, 1.0)
    return mlp_apply(params["decode"], scalars)


def loss_fn(params: Params, batch: Dict, cfg: EquiformerConfig,
            rules: Rules = NO_MESH) -> Tuple[torch.Tensor, Dict]:
    """Masked mean cross-entropy of :func:`forward`'s logits:
    ``(ce, {"ce": ce})``."""
    logits = forward(params, batch, cfg, rules)
    dev = logits.device
    mask = batch.get("label_mask")
    ce = cross_entropy(logits, torch.as_tensor(batch["labels"], device=dev),
                       None if mask is None
                       else torch.as_tensor(mask, device=dev))
    return ce, {"ce": ce}
