"""Public kernel API of the port, dispatched on the device of the tensors.

Twin of ``repro/kernels/ops.py``. Every op has two implementations in its
own module: the hand-written CUDA kernel (``csrc/<name>.cu``) and the plain
PyTorch version of the same function. A CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, or the call raises. There is no
capability probe and no fallback: the device of the data decides.

The ELL and BSR layouts are built once per graph (level) on the host (the
structure is static); only the partition labels or the features change
between calls.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import bag_combine as _bag
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels import bucket_assign as _ba
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gather_combine as _gc
from repro_torch.kernels import match_keys as _mk
from repro_torch.kernels import partition_gain as _pg
from repro_torch.kernels import quotient_link_loads as _qll

KERNEL_MODULES = {"match_keys": _mk, "bucket_assign": _ba,
                  "quotient_link_loads": _qll, "partition_gain": _pg,
                  "bag_combine": _bag, "gather_combine": _gc,
                  "bsr_spmm": _bsr, "flash_attention": _fa}


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset; ``match_round``
    is the fused matching round of ``match_keys.cu``, ``prefix_split`` the
    fused capacity-prefix split of ``bucket_assign.cu``."""
    counts = {name: mod.launches for name, mod in KERNEL_MODULES.items()}
    counts["match_round"] = _mk.round_launches
    counts["prefix_split"] = _ba.split_launches
    return counts


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
    _mk.round_launches = 0
    _ba.split_launches = 0
    _qll.launch_shapes.clear()


def match_keys(w: torch.Tensor, u: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """key[a] = w[a]*(1 + 0.01*u[a]) on arcs with mask>0, else -1. [m]"""
    return _mk.match_keys(w, u, mask)


def match_round(s: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """One heavy-edge matching round: per sender, the live arc (both ends
    unmatched, w > 0) of the largest jittered key, the largest arc id
    among equal keys; -1 where none. [n] int32"""
    return _mk.match_round(s, r, w, u, matched)


def bucket_assign(cum: torch.Tensor, boundaries: torch.Tensor,
                  k: int) -> torch.Tensor:
    """bin[v] = #{i : cum[v] >= boundaries[i]} over the k-1 interior
    capacity prefix targets. [n] int32 in [0, k-1]."""
    return _ba.bucket_assign(cum, boundaries, k)


def prefix_split(node_weight: torch.Tensor, boundaries: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The capacity-prefix split in one kernel: the midpoints
    ``cumsum(w) - w / 2`` of the float32 node weights bucketed against the
    k-1 non-decreasing boundaries (checked on the host; unsorted ones
    raise). [n] int32 in [0, k-1]."""
    return _ba.prefix_split(node_weight, boundaries, k)


def prefix_split_host(node_weight: np.ndarray, boundaries: np.ndarray,
                      k: int, device: torch.device) -> np.ndarray:
    """:func:`prefix_split` of host arrays on ``device``: one pinned copy of
    the weights and boundaries in, one launch, the bins back. [n] int32."""
    return _ba.prefix_split_host(node_weight, boundaries, k, device)


def partition_gain(part: torch.Tensor, nbr_idx: torch.Tensor,
                   nbr_w: torch.Tensor, k: int) -> torch.Tensor:
    """conn[v, j] = sum_{u in N(v), P(u)=j} w_vu from the ELL layout of
    :func:`to_ell` (padding slots hold neighbour id ``n``). [n, k]"""
    return _pg.partition_gain(part, nbr_idx, nbr_w, k)


def link_loads(part: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, edge_weight: torch.Tensor,
               subtree: torch.Tensor, F_l: torch.Tensor,
               k: int) -> torch.Tensor:
    """``F_l * comm(l)`` per link of a tree from the arc list. [L]"""
    return _qll.quotient_link_loads(part, senders, receivers, edge_weight,
                                    subtree, F_l, k)


def link_loads_and_quotient(part: torch.Tensor, senders: torch.Tensor,
                            receivers: torch.Tensor,
                            edge_weight: torch.Tensor, subtree: torch.Tensor,
                            F_l: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`link_loads` ``[L]`` and the quotient matrix ``[k, k]`` it was
    summed from."""
    return _qll.loads_and_quotient(part, senders, receivers, edge_weight,
                                   subtree, F_l, k)


class TakeRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's gradients in one
    fixed order, so a step is bitwise repeatable. Autograd's own index
    backward is ``index_put_(accumulate=True)``: on CUDA a sort of the ids
    and one warp summing each row's run in order (repeatable), on the CPU
    a parallel scatter whose sums change from run to run with duplicate
    ids. Here CUDA keeps that ``index_put_``; the CPU takes
    ``index_add_``, which walks the ids in order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        flat = idx.reshape(-1).long()
        rows = g.reshape(flat.shape[0], *g.shape[idx.dim():])
        out = torch.zeros((ctx.n_rows, *rows.shape[1:]), dtype=g.dtype,
                          device=g.device)
        if g.device.type == "cuda":
            out.index_put_((flat,), rows, accumulate=True)
        else:
            out.index_add_(0, flat, rows)
        return out, None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of a [V, ...] table by an integer tensor of
    any shape), through :class:`TakeRows` where autograd records."""
    if torch.is_grad_enabled() and table.requires_grad:
        return TakeRows.apply(table, idx)
    return table[idx]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """[V, F] table, [B, D] row ids (pad slots point at any row with
    w = 0), [B, D] per-slot weights -> [B, F]: the gather as plain
    indexing (the reference leaves it to XLA; :func:`take_rows` under
    autograd), then ``bag_combine``."""
    gathered = take_rows(table, idx)       # [B, D, F]
    return _bag.bag_combine(gathered, weights.to(gathered.dtype))


def gather_combine(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """:func:`embedding_bag` with the gather fused into the kernel: no
    ``[B, D, F]`` tensor is materialised. ``idx`` int32."""
    return _gc.gather_combine(table, idx, weights)


def gnn_aggregate(senders: torch.Tensor, receivers: torch.Tensor,
                  edge_weight: torch.Tensor, x: torch.Tensor,
                  n_nodes: int) -> torch.Tensor:
    """out[v] = sum over arcs (v <- u) of w_vu * x[u]: the plain gather and
    ``index_add_`` (the reference's XLA path, ``segment_sum``). [n, F]"""
    msg = x[receivers.long()] * edge_weight[:, None].to(x.dtype)
    return torch.zeros((n_nodes,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add_(0, senders.long(), msg)


def prepare_bsr(n_nodes: int, senders: np.ndarray, receivers: np.ndarray,
                edge_weight: np.ndarray, block: int = 128,
                device: DeviceLike = None) -> _bsr.BsrLayout:
    """The graph's BSR layout, built once on the host (``to_bsr``) with its
    block-row pointers, then moved to ``device`` (``None`` = CUDA), where
    its blocks' nonzero sub-blocks are marked (``slab_occupancy``)."""
    dev = resolve_device(device)
    senders, receivers = np.asarray(senders), np.asarray(receivers)
    for name, ids in (("senders", senders), ("receivers", receivers)):
        # the kernel reads x rows by block column unchecked
        if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= n_nodes):
            raise ValueError(f"prepare_bsr: {name} outside [0, {n_nodes})")
    rows, cols, blocks, nb = _bsr.to_bsr(n_nodes, senders, receivers,
                                         np.asarray(edge_weight), block)
    blocks = torch.as_tensor(blocks, device=dev)
    return _bsr.BsrLayout(
        row_ptr=torch.as_tensor(_bsr.row_pointers(rows, nb), device=dev),
        block_cols=torch.as_tensor(cols, device=dev), blocks=blocks,
        occupancy=_bsr.slab_occupancy(blocks), n_block_rows=nb,
        n_nodes=n_nodes)


def gnn_aggregate_bsr(layout: _bsr.BsrLayout,
                      x: torch.Tensor) -> torch.Tensor:
    """:func:`gnn_aggregate` through the ``bsr_spmm`` kernel on the layout
    of :func:`prepare_bsr`: ``x [n, F]`` padded with zero rows to the
    layout's ``n_block_rows * R``, the product sliced back to ``[n, F]``."""
    pad = layout.n_block_rows * layout.block - x.shape[0]
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    out = _bsr.bsr_spmm(layout.row_ptr, layout.block_cols, layout.blocks,
                        x.contiguous(), layout.occupancy)
    return out[:layout.n_nodes]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention, GQA through ``h // (H / KH)``, top-left
    causal: q ``[B, Sq, H, D]``, k ``[B, Sk, KH, D]``, v ``[B, Sk, KH,
    Dv]`` -> ``[B, Sq, H, Dv]`` (MLA: D = 192, Dv = 128). Differentiable: where autograd records, it goes through
    ``FlashAttention`` (the kernel's forward with its log-sum-exp, the
    plain ``_flash_bwd`` recompute); under ``torch.no_grad`` it is the
    forward alone. ``q_chunk`` / ``kv_chunk`` tile the plain versions (the
    forward on CPU tensors, the backward on both); the kernel has its own
    tiles."""
    return _fa.attention(q, k, v, causal=causal, q_chunk=q_chunk,
                         kv_chunk=kv_chunk)


def to_ell(n_nodes: int, senders: np.ndarray, receivers: np.ndarray,
           edge_weight: np.ndarray, max_degree: Optional[int] = None
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Host ELL conversion. Returns (nbr_idx [n, D], nbr_w [n, D]);
    padding slots point at the sentinel row ``n_nodes`` with weight 0.
    ``max_degree`` caps D (overflow arcs dropped).

    Vectorised twin of the reference's per-arc loop, with the same result:
    after a stable sort by sender, an arc's slot is its rank within its
    sender's run, ``arange(m) - start[sender]``."""
    senders = np.asarray(senders)
    deg = np.bincount(senders, minlength=n_nodes).astype(np.int64) \
        if senders.size else np.zeros(n_nodes, dtype=np.int64)
    d = int(deg.max()) if deg.size else 0
    if max_degree is not None:
        d = min(d, max_degree)
    d = max(d, 1)
    nbr_idx = np.full((n_nodes, d), n_nodes, dtype=np.int32)
    nbr_w = np.zeros((n_nodes, d), dtype=np.float32)
    order = np.argsort(senders, kind="stable")
    s = senders[order]
    start = np.cumsum(deg) - deg
    slot = np.arange(s.size, dtype=np.int64) - start[s]
    keep = slot < d
    nbr_idx[s[keep], slot[keep]] = np.asarray(receivers)[order][keep]
    nbr_w[s[keep], slot[keep]] = np.asarray(edge_weight)[order][keep]
    return nbr_idx, nbr_w
