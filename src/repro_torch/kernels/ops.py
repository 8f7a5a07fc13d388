"""Public kernel API of the port, dispatched on the device of the tensors.

Twin of ``repro/kernels/ops.py``. Every op has two implementations in its
own module: the hand-written CUDA kernel (``csrc/<name>.cu``) and the plain
PyTorch version of the same function. A CPU tensor goes to the plain
version; a CUDA tensor goes to the kernel, or the call raises. There is no
capability probe and no fallback: the device of the data decides.

The ELL layout is built once per graph level on the host (the structure is
static), only the partition labels change per refinement round.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import bucket_assign as _ba
from repro_torch.kernels import match_keys as _mk
from repro_torch.kernels import partition_gain as _pg
from repro_torch.kernels import quotient_link_loads as _qll

KERNEL_MODULES = {"match_keys": _mk, "bucket_assign": _ba,
                  "quotient_link_loads": _qll, "partition_gain": _pg}


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def match_keys(w: torch.Tensor, u: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """key[a] = w[a]*(1 + 0.01*u[a]) on arcs with mask>0, else -1. [m]"""
    return _mk.match_keys(w, u, mask)


def bucket_assign(cum: torch.Tensor, boundaries: torch.Tensor,
                  k: int) -> torch.Tensor:
    """bin[v] = #{i : cum[v] >= boundaries[i]} over the k-1 interior
    capacity prefix targets. [n] int32 in [0, k-1]."""
    return _ba.bucket_assign(cum, boundaries, k)


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
