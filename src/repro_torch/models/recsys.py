"""Two-tower retrieval serving (YouTube RecSys'19): embedding tables ->
tower MLPs -> dot product. Twin of the serving half of
``repro/models/recsys.py`` (``user_embed``, ``item_embed``, ``score``,
``retrieve``); the training loss waits for a later slice.

The user tower's input is a mean-combined bag over the item table: the
gather is plain indexing and the weighted reduction the ``bag_combine``
CUDA kernel (``kernels.ops.embedding_bag``). ``row_perm`` (``[V]``,
original -> physical row) serves a table permuted device-contiguous by an
embed shard plan (``embed.sharded_table``); results are bitwise those of
the unpermuted table.

On one card every sharding rule of the reference resolves to no
constraint, so the port has no ``Rules``. The serving methods run without
autograd: the kernels have no backward yet.

Batch dicts (numpy arrays or tensors; moved to the model's device):
  serve:      user_hist [B, H] int32 (item-id bags, -1 pad),
              user_dense [B, F_d], item_id [B], item_cat [B]
  retrieval:  one user + cand_emb [N_cand, D] precomputed item embeddings
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.mlp import MLP


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    n_items: int = 1_000_000
    n_cats: int = 10_000
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    hist_len: int = 50
    d_dense: int = 16
    dtype: torch.dtype = torch.float32


def _row_pad(n: int, m: int = 8) -> int:
    """Rows padded to a multiple of ``m``: the lcm of the device count and
    8 sublanes in the reference; 8 on one card, so 1,000,000 stays."""
    return (n + m - 1) // m * m


def _bag_lookup(table: torch.Tensor, ids: torch.Tensor,
                row_perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-combine embedding bag; ids [B, H] with -1 padding, mapped to
    row 0 with weight 0 before the gather."""
    valid = ids >= 0
    safe = ids.clamp_min(0)
    if row_perm is not None:
        safe = row_perm[safe]
    lens = valid.sum(-1, keepdim=True).clamp_min(1)
    w = valid.to(table.dtype) / lens.to(table.dtype)
    return kops.embedding_bag(table, safe, w)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


class TwoTower(nn.Module):
    def __init__(self, cfg: TwoTowerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        """Tables normal x 0.01, towers as :class:`MLP`, all drawn in that
        order from ``generator`` on ``device`` (``None`` = CUDA). On the
        ``meta`` device nothing is allocated, for ``load_state_dict(...,
        assign=True)``."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        e = cfg.embed_dim

        def table(n: int) -> nn.Parameter:
            return nn.Parameter(torch.randn(
                _row_pad(n), e, generator=generator, device=dev,
                dtype=cfg.dtype) * 0.01)

        self.item_table = table(cfg.n_items)
        self.cat_table = table(cfg.n_cats)
        self.user_tower = MLP((e + cfg.d_dense, *cfg.tower_mlp),
                              generator=generator, device=dev,
                              dtype=cfg.dtype)
        self.item_tower = MLP((2 * e, *cfg.tower_mlp), generator=generator,
                              device=dev, dtype=cfg.dtype)

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.item_table.device)

    @torch.no_grad()
    def user_embed(self, batch: Dict, row_perm=None) -> torch.Tensor:
        """[B, D] unit-norm user embeddings."""
        perm = None if row_perm is None else self._on_device(row_perm)
        hist = _bag_lookup(self.item_table, self._on_device(batch["user_hist"]),
                           perm)
        dense = self._on_device(batch["user_dense"]).to(self.cfg.dtype)
        return _normalize(self.user_tower(torch.cat([hist, dense], -1)))

    @torch.no_grad()
    def item_embed(self, batch: Dict, row_perm=None) -> torch.Tensor:
        """[B, D] unit-norm item embeddings."""
        item_id = self._on_device(batch["item_id"])
        if row_perm is not None:
            item_id = self._on_device(row_perm)[item_id]
        it = self.item_table[item_id]
        ct = self.cat_table[self._on_device(batch["item_cat"])]
        return _normalize(self.item_tower(torch.cat([it, ct], -1)))

    @torch.no_grad()
    def score(self, batch: Dict, row_perm=None) -> torch.Tensor:
        """Pointwise serving: score[b] = <u_b, v_b>. [B]"""
        u = self.user_embed(batch, row_perm)
        v = self.item_embed(batch, row_perm)
        return torch.sum(u * v, dim=-1)

    @torch.no_grad()
    def retrieve(self, batch: Dict, top_k: int = 1024, row_perm=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One query against a precomputed candidate matrix [N_cand, D]:
        one matrix-vector product + top-k. Returns (values, indices)."""
        u = self.user_embed(batch, row_perm)                 # [1, D]
        cand = self._on_device(batch["cand_emb"]).to(self.cfg.dtype)
        scores = (cand @ u[0]).to(torch.float32)             # [N_cand]
        return torch.topk(scores, top_k)
