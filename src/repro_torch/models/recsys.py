"""Two-tower retrieval (YouTube RecSys'19): embedding tables -> tower
MLPs -> dot product -> in-batch sampled softmax with logQ correction. Twin
of ``repro/models/recsys.py``: the functional ``init``, ``user_embed``,
``item_embed``, ``loss_fn``, ``score`` and ``retrieve`` over a params dict
of the reference's layout (``item_table``, ``cat_table`` and the towers'
``{"w": [...], "b": [...]}``), and :class:`TwoTower`, the same model as a
module whose serving methods run under ``torch.no_grad``.

The user tower's input is a mean-combined bag over the item table: the
gather is plain indexing and the weighted reduction the ``bag_combine``
CUDA kernel (``kernels.ops.embedding_bag``), differentiable through its
plain backward, so ``loss_fn`` trains under autograd. ``row_perm``
(``[V]``, original -> physical row) serves a table permuted
device-contiguous by an embed shard plan (``embed.sharded_table``);
results are bitwise those of the unpermuted table.

:func:`param_specs` is the reference's spec tree, and the functions take
its ``rules`` (default ``NO_MESH``: no constraint, the plain path bitwise)
at its ``rules.shard`` sites. On DTensors (the placement trace) the
lookups of the row-sharded tables are vocab-parallel
(``dist.sharding.embed_rows``) and the bag's weighted sum plain; the
tables pad their rows to ``lcm(mesh size, 8)`` there (``row_multiple``),
as the reference pads to its device count.

Batch dicts (numpy arrays or tensors; moved to the table's device):
  train:      user_hist [B, H] int32 (item-id bags, -1 pad),
              user_dense [B, F_d], item_id [B], item_cat [B], log_q [B]?
  serve:      the same without the in-batch softmax (pointwise score)
  retrieval:  one user + cand_emb [N_cand, D] precomputed item embeddings
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device, tree
from repro_torch.dist.sharding import (NO_MESH, Rules, _is_dtensor,
                                       embed_rows, placed_like)
from repro_torch.kernels import ops as kops
from repro_torch.models.gnn import _mlp_spec
from repro_torch.models.mlp import MLP, mlp_apply

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    n_items: int = 1_000_000
    n_cats: int = 10_000
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    hist_len: int = 50
    d_dense: int = 16
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32

    def n_params(self) -> int:
        e = self.embed_dim
        emb = (self.n_items + self.n_cats) * e
        dims_u = [e + self.d_dense] + list(self.tower_mlp)
        dims_i = [2 * e] + list(self.tower_mlp)
        mlps = sum(a * b + b for a, b in zip(dims_u[:-1], dims_u[1:]))
        mlps += sum(a * b + b for a, b in zip(dims_i[:-1], dims_i[1:]))
        return emb + mlps


def _row_pad(n: int, m: int = 8) -> int:
    """Rows padded to a multiple of ``m``: the lcm of the device count and
    8 sublanes in the reference; 8 on one card, so 1,000,000 stays."""
    return (n + m - 1) // m * m


def param_specs(cfg: TwoTowerConfig, rules: Rules) -> Params:
    """The spec tree of :func:`init`'s params (the reference's ``init``
    specs): the tables over ``rows``, the towers through ``_mlp_spec``."""
    def tower(dims):
        n = len(dims) - 1
        return _mlp_spec({"w": [None] * n, "b": [None] * n}, rules)
    e = cfg.embed_dim
    return {"item_table": rules.spec("rows", None),
            "cat_table": rules.spec("rows", None),
            "user_tower": tower((e + cfg.d_dense, *cfg.tower_mlp)),
            "item_tower": tower((2 * e, *cfg.tower_mlp))}


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: ``kops.take_rows``, or on a DTensor table the
    vocab-parallel lookup (``embed_rows``) with its partial rows reduced
    onto the ids' shards."""
    if _is_dtensor(table):
        return placed_like(embed_rows(table, ids), ids)
    return kops.take_rows(table, ids)


def _bag_lookup(table: torch.Tensor, ids: torch.Tensor,
                row_perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-combine embedding bag; ids [B, H] with -1 padding, mapped to
    row 0 with weight 0 before the gather. A DTensor table takes the
    vocab-parallel bag (``embed_rows`` with the weights; the
    kernel's wrapper runs on the card or the CPU, never on ``meta``), each
    bag summed on the device that holds its rows and then reduced onto the
    ids' shards."""
    valid = ids >= 0
    safe = ids.clamp_min(0)
    if row_perm is not None:
        safe = row_perm[safe]
    lens = valid.sum(-1, keepdim=True).clamp_min(1)
    w = valid.to(table.dtype) / lens.to(table.dtype)
    if _is_dtensor(table):
        return placed_like(embed_rows(table, safe, w), safe)
    return kops.embedding_bag(table, safe, w)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    if _is_dtensor(x):
        # vector_norm's backward masks its gradient in place, which DTensor
        # refuses on the partial gradient of a tensor-parallel tower
        norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    else:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(norm, 1e-6)


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


def user_embed(p: Params, batch: Dict, cfg: TwoTowerConfig,
               row_perm=None) -> torch.Tensor:
    """[B, D] unit-norm user embeddings."""
    table = p["item_table"]
    perm = None if row_perm is None else _on(row_perm, table)
    hist = _bag_lookup(table, _on(batch["user_hist"], table), perm)
    dense = _on(batch["user_dense"], table).to(cfg.dtype)
    return _normalize(mlp_apply(p["user_tower"], torch.cat([hist, dense],
                                                           -1)))


def item_embed(p: Params, batch: Dict, cfg: TwoTowerConfig,
               row_perm=None) -> torch.Tensor:
    """[B, D] unit-norm item embeddings."""
    table = p["item_table"]
    item_id = _on(batch["item_id"], table)
    if row_perm is not None:
        item_id = _on(row_perm, table)[item_id]
    it = _take(table, item_id)
    ct = _take(p["cat_table"], _on(batch["item_cat"], table))
    return _normalize(mlp_apply(p["item_tower"], torch.cat([it, ct], -1)))


def loss_fn(p: Params, batch: Dict, cfg: TwoTowerConfig, row_perm=None,
            rules: Rules = NO_MESH
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """In-batch sampled softmax with logQ correction (Yi et al. '19):
    ``(loss, {"ce", "acc"})``, differentiable in ``p``. The ``[B, B]``
    logits are float32 and held once (``B = 32,768`` makes each such
    tensor 4.3 GB)."""
    u = rules.shard(user_embed(p, batch, cfg, row_perm), "batch", None)
    v = rules.shard(item_embed(p, batch, cfg, row_perm), "batch", None)
    logits = rules.shard((u @ v.T) / cfg.temperature,
                         "batch", "model")               # [B, B]
    # logQ: in-batch negatives are sampled in proportion to frequency
    logq = batch.get("log_q")
    if logq is not None:
        logits = logits - _on(logq, logits)[None, :]
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if _is_dtensor(logits):
        # each row's own item, its logit formed again: the card's torch has
        # no sharding rule for the diagonal's backward
        gold = (torch.sum(u * v, dim=-1) / cfg.temperature).to(torch.float32)
        if logq is not None:
            gold = gold - _on(logq, gold).to(torch.float32)
    else:
        gold = torch.diagonal(logits)
    loss = (logz - gold).mean()
    labels = torch.arange(logits.shape[0], device=logits.device)
    acc = (logits.detach().argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"ce": loss.detach(), "acc": acc}


def score(p: Params, batch: Dict, cfg: TwoTowerConfig,
          row_perm=None) -> torch.Tensor:
    """Pointwise serving: score[b] = <u_b, v_b>. [B]"""
    u = user_embed(p, batch, cfg, row_perm)
    v = item_embed(p, batch, cfg, row_perm)
    return torch.sum(u * v, dim=-1)


def retrieve(p: Params, batch: Dict, cfg: TwoTowerConfig, top_k: int = 1024,
             row_perm=None, rules: Rules = NO_MESH
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query against a precomputed candidate matrix [N_cand, D]: one
    matrix-vector product + top-k. Returns (values, indices)."""
    u = user_embed(p, batch, cfg, row_perm)                  # [1, D]
    cand = rules.shard(_on(batch["cand_emb"], u).to(cfg.dtype), "cand",
                       None)
    scores = (cand @ u[0]).to(torch.float32)                 # [N_cand]
    return torch.topk(scores, top_k)


def init(cfg: TwoTowerConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None, row_multiple: int = 8) -> Params:
    """The params dict of :class:`TwoTower` drawn from ``generator`` on
    ``device`` (``None`` = CUDA): tables normal x 0.01, then the towers,
    in that order; plain tensors, not parameters. The tables' rows pad to
    a multiple of ``row_multiple``."""
    with torch.no_grad():
        return params_of(TwoTower(cfg, generator=generator, device=device,
                                  row_multiple=row_multiple))


def params_of(model: "TwoTower") -> Params:
    """A module's tensors as a functional params dict, detached (shared
    storage, no autograd history)."""
    return tree.map_(lambda t: t.detach(), model.params())


class TwoTower(nn.Module):
    def __init__(self, cfg: TwoTowerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, row_multiple: int = 8):
        """Tables normal x 0.01 (rows padded to a multiple of
        ``row_multiple``), towers as :class:`MLP`, all drawn in that order
        from ``generator`` on ``device`` (``None`` = CUDA). On the ``meta``
        device nothing is allocated, for ``load_state_dict(...,
        assign=True)``."""
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        e = cfg.embed_dim

        def table(n: int) -> nn.Parameter:
            return nn.Parameter(torch.randn(
                _row_pad(n, row_multiple), e, generator=generator, device=dev,
                dtype=cfg.dtype) * 0.01)

        self.item_table = table(cfg.n_items)
        self.cat_table = table(cfg.n_cats)
        self.user_tower = MLP((e + cfg.d_dense, *cfg.tower_mlp),
                              generator=generator, device=dev,
                              dtype=cfg.dtype)
        self.item_tower = MLP((2 * e, *cfg.tower_mlp), generator=generator,
                              device=dev, dtype=cfg.dtype)

    def params(self) -> Params:
        """The module's tensors in the functional params layout."""
        return {"item_table": self.item_table, "cat_table": self.cat_table,
                "user_tower": self.user_tower.params(),
                "item_tower": self.item_tower.params()}

    @torch.no_grad()
    def user_embed(self, batch: Dict, row_perm=None) -> torch.Tensor:
        """[B, D] unit-norm user embeddings."""
        return user_embed(self.params(), batch, self.cfg, row_perm)

    @torch.no_grad()
    def item_embed(self, batch: Dict, row_perm=None) -> torch.Tensor:
        """[B, D] unit-norm item embeddings."""
        return item_embed(self.params(), batch, self.cfg, row_perm)

    @torch.no_grad()
    def score(self, batch: Dict, row_perm=None) -> torch.Tensor:
        """Pointwise serving: score[b] = <u_b, v_b>. [B]"""
        return score(self.params(), batch, self.cfg, row_perm)

    @torch.no_grad()
    def retrieve(self, batch: Dict, top_k: int = 1024, row_perm=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One query against a precomputed candidate matrix [N_cand, D]:
        one matrix-vector product + top-k. Returns (values, indices)."""
        return retrieve(self.params(), batch, self.cfg, top_k, row_perm)
