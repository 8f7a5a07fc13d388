"""One continuous-batching decode step over the paged KV cache.

Twin of ``repro/serving/paged_decode.py``. Mirrors
``models.transformer.decode_step`` (GQA attention; dense or MoE FFNs, the
latter through ``moe_ffn`` over the step's B tokens) with two changes:

  * per-request positions: ``lengths[b]`` is the number of tokens already
    cached for slot ``b`` — the new token is written there and the causal
    mask is per-row, so mixed prompt/gen lengths batch together;
  * K/V live in page pools ``[n_layers, n_pages + 1, page_size, kh, dh]``
    and are addressed through per-slot page tables, so any physical page
    order (fragmented, placement-permuted) produces the same logits.

The new token's K/V are written through the page table into the pools in
place (the reference returns updated pools), then the full history is
gathered back through it: scatter before gather. The attention arithmetic
is ``models.transformer.decode_attn``, shared with the dense decode step,
which is what makes paged and dense decode agree.

Idle slots are harmless by construction: the engine points them at the
sentinel page (index ``n_pages``) with ``lengths = 0``, so they write
only the sentinel, attend over exactly one finite position, and their
logits are discarded.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import rope_freqs
from repro_torch.models.transformer import (Params, TransformerConfig, _qkv,
                                            _rope_tables, _rotate_partial,
                                            decode_attn, decode_layers)


def _paged_attn_gqa(p: Params, x: torch.Tensor, k_l: torch.Tensor,
                    v_l: torch.Tensor, page_table: torch.Tensor,
                    phys: torch.Tensor, off: torch.Tensor,
                    mask: torch.Tensor, cfg: TransformerConfig,
                    tables) -> torch.Tensor:
    """x: [B, 1, D]; k_l/v_l: one layer's pools [n_pages + 1, P, kh, dh],
    written in place at (``phys``, ``off``), the new token's page and
    offset; ``mask`` [B, 1, 1, max_s] and the RoPE ``tables`` are the
    step's. Returns the attention output [B, 1, D]."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = _qkv(p, x, cfg)
    q = _rotate_partial(q.reshape(b, 1, h, dh), tables, cfg.rope_fraction)
    kk = _rotate_partial(kk.reshape(b, 1, kh, dh), tables, cfg.rope_fraction)
    # write the new token through the page table, then read the full
    # (updated) history back through it — scatter before gather
    k_l[phys, off] = kk[:, 0]
    v_l[phys, off] = v.reshape(b, kh, dh)
    k_cache = k_l[page_table].reshape(b, -1, kh, dh)      # [B, max_s, ...]
    v_cache = v_l[page_table].reshape(b, -1, kh, dh)
    return decode_attn(q, k_cache, v_cache, mask, cfg) @ p["w_o"]


@torch.no_grad()
def paged_decode_step(params: Params, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, page_table: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor,
                      cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B, 1] int, lengths [B] int, page_table [B, max_pages] int
    (all on the pools' device) -> logits [B, V]; the pools are updated in
    place. What every layer shares (the new token's page and offset, the
    causal mask, the RoPE tables at each slot's position) is made once."""
    if cfg.mla:
        raise NotImplementedError("paged decode serves the GQA cache "
                                  "layout (see PagedKVCache)")
    dev = tokens.device
    b = tokens.shape[0]
    page = k_pool.shape[2]
    max_seq = page_table.shape[1] * page
    page_table, lengths = page_table.long(), lengths.long()
    angles = rope_freqs(cfg.head_dim, max_seq, cfg.rope_theta, device=dev)
    tables = _rope_tables(angles[lengths][:, None, :], cfg)
    phys = page_table[torch.arange(b, device=dev), lengths // page]
    off = lengths % page
    mask = (torch.arange(max_seq, device=dev)[None, :]
            <= lengths[:, None])[:, None, None, :]
    x = params["embed"][tokens.long()]
    return decode_layers(
        params, x, cfg,
        lambda li, p, hn: _paged_attn_gqa(p, hn, k_pool[li], v_pool[li],
                                          page_table, phys, off, mask, cfg,
                                          tables))
