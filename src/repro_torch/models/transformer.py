"""Dense GQA transformers (qwen2, chatglm3): twin of the dense path of
``repro/models/transformer.py``.

Ported: ``TransformerConfig`` (with ``n_params`` / ``n_active_params`` for
every kind), ``init``, ``_partial_rope``, ``gqa_attention``, ``_layer_fwd``,
``forward``, ``loss_fn``, ``prefill``, ``init_cache``, ``_decode_attn_gqa``
and ``decode_step``. Every layer's attention runs the hand-written
``flash_attention`` CUDA kernel on CUDA tensors
(``kernels.ops.flash_attention``; the reference runs the pure-JAX ``_flash``
there, the same function) and its plain chunked version on CPU tensors.
MoE (deepseek-v2) and MLA raise ``NotImplementedError``: they wait for a
later slice.

Training: :func:`forward_core` is differentiable and ``loss_fn`` runs it.
The attention's backward is the reference's ``_flash_bwd`` recompute in
plain PyTorch (``FlashAttention``, ``kernels/flash_attention.py``). With
``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (the twin of
the reference's ``jax.checkpoint`` per scanned layer): only the layer
inputs are kept, and the backward recomputes each layer's forward,
relaunching the kernel. So a training step launches ``flash_attention``
twice per layer (56 times at Qwen2-1.5B's 28 layers: 28 in the forward, 28
in the recompute) and its backward launches none. ``forward`` /
``prefill`` and the server run under ``torch.no_grad`` and launch it once
per layer, without the log-sum-exp.

Parameters are a plain dict of tensors in the reference's ``[in, out]``
orientation (``x @ w``), with the reference's per-layer stack unrolled into
``params["layers"]``, a list of one dict per layer
(``interop.transformer_params_from`` carries the reference's across). One
card has no mesh, so the reference's ``Rules`` sharding annotations have no
counterpart and are ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import (cross_entropy, rms_norm, rope_freqs,
                                      rope_tables, rotate, swiglu)

Params = Dict[str, Any]
Attend = Callable[..., torch.Tensor]

_LATER = ("{what} waits for a later slice of the port (ROADMAP.md: MoE "
          "dispatch, then MLA with its absorbed decode)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0            # chatglm3: 0.5
    rope_theta: float = 1e4
    # --- MoE (deepseek-v2) ---
    moe: bool = False
    n_experts: int = 0                    # routed experts
    n_shared: int = 0                     # shared experts
    top_k: int = 0
    d_ff_expert: int = 0                  # per-expert hidden
    n_dense_layers: int = 0               # leading dense-FFN layers
    capacity_factor: float = 1.5
    aux_loss_coef: float = 0.003
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0                  # 0 = direct q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- numerics / runtime ---
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    max_seq: int = 32768
    q_chunk: int = 512            # plain flash attention tiling (0 = full seq)
    kv_chunk: int = 512
    ep_shard_map: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def qk_head_dim(self) -> int:
        return (self.qk_nope_head_dim + self.qk_rope_head_dim
                if self.mla else self.head_dim)

    def n_params(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting)."""
        d, h, kh = self.d_model, self.n_heads, self.n_kv_heads
        dh = self.head_dim
        if self.mla:
            r, dr = self.kv_lora_rank, self.qk_rope_head_dim
            dn, dv = self.qk_nope_head_dim, self.v_head_dim
            attn = d * (self.q_lora_rank or 0)
            q_in = self.q_lora_rank if self.q_lora_rank else d
            attn += q_in * h * (dn + dr)          # q proj
            attn += d * (r + dr)                  # compressed kv + rope key
            attn += r * h * (dn + dv)             # up-projections
            attn += h * dv * d                    # out
        else:
            attn = d * (h + 2 * kh) * dh + h * dh * d
        per_layer = []
        for li in range(self.n_layers):
            ffn = 3 * d * self.d_ff
            if self.moe and li >= self.n_dense_layers:
                ffn = 3 * d * self.d_ff_expert * (self.n_experts + self.n_shared)
                ffn += d * self.n_experts         # router
            per_layer.append(attn + ffn + 2 * d)
        return sum(per_layer) + 2 * self.vocab * d + d

    def n_active_params(self) -> int:
        """Activated parameters per token (MoE: only routed top-k count)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        inactive = (self.n_experts - self.top_k) * 3 * d * self.d_ff_expert \
            * (self.n_layers - self.n_dense_layers)
        return total - inactive


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(_LATER.format(what="MoE"))
    if cfg.mla:
        raise NotImplementedError(_LATER.format(what="MLA"))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Standard-normal ``[d_in, d_out]`` times ``scale`` (default
    ``1/sqrt(d_in)``), drawn in float32 and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def _layer_init(gen, cfg: TransformerConfig, dev) -> Params:
    d, h, kh, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype
    attn = {"w_q": dense_init(gen, d, h * dh, dt, dev),
            "w_k": dense_init(gen, d, kh * dh, dt, dev),
            "w_v": dense_init(gen, d, kh * dh, dt, dev),
            "w_o": dense_init(gen, h * dh, d, dt, dev)}
    if cfg.qkv_bias:
        attn.update(b_q=torch.zeros(h * dh, dtype=dt, device=dev),
                    b_k=torch.zeros(kh * dh, dtype=dt, device=dev),
                    b_v=torch.zeros(kh * dh, dtype=dt, device=dev))
    ffn = {"w_gate": dense_init(gen, d, f, dt, dev),
           "w_up": dense_init(gen, d, f, dt, dev),
           "w_down": dense_init(gen, f, d, dt, dev)}
    return {"attn": attn, "ffn": ffn,
            "ln1": torch.ones(d, dtype=dt, device=dev),
            "ln2": torch.ones(d, dtype=dt, device=dev)}


def init(cfg: TransformerConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Params:
    """Random weights at the reference's shapes and scales
    (``transformer.py:init``): normal ``embed`` (scale 1), ``unembed`` and
    every projection at ``1/sqrt(d_in)``, zero QKV biases, unit norms.
    ``generator`` lives on ``device`` (``None`` = CUDA). The numbers differ
    from the reference's (``jax.random`` cannot be replayed); tests carry
    the reference's weights across with ``interop.transformer_params_from``.
    """
    _dense_only(cfg)
    dev = resolve_device(device)
    dt = cfg.dtype
    return {"embed": dense_init(generator, cfg.vocab, cfg.d_model, dt, dev,
                                scale=1.0),
            "unembed": dense_init(generator, cfg.d_model, cfg.vocab, dt, dev),
            "ln_f": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "layers": [_layer_init(generator, cfg, dev)
                       for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _rotary_dim(d: int, frac: float) -> int:
    """Rotated share of the head dim (chatglm3 rotates half of it)."""
    return d if frac >= 1.0 else int(d * frac) // 2 * 2


def _rope_tables(angles: torch.Tensor, cfg: TransformerConfig):
    """(cos, sin) tables of the rotated share, made once per forward or
    decode step and shared by every layer."""
    dr = _rotary_dim(cfg.head_dim, cfg.rope_fraction)
    return rope_tables(angles[..., : dr // 2], cfg.dtype)


def _rotate_partial(x: torch.Tensor, tables, frac: float) -> torch.Tensor:
    if frac >= 1.0:
        return rotate(x, *tables)
    dr = 2 * tables[0].shape[-1]
    return torch.cat([rotate(x[..., :dr], *tables), x[..., dr:]], dim=-1)


def _partial_rope(x: torch.Tensor, angles: torch.Tensor,
                  frac: float) -> torch.Tensor:
    """Rotate the first ``frac`` of the head dim (chatglm3 uses 0.5)."""
    dr = _rotary_dim(x.shape[-1], frac)
    return _rotate_partial(x, rope_tables(angles[..., : dr // 2], x.dtype),
                           frac)


def _qkv(p: Params, x: torch.Tensor, cfg: TransformerConfig):
    q = x @ p["w_q"]
    kk = x @ p["w_k"]
    v = x @ p["w_v"]
    if cfg.qkv_bias:
        q, kk, v = q + p["b_q"], kk + p["b_k"], v + p["b_v"]
    return q, kk, v


def gqa_attention(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                  tables, attend: Attend = ops.flash_attention
                  ) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] with the forward's RoPE ``tables``;
    ``attend`` is the attention forward (``ops.flash_attention``: the
    kernel on CUDA tensors)."""
    b, sq, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = _qkv(p, x, cfg)
    q = _rotate_partial(q.reshape(b, sq, h, dh), tables, cfg.rope_fraction)
    kk = _rotate_partial(kk.reshape(b, sq, kh, dh), tables,
                         cfg.rope_fraction)
    v = v.reshape(b, sq, kh, dh)
    o = attend(q.contiguous(), kk.contiguous(), v.contiguous(), causal=True,
               q_chunk=cfg.q_chunk or sq, kv_chunk=cfg.kv_chunk or sq)
    return o.reshape(b, sq, h * dh) @ p["w_o"]


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer_fwd(p: Params, x: torch.Tensor, cfg: TransformerConfig,
               tables, attend: Attend) -> torch.Tensor:
    x = x + gqa_attention(p["attn"], rms_norm(x, p["ln1"]), cfg, tables,
                          attend)
    hn = rms_norm(x, p["ln2"])
    return x + swiglu(hn, p["ffn"]["w_gate"], p["ffn"]["w_up"],
                      p["ffn"]["w_down"])


def forward_core(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig, attend: Attend = ops.flash_attention
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss scalar: 0 for dense),
    differentiable, with the attention ``attend`` in every layer. Where
    autograd records and ``cfg.remat`` is set, each layer is a
    non-reentrant ``torch.utils.checkpoint``: its forward runs again in the
    backward (see the module docstring for the launches)."""
    _dense_only(cfg)
    _, s = tokens.shape
    tables = _rope_tables(rope_freqs(cfg.head_dim, s, cfg.rope_theta,
                                     device=tokens.device), cfg)
    x = params["embed"][tokens.long()]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in params["layers"]:
        if remat:
            x = checkpoint(_layer_fwd, layer, x, cfg, tables, attend,
                           use_reentrant=False)
        else:
            x = _layer_fwd(layer, x, cfg, tables, attend)
    x = rms_norm(x, params["ln_f"])
    return x @ params["unembed"], torch.zeros((), device=tokens.device)


@torch.no_grad()
def forward_with(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig,
                 attend: Attend) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` with the attention forward ``attend`` in every layer
    (the checks hold the kernel against its plain version through it)."""
    return forward_core(params, tokens, cfg, attend)


def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss scalar: 0 for dense)."""
    return forward_with(params, tokens, cfg, ops.flash_attention)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, attend: Attend = ops.flash_attention
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + aux, {"ce", "aux"})`` over ``batch["tokens"]`` /
    ``["labels"]`` (and an optional ``["mask"]``): the reference's
    ``loss_fn``, differentiable through :func:`forward_core`."""
    logits, aux = forward_core(params, batch["tokens"], cfg, attend)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Prefill forward — logits for every position."""
    logits, _ = forward(params, tokens, cfg)
    return logits


# ---------------------------------------------------------------------------
# Decode (KV cache, one token)
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Params:
    """Zero ``{"k", "v"}`` caches ``[n_layers, batch, max_seq, kh, dh]``."""
    _dense_only(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, mask: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """One query token over a gathered cache: q [B, 1, H, dh], caches
    [B, max_s, kh, dh], mask [B or 1, 1, 1, max_s] -> [B, 1, H*dh]. The
    reference's masked softmax (``_decode_attn_gqa``): scores and the
    exponentials' sum in f32, the exponentials rounded to the cache's type
    for the value product, which is summed in f32. Written as two batched
    products over (batch, KV head) so a step launches few kernels."""
    b = q.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f32 = torch.float32
    qh = q.reshape(b, kh, h // kh, dh).to(f32)
    s = qh @ k_cache.to(f32).permute(0, 2, 3, 1) / float(np.sqrt(dh))
    s = torch.where(mask, s, -torch.inf)                  # [B, kh, g, max_s]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    num = e.to(v_cache.dtype).to(f32) @ v_cache.to(f32).transpose(1, 2)
    return (num / e.sum(dim=-1, keepdim=True)).to(q.dtype).reshape(
        b, 1, h * dh)


def _decode_attn_gqa(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int,
                     cfg: TransformerConfig, tables,
                     mask: torch.Tensor) -> torch.Tensor:
    """x [B, 1, D]; writes this token's K/V at ``pos`` of the layer's
    caches [B, max_s, kh, dh] in place (the reference returns updated
    copies) and attends over positions ``<= pos`` (``mask``)."""
    b = x.shape[0]
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = _qkv(p, x, cfg)
    q = _rotate_partial(q.reshape(b, 1, h, dh), tables, cfg.rope_fraction)
    kk = _rotate_partial(kk.reshape(b, 1, kh, dh), tables, cfg.rope_fraction)
    k_cache[:, pos] = kk[:, 0]
    v_cache[:, pos] = v.reshape(b, kh, dh)
    return decode_attn(q, k_cache, v_cache, mask, cfg) @ p["w_o"]


def decode_layers(params: Params, x: torch.Tensor, cfg: TransformerConfig,
                  attn_fn: Callable[[int, Params, torch.Tensor],
                                    torch.Tensor]) -> torch.Tensor:
    """The decode stack shared with the paged step: x [B, 1, D] through
    every layer with ``attn_fn(layer_index, attn_params, normed_x)``, then
    the final norm and the unembedding -> logits [B, V]."""
    for li, layer in enumerate(params["layers"]):
        x = x + attn_fn(li, layer["attn"], rms_norm(x, layer["ln1"]))
        hn2 = rms_norm(x, layer["ln2"])
        x = x + swiglu(hn2, layer["ffn"]["w_gate"], layer["ffn"]["w_up"],
                       layer["ffn"]["w_down"])
    x = rms_norm(x, params["ln_f"])
    return x[:, 0] @ params["unembed"]


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos: int, cfg: TransformerConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens [B, 1] int; ``pos`` the current length (one
    for the whole batch). Returns (logits [B, V], the cache, updated in
    place)."""
    _dense_only(cfg)
    pos = int(pos)
    max_seq = cache["k"].shape[2]
    dev = tokens.device
    angles = rope_freqs(cfg.head_dim, max_seq, cfg.rope_theta, device=dev)
    tables = _rope_tables(angles[pos:pos + 1], cfg)
    mask = (torch.arange(max_seq, device=dev) <= pos)[None, None, None, :]
    x = params["embed"][tokens.long()]
    logits = decode_layers(
        params, x, cfg,
        lambda li, p, hn: _decode_attn_gqa(p, hn, cache["k"][li],
                                           cache["v"][li], pos, cfg, tables,
                                           mask))
    return logits, cache
