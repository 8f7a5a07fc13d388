"""LM-family transformers: dense GQA (qwen2, chatglm3) and MoE + MLA
(deepseek-v2). Twin of ``repro/models/transformer.py``.

Ported: ``TransformerConfig`` (with ``n_params`` / ``n_active_params``),
``init``, ``_partial_rope``, ``gqa_attention``, ``mla_attention``,
``MoEStats`` and ``moe_ffn`` (the local and expert-parallel paths),
``_layer_fwd``, ``forward``, ``loss_fn``, ``prefill``, ``init_cache``,
``_decode_attn_gqa``, ``_decode_attn_mla`` (the absorbed decode over the
rank-compressed ``{c_kv, k_rope}`` cache) and ``decode_step``. Every
layer's attention runs the hand-written ``flash_attention`` CUDA kernel on
CUDA tensors (``kernels.ops.flash_attention``; the reference runs the
pure-JAX ``_flash`` there, the same function) and its plain chunked
version on CPU tensors; MLA calls it with a query/key head dim of
``qk_nope_head_dim + qk_rope_head_dim`` (192 at DeepSeek-V2) and a value
head dim of ``v_head_dim`` (128).

MoE dispatch is the reference's sort-based capacity dispatch: a stable
sort of the flat expert ids, the within-expert position, pairs beyond the
capacity sent to a dump row, the expert SwiGLU as batched products over
``[E, cap, D]``. The combine scatters the ``T·k`` weighted rows back to
``[T, k, D]`` through the inverse permutation and sums over ``k`` in
float32, rounded once to x's dtype: no atomics, so two calls on the card
are bitwise equal (the reference's ``segment_sum`` rounds after each add
in bf16). With ``ep_shard_map`` on a DTensor whose mesh has a ``model``
axis dividing the experts, ``moe_ffn`` takes the twin of the reference's
``_moe_routed_shardmap`` (``_moe_expert_parallel``, under ``local_map``);
elsewhere (one card, no such axis) it falls through to the local path, as
the reference does.

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
orientation (``x @ w``), with the reference's per-layer stacks
(``dense_layers``, then ``moe_layers``) unrolled into ``params["layers"]``,
a list of one dict per layer (``interop.transformer_params_from`` carries
the reference's across). :func:`param_specs` / :func:`cache_specs` are the
reference's spec trees in that layout, and the functions take the
reference's ``rules`` (``dist.sharding.Rules``) with its constraint sites
(``rules.shard``): the attention output, the embedding, the logits and
the MoE buffers. Their default, ``sharding.NO_MESH``, resolves every name
to nothing, and ``rules.shard`` returns a plain tensor itself, so only a
DTensor trace on a mesh (``launch/placement.py``) sees them act.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.dist.sharding import (NO_MESH, Rules, Spec, _is_dtensor,
                                       dense, embed_rows, merge_dims,
                                       merge_last, placed_like, split_dim,
                                       split_last, whole_local)
from repro_torch.kernels import ops
from repro_torch.models.common import (cross_entropy, rms_norm, rope_freqs,
                                      rope_tables, rotate, swiglu)

Params = Dict[str, Any]
Attend = Callable[..., torch.Tensor]


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



    def moe_layer(self, li: int) -> bool:
        """Whether layer ``li`` has a MoE FFN: all but the first
        ``n_dense_layers`` when ``moe`` is set."""
        return self.moe and li >= self.n_dense_layers

    @property
    def rope_dim(self) -> int:
        """The head dim RoPE's angles are made for: MLA's rope part, else
        the head (the reference's ``forward``)."""
        return self.qk_rope_head_dim if self.mla else self.head_dim


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


def _attn_init(gen, cfg: TransformerConfig, dev) -> Params:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    if cfg.mla:
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            p = {"w_dq": dense_init(gen, d, cfg.q_lora_rank, dt, dev),
                 "q_norm": torch.ones(cfg.q_lora_rank, dtype=dt, device=dev),
                 "w_uq": dense_init(gen, cfg.q_lora_rank, h * (dn + dr), dt,
                                    dev)}
        else:
            p = {"w_q": dense_init(gen, d, h * (dn + dr), dt, dev)}
        p.update(w_dkv=dense_init(gen, d, r, dt, dev),
                 kv_norm=torch.ones(r, dtype=dt, device=dev),
                 w_kr=dense_init(gen, d, dr, dt, dev),
                 w_uk=dense_init(gen, r, h * dn, dt, dev),
                 w_uv=dense_init(gen, r, h * dv, dt, dev),
                 w_o=dense_init(gen, h * dv, d, dt, dev))
        return p
    p = {"w_q": dense_init(gen, d, h * dh, dt, dev),
         "w_k": dense_init(gen, d, kh * dh, dt, dev),
         "w_v": dense_init(gen, d, kh * dh, dt, dev),
         "w_o": dense_init(gen, h * dh, d, dt, dev)}
    if cfg.qkv_bias:
        p.update(b_q=torch.zeros(h * dh, dtype=dt, device=dev),
                 b_k=torch.zeros(kh * dh, dtype=dt, device=dev),
                 b_v=torch.zeros(kh * dh, dtype=dt, device=dev))
    return p


def _ffn_init(gen, cfg: TransformerConfig, dev, moe_layer: bool) -> Params:
    d, dt = cfg.d_model, cfg.dtype
    if not moe_layer:
        f = cfg.d_ff
        return {"w_gate": dense_init(gen, d, f, dt, dev),
                "w_up": dense_init(gen, d, f, dt, dev),
                "w_down": dense_init(gen, f, d, dt, dev)}
    e, f = cfg.n_experts, cfg.d_ff_expert

    def experts(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=gen, device=dev)
        return (w / float(np.sqrt(d_in))).to(dt)
    p = {"router": dense_init(gen, d, e, torch.float32, dev),
         "w_gate": experts(d, f), "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p.update(ws_gate=dense_init(gen, d, fs, dt, dev),
                 ws_up=dense_init(gen, d, fs, dt, dev),
                 ws_down=dense_init(gen, fs, d, dt, dev))
    return p


def _layer_init(gen, cfg: TransformerConfig, dev, moe_layer: bool) -> Params:
    d, dt = cfg.d_model, cfg.dtype
    return {"attn": _attn_init(gen, cfg, dev),
            "ffn": _ffn_init(gen, cfg, dev, moe_layer),
            "ln1": torch.ones(d, dtype=dt, device=dev),
            "ln2": torch.ones(d, dtype=dt, device=dev)}


def init(cfg: TransformerConfig, generator: torch.Generator,
         device: DeviceLike = None) -> Params:
    """Random weights at the reference's shapes and scales
    (``transformer.py:init``): normal ``embed`` (scale 1), ``unembed`` and
    every projection at ``1/sqrt(d_in)`` (MLA's too), zero QKV biases, unit
    norms; MoE layers (all but the first ``n_dense_layers``) a float32
    ``router [D, E]``, experts ``w_gate`` / ``w_up [E, D, F]`` at
    ``1/sqrt(D)`` and ``w_down [E, F, D]`` at ``1/sqrt(F)``, and the
    shared experts' ``ws_*`` at ``n_shared·F``. ``generator`` lives on
    ``device`` (``None`` = CUDA). The numbers differ from the reference's
    (``jax.random`` cannot be replayed); tests carry the reference's
    weights across with ``interop.transformer_params_from``.
    """
    dev = resolve_device(device)
    dt = cfg.dtype
    return {"embed": dense_init(generator, cfg.vocab, cfg.d_model, dt, dev,
                                scale=1.0),
            "unembed": dense_init(generator, cfg.d_model, cfg.vocab, dt, dev),
            "ln_f": torch.ones(cfg.d_model, dtype=dt, device=dev),
            "layers": [_layer_init(generator, cfg, dev, cfg.moe_layer(li))
                       for li in range(cfg.n_layers)]}


def _attn_specs(cfg: TransformerConfig, rules: Rules) -> Dict[str, Spec]:
    """The reference's ``_attn_init`` specs."""
    if cfg.mla:
        s = ({"w_dq": rules.spec("fsdp", "model"), "q_norm": rules.spec(None),
              "w_uq": rules.spec("fsdp", "model")} if cfg.q_lora_rank
             else {"w_q": rules.spec("fsdp", "model")})
        s.update(w_dkv=rules.spec("fsdp", None), kv_norm=rules.spec(None),
                 w_kr=rules.spec("fsdp", None),
                 w_uk=rules.spec(None, "model"),
                 w_uv=rules.spec(None, "model"),
                 w_o=rules.spec("model", "fsdp"))
        return s
    s = {"w_q": rules.spec("fsdp", "model"), "w_k": rules.spec("fsdp", "model"),
         "w_v": rules.spec("fsdp", "model"), "w_o": rules.spec("model", "fsdp")}
    if cfg.qkv_bias:
        s.update(b_q=rules.spec("model"), b_k=rules.spec("model"),
                 b_v=rules.spec("model"))
    return s


def _ffn_specs(cfg: TransformerConfig, rules: Rules,
               moe_layer: bool) -> Dict[str, Spec]:
    """The reference's ``_ffn_init`` specs."""
    if not moe_layer:
        return {"w_gate": rules.spec("fsdp", "model"),
                "w_up": rules.spec("fsdp", "model"),
                "w_down": rules.spec("model", "fsdp")}
    s = {"router": rules.spec("fsdp", None),
         "w_gate": rules.spec("expert", None, "fsdp"),
         "w_up": rules.spec("expert", None, "fsdp"),
         "w_down": rules.spec("expert", "fsdp", None)}
    if cfg.n_shared:
        s.update(ws_gate=rules.spec("fsdp", "model"),
                 ws_up=rules.spec("fsdp", "model"),
                 ws_down=rules.spec("model", "fsdp"))
    return s


def param_specs(cfg: TransformerConfig, rules: Rules) -> Params:
    """The spec tree of :func:`init`'s params, leaf for leaf: the
    reference's ``init`` specs with its per-layer stacks unrolled (a
    stacked leaf's ``Spec(None, *s)`` is layer ``li``'s ``Spec(*s)``)."""
    return {"embed": rules.spec("vocab", "fsdp"),
            "unembed": rules.spec("fsdp", "vocab"),
            "ln_f": rules.spec(None),
            "layers": [{"attn": _attn_specs(cfg, rules),
                        "ffn": _ffn_specs(cfg, rules, cfg.moe_layer(li)),
                        "ln1": rules.spec(None), "ln2": rules.spec(None)}
                       for li in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# MoE dispatch (sort-based, fixed capacity)
# ---------------------------------------------------------------------------

class MoEStats(NamedTuple):
    aux_loss: torch.Tensor
    dropped_frac: torch.Tensor


def capacity(cfg: TransformerConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``ceil(cf·t·k/E)`` rounded up to
    a multiple of 8, at least 8."""
    cap = int(np.ceil(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
    return max(8, ((cap + 7) // 8) * 8)


def route(p: Params, x: torch.Tensor, cfg: TransformerConfig):
    """x [T, D] -> (probs [T, E], top_p [T, k], top_i [T, k]): float32
    router logits, softmax, top-k, renormalised with a floor of 1e-9."""
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def dispatch(top_i: torch.Tensor, n_experts: int, cap: int):
    """The token-expert pairs sorted by expert: ``(order, sorted_e, starts,
    pos, valid, slot)``. ``order`` is a stable sort of the flat ids (the
    reference's ``jnp.argsort`` is stable, and which pairs drop depends on
    it), ``starts[e]`` the first pair of expert ``e``, ``pos`` a pair's
    place within its expert, ``valid = pos < cap``, ``slot`` its row of
    the ``[E·cap]`` buffer or the dump row ``E·cap`` when dropped."""
    flat_e = top_i.reshape(-1).long()
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=top_i.device))
    pos = torch.arange(flat_e.numel(), device=top_i.device) - starts[sorted_e]
    valid = pos < cap
    slot = torch.where(valid, sorted_e * cap + pos, n_experts * cap)
    return order, sorted_e, starts, pos, valid, slot


def combine(weighted: torch.Tensor, order: torch.Tensor, t: int,
            k: int) -> torch.Tensor:
    """The routed output: the ``T·k`` weighted expert rows (in sorted
    order) scattered back to ``[T, k, D]`` through the inverse permutation
    and summed over k in float32, rounded once to their dtype."""
    rows = torch.empty_like(weighted)
    rows[order] = weighted
    return rows.view(t, k, -1).to(torch.float32).sum(dim=1).to(
        weighted.dtype)


def _routed(p: Params, x: torch.Tensor, cfg: TransformerConfig,
            experts: Callable[[torch.Tensor], torch.Tensor],
            e_off: int = 0, e_l: Optional[int] = None):
    """The routed experts over the tokens x [T, D]: ``(y [T, D], aux,
    dropped share)``. Pairs sorted by expert id, the within-expert
    position ``arange - start(expert)``, pairs beyond the capacity
    dropped; of the experts only ``[e_off, e_off + e_l)`` (default all)
    are dispatched, into a ``[e_l, cap, D]`` buffer that ``experts`` maps
    to their outputs; the other pairs contribute zero (the expert-parallel
    body's share). The Switch aux loss ``E·sum(me·ce)·coef`` counts every
    pair."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_l = e if e_l is None else e_l
    cap = capacity(cfg, t)
    probs, top_p, top_i = route(p, x, cfg)
    order, sorted_e, starts, pos, valid, slot = dispatch(top_i, e, cap)
    tok_of = order // k
    dropped = 1.0 - valid.to(torch.float32).mean()
    if e_l != e:
        valid = valid & (sorted_e >= e_off) & (sorted_e < e_off + e_l)
        slot = torch.where(valid, (sorted_e - e_off) * cap + pos, e_l * cap)

    buf = x.new_zeros((e_l * cap + 1, d))
    buf[slot] = x[tok_of]
    out = experts(buf[: e_l * cap].view(e_l, cap, d)).view(e_l * cap, d)
    gathered = torch.where(valid[:, None],
                           out[torch.clamp_max(slot, e_l * cap - 1)], 0.0)
    weight = top_p.reshape(-1)[order].to(x.dtype)
    y = combine(gathered * weight[:, None], order, t, k)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e; the pair counts
    # per expert from the sorted ids' starts (no atomics)
    me = probs.mean(dim=0)
    counts = torch.diff(starts, append=starts.new_full((1,), t * k))
    ce = counts.to(torch.float32) / (t * k)
    aux = e * torch.sum(me * ce) * cfg.aux_loss_coef
    return y, aux, dropped


def _expert_swiglu(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU as batched products: buf [E, cap, D] ->
    [E, cap, D]."""
    h = torch.nn.functional.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _ep_mesh(x: torch.Tensor, cfg: TransformerConfig):
    """The mesh of the expert-parallel route, or None: ``cfg.ep_shard_map``
    set, x a DTensor whose mesh has a ``model`` axis dividing the experts
    (the reference's condition on its ambient mesh)."""
    if not cfg.ep_shard_map or not _is_dtensor(x):
        return None
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names or cfg.n_experts % mesh.size(
            names.index("model")):
        return None
    return mesh


def moe_ffn(p: Params, x: torch.Tensor, cfg: TransformerConfig,
            rules: Rules = NO_MESH) -> Tuple[torch.Tensor, MoEStats]:
    """Routed top-k experts + shared experts. x: [T, D] -> [T, D].

    The reference's local path (:func:`_routed`): the experts as batched
    products over ``[E, cap, D]`` in x's dtype, the buffer and their
    outputs constrained to the ``expert`` axis. On a DTensor the routing,
    the sort and the scatters run on the whole token set, replicated, as
    GSPMD partitions none of them and replicates the dispatch buffers
    (:func:`sharding.whole_local`); only the expert products stay sharded.
    With ``cfg.ep_shard_map`` on a mesh with a ``model`` axis dividing the
    experts it takes the expert-parallel route instead
    (:func:`_moe_expert_parallel`)."""
    mesh = _ep_mesh(x, cfg)
    if mesh is not None:
        y, stats = _moe_expert_parallel(p, x, cfg, mesh)
        y = placed_like(y, x)
    else:
        xw, wrap = whole_local(x)
        router, _ = whole_local(p["router"])

        def experts(buf):
            out = _expert_swiglu(rules.shard(wrap(buf), "expert", None, None),
                                 p["w_gate"], p["w_up"], p["w_down"])
            return whole_local(rules.shard(out, "expert", None, None))[0]
        y, aux, dropped = _routed(dict(p, router=router), xw, cfg, experts)
        y = placed_like(wrap(y), x)
        stats = MoEStats(aux_loss=wrap(aux), dropped_frac=wrap(dropped))
    if cfg.n_shared:
        y = y + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return y, stats


class _SumOver(torch.autograd.Function):
    """``psum`` over one process group, its gradient summed over it again
    (the reference's ``psum`` transpose under ``check_rep=False``)."""

    @staticmethod
    def forward(ctx, y, group):
        from torch.distributed import _functional_collectives as fc
        ctx.group = group
        return fc.wait_tensor(fc.all_reduce(y, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as fc
        return fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                            ctx.group)), None


def _moe_expert_parallel(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                         mesh) -> Tuple[torch.Tensor, MoEStats]:
    """Twin of the reference's ``_moe_routed_shardmap``: the routed experts
    expert-parallel under ``local_map`` over the reference's in/out specs.
    Tokens stay on their data shard (replicated over ``model``), so the
    dispatch moves nothing: each ``model`` rank routes its shard's tokens,
    dispatches only the pairs of its own ``E / |model|`` experts, all-gathers
    their FFN weights over ``data`` (explicit FSDP; the gradient is
    reduce-scattered back) and one all-reduce of y over ``model`` sums the
    top-k partial outputs. The collectives are functional ops, dispatched
    (not DTensor redistributions), so the trace's recorder sees them. Its
    capacity is the local shard's, ``ceil8(ceil(cf·t_l·k/E))``."""
    from torch.distributed import _functional_collectives as fc
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    ep = names.index("model")
    fsdp = names.index("data") if "data" in names else None
    e_l = cfg.n_experts // mesh.size(ep)

    def pl(on: Dict[int, int]):
        return tuple(Shard(on[i]) if i in on else Replicate()
                     for i in range(mesh.ndim))
    batch = pl({i: 0 for i in dp})
    rep = pl({})
    w_in = pl({ep: 0, **({} if fsdp is None else {fsdp: 2})})
    w_down = pl({ep: 0, **({} if fsdp is None else {fsdp: 1})})

    def body(x_l, router, wg, wu, wd):
        if fsdp is not None:
            group = (mesh, fsdp)
            wg = fc.all_gather_tensor_autograd(wg, 2, group)
            wu = fc.all_gather_tensor_autograd(wu, 2, group)
            wd = fc.all_gather_tensor_autograd(wd, 1, group)
        y, aux, dropped = _routed(
            {"router": router}, x_l, cfg,
            lambda buf: _expert_swiglu(buf, wg, wu, wd),
            e_off=mesh.get_local_rank(ep) * e_l, e_l=e_l)
        y = _SumOver.apply(y, mesh.get_group(ep))
        return y, aux[None], dropped[None]

    ins = [(x, batch), (p["router"], rep), (p["w_gate"], w_in),
           (p["w_up"], w_in), (p["w_down"], w_down)]
    args = [t.redistribute(mesh, want) if tuple(t.placements) != want else t
            for t, want in ins]
    y, aux, dropped = local_map(
        body, out_placements=(batch, batch, batch),
        in_placements=tuple(want for _, want in ins),
        device_mesh=mesh)(*args)
    return y, MoEStats(aux_loss=aux.mean(), dropped_frac=dropped.mean())


def ffn(p: Params, x: torch.Tensor, cfg: TransformerConfig,
        moe_layer: bool, rules: Rules = NO_MESH
        ) -> Tuple[torch.Tensor, Optional[MoEStats]]:
    """A layer's FFN on x [..., D]: ``moe_ffn`` over the flattened tokens
    for a MoE layer (with its stats), else the dense SwiGLU (stats None)."""
    if moe_layer:
        tokens = x
        while tokens.dim() > 2:
            tokens = merge_dims(tokens, 0)
        y, stats = moe_ffn(p, tokens, cfg, rules)
        if x.dim() == 3:
            return split_dim(y, 0, *x.shape[:2]), stats
        return y.reshape(x.shape), stats
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), None


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _rotary_dim(d: int, frac: float) -> int:
    """Rotated share of the head dim (chatglm3 rotates half of it)."""
    return d if frac >= 1.0 else int(d * frac) // 2 * 2


def _rope_tables(angles: torch.Tensor, cfg: TransformerConfig):
    """(cos, sin) tables of the rotated share, made once per forward or
    decode step and shared by every layer."""
    dr = _rotary_dim(cfg.rope_dim, cfg.rope_fraction)
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
    q = dense(x, p["w_q"])
    kk = dense(x, p["w_k"])
    v = dense(x, p["w_v"])
    if cfg.qkv_bias:
        q, kk, v = q + p["b_q"], kk + p["b_k"], v + p["b_v"]
    return q, kk, v


def gqa_attention(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                  tables, attend: Attend = ops.flash_attention,
                  rules: Rules = NO_MESH) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] with the forward's RoPE ``tables``;
    ``attend`` is the attention forward (``ops.flash_attention``: the
    kernel on CUDA tensors)."""
    b, sq, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = _qkv(p, x, cfg)
    q = _rotate_partial(split_last(q, h, dh), tables, cfg.rope_fraction)
    kk = _rotate_partial(split_last(kk, kh, dh), tables, cfg.rope_fraction)
    v = split_last(v, kh, dh)
    o = attend(q.contiguous(), kk.contiguous(), v.contiguous(), causal=True,
               q_chunk=cfg.q_chunk or sq, kv_chunk=cfg.kv_chunk or sq)
    return rules.shard(dense(merge_last(o), p["w_o"]), "batch", "seq", None)


def _mla_q(p: Params, x: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    """MLA's query projection: ``w_q``, or ``rms_norm(x @ w_dq, q_norm) @
    w_uq`` with a ``q_lora_rank``."""
    if cfg.q_lora_rank:
        return dense(rms_norm(dense(x, p["w_dq"]), p["q_norm"]), p["w_uq"])
    return dense(x, p["w_q"])


def mla_attention(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                  tables, attend: Attend = ops.flash_attention,
                  rules: Rules = NO_MESH) -> torch.Tensor:
    """Training/prefill MLA: per-head K and V materialised from ``c_kv``,
    attention over the concatenated ``[nope | rope]`` dims (D = dn + dr,
    Dv = dv). x [B, S, D] -> [B, S, D]; decode runs the absorbed path
    instead."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = split_last(_mla_q(p, x, cfg), h, dn + dr)
    q_rope = rotate(q[..., dn:], *tables)
    c_kv = rms_norm(dense(x, p["w_dkv"]), p["kv_norm"])    # [B, S, r]
    k_rope = rotate(dense(x, p["w_kr"])[:, :, None, :],
                    *tables)                               # [B, S, 1, dr]
    k_nope = split_last(dense(c_kv, p["w_uk"]), h, dn)
    v = split_last(dense(c_kv, p["w_uv"]), h, dv)
    q_cat = torch.cat([q[..., :dn], q_rope], dim=-1)
    # the shared rope key placed like k_nope before the concatenation: left
    # to DTensor, torch 2.13 plans the cat through a shard-to-partial move
    # it cannot run once the sequence passes 32 tokens
    k_cat = torch.cat([k_nope, placed_like(k_rope.expand(b, s, h, dr),
                                           k_nope)], dim=-1)
    o = attend(q_cat, k_cat, v.contiguous(), causal=True,
               q_chunk=cfg.q_chunk or s, kv_chunk=cfg.kv_chunk or s)
    return rules.shard(dense(merge_last(o), p["w_o"]), "batch", "seq", None)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer_fwd(p: Params, x: torch.Tensor, cfg: TransformerConfig,
               tables, attend: Attend, moe_layer: bool,
               rules: Rules = NO_MESH):
    """One layer: (x [B, S, D], its aux loss: a float32 scalar, 0 for a
    dense FFN)."""
    attn = mla_attention if cfg.mla else gqa_attention
    x = x + attn(p["attn"], rms_norm(x, p["ln1"]), cfg, tables, attend,
                 rules)
    y, stats = ffn(p["ffn"], rms_norm(x, p["ln2"]), cfg, moe_layer, rules)
    aux = (stats.aux_loss if stats is not None
           else torch.zeros((), device=x.device))
    return x + y, aux


def forward_core(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig, attend: Attend = ops.flash_attention,
                 rules: Rules = NO_MESH
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss: the float32 sum of
    the MoE layers', 0 for dense), differentiable, with the attention
    ``attend`` in every layer. Where autograd records and ``cfg.remat`` is
    set, each layer is a non-reentrant ``torch.utils.checkpoint``: its
    forward runs again in the backward (see the module docstring for the
    launches)."""
    _, s = tokens.shape
    tables = _rope_tables(rope_freqs(cfg.rope_dim, s, cfg.rope_theta,
                                     device=tokens.device), cfg)
    x = rules.shard(embed_rows(params["embed"], tokens.long()), "batch",
                    "seq", None)
    aux_total = torch.zeros((), device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for li, layer in enumerate(params["layers"]):
        if remat:
            x, aux = checkpoint(_layer_fwd, layer, x, cfg, tables, attend,
                                cfg.moe_layer(li), rules, use_reentrant=False)
        else:
            x, aux = _layer_fwd(layer, x, cfg, tables, attend,
                                cfg.moe_layer(li), rules)
        aux_total = aux_total + aux
    x = rms_norm(x, params["ln_f"])
    return (rules.shard(dense(x, params["unembed"]), "batch", None, "vocab"),
            aux_total)


@torch.no_grad()
def forward_with(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig, attend: Attend,
                 rules: Rules = NO_MESH
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward` with the attention forward ``attend`` in every layer
    (the checks hold the kernel against its plain version through it)."""
    return forward_core(params, tokens, cfg, attend, rules)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            rules: Rules = NO_MESH) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux_loss scalar: 0 for dense)."""
    return forward_with(params, tokens, cfg, ops.flash_attention, rules)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, attend: Attend = ops.flash_attention,
            rules: Rules = NO_MESH
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + aux, {"ce", "aux"})`` over ``batch["tokens"]`` /
    ``["labels"]`` (and an optional ``["mask"]``): the reference's
    ``loss_fn``, differentiable through :func:`forward_core`."""
    logits, aux = forward_core(params, batch["tokens"], cfg, attend, rules)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            rules: Rules = NO_MESH) -> torch.Tensor:
    """Prefill forward — logits for every position."""
    logits, _ = forward(params, tokens, cfg, rules)
    return logits


# ---------------------------------------------------------------------------
# Decode (KV cache, one token)
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Params:
    """Zero caches: MLA's rank-compressed ``{"c_kv" [n_layers, batch,
    max_seq, kv_lora_rank], "k_rope" [.., qk_rope_head_dim]}``, else
    ``{"k", "v"}`` of ``[n_layers, batch, max_seq, kh, dh]``."""
    dev = resolve_device(device)
    n = cfg.n_layers
    if cfg.mla:
        return {"c_kv": torch.zeros((n, batch, max_seq, cfg.kv_lora_rank),
                                    dtype=cfg.dtype, device=dev),
                "k_rope": torch.zeros((n, batch, max_seq,
                                       cfg.qk_rope_head_dim),
                                      dtype=cfg.dtype, device=dev)}
    shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def cache_specs(cfg: TransformerConfig, rules: Rules) -> Params:
    """The spec tree of :func:`init_cache`'s cache (the reference's
    ``init_cache`` specs): the sequence axis over ``kv_seq``, so at 32k
    context the cache, not the weights, scales with the devices."""
    if cfg.mla:
        s = rules.spec(None, "batch", "kv_seq", None)
        return {"c_kv": s, "k_rope": s}
    s = rules.spec(None, "batch", "kv_seq", None, None)
    return {"k": s, "v": s}


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, mask: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """One query token over a gathered cache: q [B, 1, H, dh], caches
    [B, max_s, kh, dh], mask [B or 1, 1, 1, max_s] -> [B, 1, H*dh]. The
    reference's masked softmax (``_decode_attn_gqa``): scores and the
    exponentials' sum in f32, the exponentials rounded to the cache's type
    for the value product, which is summed in f32. Written as two batched
    products over (batch, KV head) so a step launches few kernels."""
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f32 = torch.float32
    qh = split_dim(q[:, 0], 1, kh, h // kh).to(f32)
    s = qh @ k_cache.to(f32).permute(0, 2, 3, 1) / float(np.sqrt(dh))
    s = torch.where(mask, s, -torch.inf)                  # [B, kh, g, max_s]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    num = e.to(v_cache.dtype).to(f32) @ v_cache.to(f32).transpose(1, 2)
    o = (num / e.sum(dim=-1, keepdim=True)).to(q.dtype)   # [B, kh, g, dh]
    return merge_dims(merge_dims(o, 1), 1)[:, None]


def _decode_attn_gqa(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int,
                     cfg: TransformerConfig, tables,
                     mask: torch.Tensor) -> torch.Tensor:
    """x [B, 1, D]; writes this token's K/V at ``pos`` of the layer's
    caches [B, max_s, kh, dh] in place (the reference returns updated
    copies) and attends over positions ``<= pos`` (``mask`` [max_s])."""
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kk, v = _qkv(p, x, cfg)
    q = _rotate_partial(split_last(q, h, dh), tables, cfg.rope_fraction)
    kk = _rotate_partial(split_last(kk, kh, dh), tables, cfg.rope_fraction)
    k_cache[:, pos] = kk[:, 0]
    v_cache[:, pos] = split_last(v, kh, dh)[:, 0]
    return decode_attn(q, k_cache, v_cache, mask[None, None, None, :],
                       cfg) @ p["w_o"]


def _decode_attn_mla(p: Params, x: torch.Tensor, c_cache: torch.Tensor,
                     kr_cache: torch.Tensor, pos: int,
                     cfg: TransformerConfig, tables,
                     mask: torch.Tensor) -> torch.Tensor:
    """Absorbed MLA decode: scores and values live in the kv_lora_rank
    basis. x [B, 1, D]; writes this token's ``c_kv`` and rotated
    ``k_rope`` at ``pos`` of the layer's caches [B, max_s, r] / [B, max_s,
    dr] in place and attends over positions ``<= pos`` (``mask``
    [max_s]). The reference's roundings: the products of the working type
    (q_eff, the value projection) in that type, the scores and the
    context in float32, P rounded to the cache's type, the context to x's
    before ``w_uv``."""
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    f32 = torch.float32
    q = split_last(_mla_q(p, x, cfg), h, dn + dr)[:, 0]    # [B, h, dn + dr]
    q_rope = rotate(q[:, None, :, dn:], *tables)[:, 0]      # [B, h, dr]
    # absorb W_uk: q_eff[b, h, r] so scores dot against c_kv directly
    q_eff = torch.einsum("bhn,rhn->bhr", q[..., :dn],
                         split_last(p["w_uk"], h, dn))
    c_cache[:, pos] = rms_norm(x @ p["w_dkv"], p["kv_norm"])[:, 0]
    kr_cache[:, pos] = rotate((x @ p["w_kr"])[:, :, None, :],
                              *tables)[:, 0, 0]
    s = (q_eff.to(f32) @ c_cache.to(f32).transpose(1, 2)
         + q_rope.to(f32) @ kr_cache.to(f32).transpose(1, 2)) \
        * (1.0 / np.sqrt(dn + dr))
    s = torch.where(mask[None, None, :], s, -torch.inf)      # [B, h, max_s]
    pr = torch.softmax(s, dim=-1)
    ctx = pr.to(c_cache.dtype).to(f32) @ c_cache.to(f32)     # [B, h, r]
    o = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype),
                     split_last(p["w_uv"], h, dv))
    return merge_last(o)[:, None] @ p["w_o"]


def decode_layers(params: Params, x: torch.Tensor, cfg: TransformerConfig,
                  attn_fn: Callable[[int, Params, torch.Tensor],
                                    torch.Tensor],
                  rules: Rules = NO_MESH) -> torch.Tensor:
    """The decode stack shared with the paged step: x [B, 1, D] through
    every layer with ``attn_fn(layer_index, attn_params, normed_x)`` and
    the layer's FFN (``moe_ffn`` over the B tokens of a MoE layer), then
    the final norm and the unembedding -> logits [B, V]."""
    for li, layer in enumerate(params["layers"]):
        x = x + attn_fn(li, layer["attn"], rms_norm(x, layer["ln1"]))
        x = x + ffn(layer["ffn"], rms_norm(x, layer["ln2"]), cfg,
                    cfg.moe_layer(li), rules)[0]
    x = rms_norm(x, params["ln_f"])
    return rules.shard(x[:, 0] @ params["unembed"], "batch", "vocab")


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                pos: int, cfg: TransformerConfig, rules: Rules = NO_MESH
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens [B, 1] int; ``pos`` the current length (one
    for the whole batch). Returns (logits [B, V], the cache, updated in
    place)."""
    pos = int(pos)
    max_seq = (cache["c_kv"] if cfg.mla else cache["k"]).shape[2]
    dev = tokens.device
    angles = rope_freqs(cfg.rope_dim, max_seq, cfg.rope_theta, device=dev)
    tables = _rope_tables(angles[pos:pos + 1], cfg)
    mask = torch.arange(max_seq, device=dev) <= pos
    x = rules.shard(embed_rows(params["embed"], tokens.long()), "batch",
                    None, None)
    if cfg.mla:
        def attn(li, p, hn):
            return _decode_attn_mla(p, hn, cache["c_kv"][li],
                                    cache["k_rope"][li], pos, cfg, tables,
                                    mask)
    else:
        def attn(li, p, hn):
            return _decode_attn_gqa(p, hn, cache["k"][li], cache["v"][li],
                                    pos, cfg, tables, mask)
    return decode_layers(params, x, cfg, attn, rules), cache
