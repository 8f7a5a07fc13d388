"""Int8 gradient compression with error feedback: twin of
``repro/dist/compress.py``.

``roundtrip`` quantizes each float leaf to int8, dequantizes it at once,
and carries the quantization error in a float32 residual that is added to
the next step's gradient (error feedback), so the quantization bias does
not accumulate. On one card nothing is all-reduced: the round trip is what
a data-parallel step would deliver. Scales: ``block=None`` is one scale
per tensor (``max|x| / 127``); ``block=2**k`` flattens the leaf (zero-padded
to a block multiple) and takes one scale per block of that many elements.
Integer and boolean leaves pass through with an all-zero residual.

The reference quantizes the layers' stacked leaves: one per-tensor scale
over a weight of every layer at once, and blocks of the flattened stack,
which can span a layer boundary. The port's layers are unrolled, so
``roundtrip`` quantizes the stacked view (``tree.stack_layers``) and hands
back the unrolled layout: the numbers equal the reference's. The residual
state mirrors the gradients, unrolled. A DTensor gradient (the placement
trace) is gathered as far as its flattening needs, as the reference's
compile gathers each sharded leaf (:func:`_dequantized_sharded`), and the
round trip's result goes back to its shards.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.dist.sharding import (_gather_dims, _is_dtensor,
                                       placed_like, whole_local)

LEVELS = 127  # symmetric int8: q in [-127, 127], -128 unused


def _zero_state(g: torch.Tensor) -> torch.Tensor:
    if g.is_floating_point():
        return torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    return torch.zeros_like(g)


def init_state(grads: Any) -> Any:
    """All-zero residual tree for ``roundtrip`` (float32 for float
    leaves)."""
    return tree.map_(_zero_state, grads)


def _check_block(block: Optional[int]) -> Optional[int]:
    if block is None:
        return None
    block = int(block)
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a positive power of two, "
                         f"got {block}")
    return block


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """Flat-scale int8 round trip of a [..., n] float32 array: one scale per
    leading index (the whole tensor when x is the raveled leaf, one block
    row when x is [n_blocks, block]). Both divisions are by tensors: a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    which can differ from the quotient in the last bit, and the card must
    give the CPU's (and the reference's) numbers exactly."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = (torch.clamp_min(amax, torch.finfo(torch.float32).tiny)
             / torch.full_like(amax, LEVELS))
    q = torch.clamp(torch.round(x / scale), -LEVELS, LEVELS).to(torch.int8)
    return q.to(torch.float32) * scale


def _dequantized(x: torch.Tensor, block: Optional[int]) -> torch.Tensor:
    """The int8 round trip of a float32 leaf: one scale for the whole leaf,
    or one for each block of ``block`` elements of the flattened leaf."""
    if block is None or x.numel() <= block:
        return _quantize(x.reshape(1, -1)).reshape(x.shape)
    n = x.numel()
    flat = torch.nn.functional.pad(x.reshape(-1), (0, (-n) % block))
    return _quantize(flat.reshape(-1, block)).reshape(-1)[:n].reshape(
        x.shape)


def _dequantized_sharded(x: torch.Tensor,
                         block: Optional[int]) -> torch.Tensor:
    """:func:`_dequantized` of a DTensor leaf, placed like it. The mesh
    dims that shard any dim but its first of more than one element are
    gathered, as the reference's compile gathers each sharded leaf until
    its flattening keeps a leading shard; the flat scale is the leaf's max
    over every shard (a scalar all-reduce); blocks are taken shard-local
    where every shard holds whole blocks, else the leaf is gathered whole.
    Going back to the leaf's shards is a local chunk."""
    import math

    from torch.distributed.tensor import DTensor, Shard
    first = next((d for d, n in enumerate(x.shape) if n > 1), 0)
    lead = _gather_dims(x, tuple(d for d in range(x.dim()) if d != first))
    if block is None or x.numel() <= block:
        amax = torch.amax(torch.abs(lead))
        scale = (torch.clamp_min(amax, torch.finfo(torch.float32).tiny)
                 / torch.full_like(amax, LEVELS))
        q = torch.clamp(torch.round(lead / scale), -LEVELS, LEVELS)
        return placed_like(q.to(torch.int8).to(torch.float32) * scale, x)
    mesh = x.device_mesh
    ways = math.prod(mesh.size(i) for i, p in enumerate(lead.placements)
                     if isinstance(p, Shard))
    if x.shape[first] % ways == 0 and (x.numel() // ways) % block == 0:
        deq = DTensor.from_local(_dequantized(lead.to_local(), block), mesh,
                                 lead.placements, run_check=False,
                                 shape=x.shape, stride=x.stride())
        return placed_like(deq, x)
    whole, wrap = whole_local(x)
    return placed_like(wrap(_dequantized(whole, block)), x)


def _roundtrip_leaf(g: torch.Tensor, res: torch.Tensor,
                    block: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not g.is_floating_point():
        return g, res
    x = g.to(torch.float32) + res
    deq = (_dequantized_sharded(x, block) if _is_dtensor(x)
           else _dequantized(x, block))
    emitted = deq.to(g.dtype)
    # the residual measures what was delivered after the cast: for bf16
    # gradients the cast error would otherwise accumulate as a bias
    return emitted, x - emitted.to(torch.float32)


def roundtrip(grads: Any, state: Optional[Any] = None,
              block: Optional[int] = None) -> Tuple[Any, Any]:
    """(grads, state) -> (dequantized grads, updated residual state), both
    shaped like ``grads``.

    ``state=None`` starts from a zero residual. ``block=None`` is one scale
    per tensor; ``block=2**k`` one scale per block of that many elements,
    both over the reference's stacked layer leaves. The per-element error
    is at most half a quantization step of the owning scale; the residual
    leaf holds exactly ``(g + res) - dequantized``.
    """
    block = _check_block(block)
    if state is None:
        state = init_state(grads)
    stacked = tree.stack_layers(grads)
    pairs = [_roundtrip_leaf(g, r, block) for g, r in zip(
        tree.leaves(stacked), tree.leaves(tree.stack_layers(state)))]
    out = [tree.unstack_layers(tree.unflatten(stacked, [p[i] for p in pairs]),
                               grads) for i in range(2)]
    return out[0], out[1]
