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
state mirrors the gradients, unrolled.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree

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


def _roundtrip_leaf(g: torch.Tensor, res: torch.Tensor,
                    block: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not g.is_floating_point():
        return g, res
    x = g.to(torch.float32) + res
    if block is None or x.numel() <= block:
        deq = _quantize(x.reshape(1, -1)).reshape(x.shape)
    else:
        n = x.numel()
        flat = torch.nn.functional.pad(x.reshape(-1), (0, (-n) % block))
        deq = _quantize(flat.reshape(-1, block)).reshape(-1)[:n]
        deq = deq.reshape(x.shape)
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
