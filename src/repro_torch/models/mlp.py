"""Dense MLP block: twin of ``mlp_init`` / ``mlp_apply`` in
``repro/models/gnn.py`` (:class:`MLP` and the functional
:func:`mlp_apply`).

Weights are kept as the reference lays them out, ``w[i]`` of shape
``[d_in, d_out]`` applied as ``x @ w + b`` (not ``nn.Linear``'s transposed
layout), so reference parameters load as they are. ReLU between layers,
none after the last; an optional final LayerNorm without bias (eps 1e-6).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device


class MLP(nn.Module):
    def __init__(self, dims: Sequence[int], *, layer_norm: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, dtype=torch.float32):
        """Dense layers drawn normal x ``1/sqrt(d_in)`` from ``generator``
        (``repro/models/common.py:dense_init``), biases 0, LayerNorm scale
        1. ``device=None`` means CUDA."""
        super().__init__()
        dev = resolve_device(device)
        self.w = nn.ParameterList([
            nn.Parameter(torch.randn(a, b, generator=generator, device=dev,
                                     dtype=dtype) * (1.0 / math.sqrt(a)))
            for a, b in zip(dims[:-1], dims[1:])])
        self.b = nn.ParameterList([
            nn.Parameter(torch.zeros(b, device=dev, dtype=dtype))
            for b in dims[1:]])
        self.register_parameter(
            "ln", nn.Parameter(torch.ones(dims[-1], device=dev, dtype=dtype))
            if layer_norm else None)

    def params(self) -> Dict[str, Any]:
        """The weights as the reference's ``{"w": [...], "b": [...],
        "ln"?}`` dict (the module's own tensors, not copies)."""
        p = {"w": list(self.w), "b": list(self.b)}
        if self.ln is not None:
            p["ln"] = self.ln
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.params(), x)


def mlp_apply(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` per layer, ReLU between layers, the optional final
    LayerNorm: the MLP over a ``{"w", "b", "ln"?}`` dict, differentiable."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    if p.get("ln") is not None:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + 1e-6) * p["ln"]
    return x
