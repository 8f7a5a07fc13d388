"""Dense MLP block: twin of ``mlp_init`` / ``mlp_apply`` in
``repro/models/gnn.py``.

Weights are kept as the reference lays them out, ``w[i]`` of shape
``[d_in, d_out]`` applied as ``x @ w + b`` (not ``nn.Linear``'s transposed
layout), so reference parameters load as they are. ReLU between layers,
none after the last; an optional final LayerNorm without bias (eps 1e-6).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = torch.relu(x)
        if self.ln is not None:
            mu = x.mean(-1, keepdim=True)
            var = ((x - mu) ** 2).mean(-1, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + 1e-6) * self.ln
        return x
