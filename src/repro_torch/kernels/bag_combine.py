"""Weighted bag reduction over pre-gathered rows (``ops.embedding_bag``).

Replaces the Pallas kernel ``repro/kernels/bag_combine.py:bag_combine`` with
``csrc/bag_combine.cu``:

    out[b, f] = sum over slots d of w[b, d] * g[b, d, f]

The TPU kernel is a batched vec-mat on the matrix unit over (bag tile,
feature tile). At ~0.5 flop per byte it is a streaming reduction on
Hopper, bound by reading ``g`` once: one block row per bag, 16-byte loads
across F (one warp per block over 32 columns where the grid cannot fill
the card, as for one retrieve query), the slots summed in order in
registers with separately rounded products and sums
(``csrc/bag_reduce.cuh``, shared with ``gather_combine``, so
``embedding_bag`` and the fused lookup agree bitwise). Mean-combine is the
caller's ``w = 1 / bag_len``.

Rows and weights are float32, or both bf16 as the reference takes the
input's dtype (``repro/kernels/bag_combine.py``): the kernel widens bf16
rows and weights as it reads them, sums in float32 and rounds once to
bf16, as ``gather_combine``'s bf16 path does.

Where autograd records (the two-tower training loss), the call goes
through :class:`BagCombine`: the forward above, and a plain PyTorch
backward, ``d gathered = w[:, :, None] * g[:, None, :]`` and, when the
weights need one, ``d w = einsum("bdf,bf->bd")``. The reference has no
backward kernel either (its training differentiates the XLA path).

The launch comes from :func:`plan` (``kernels/plan.py``), with the path
rule of ``gather_combine.bag_plan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.gather_combine import DTYPES, bag_plan

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0


def plain(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path), as
    ``repro/kernels/ref.py:bag_combine_ref``; bf16 inputs are summed in
    float32 and the sum rounded once to bf16, as the kernel does."""
    if gathered.dtype == torch.bfloat16:
        return torch.einsum("bdf,bd->bf", gathered.float(),
                            weights.float()).to(torch.bfloat16)
    return torch.einsum("bdf,bd->bf", gathered, weights.to(gathered.dtype))


def order_tolerance(gathered: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """``[B, F]`` bound on the difference between two float32 sums of the
    same D products taken in different orders (the kernels' slot order,
    einsum's blocked one): ``2 * D * 2**-24 * sum_d |w[b, d] * g[b, d, f]|``.
    """
    d = gathered.shape[1]
    return (2.0 * d * 2.0 ** -24) * torch.einsum(
        "bdf,bd->bf", gathered.abs().double(), weights.abs().double())


def _vec(gathered: torch.Tensor) -> int:
    """Elements per 16-byte column where the rows are whole 16-byte columns
    on an aligned base (4 float32, 8 bf16), else 1. The output, a fresh
    ``torch.empty``, is always aligned."""
    per = 16 // DTYPES[gathered.dtype]
    return (per if gathered.shape[-1] % per == 0
            and gathered.data_ptr() % 16 == 0 else 1)


_plans = plan_lib.cache("bag_combine")


def plan(b: int, d: int, f: int, dtype: torch.dtype, vec: int,
         device=None) -> plan_lib.LaunchPlan:
    """The launch over ``b`` bags of ``d`` rows of ``f`` elements of
    ``dtype`` (``vec`` from :func:`_vec`) on ``device``'s card, cached by
    shape: the small grid where the row walk's grid cannot fill the card,
    else the row walk."""
    name = "float" if dtype == torch.float32 else "bf16"
    return _plans.get_or_build((b, d, f, dtype, vec, device), lambda: bag_plan(
        b, d, f, DTYPES[dtype], name, vec, True, device, gather=False))


def example_plans():
    """The reference's example (``b=512, d=16, f=256``: the row walk with
    16 rows in flight), then the one-row walk of grids past 65,536 threads
    (4,096 bags) and one retrieve query's small grid, in float32 and
    bf16."""
    return [plan(b, d, 256, dtype, vec)
            for dtype, vec in ((torch.float32, 4), (torch.bfloat16, 8))
            for b, d in ((512, 16), (4096, 50), (1, 50))]


def launch(p: plan_lib.LaunchPlan, gathered, weights, out,
           stream=None) -> None:
    """One launch of ``p`` on the wrapper's checked tensors."""
    b, d, f = gathered.shape
    fn = build.entry("bag_combine", [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + build.LAUNCH_ARGTYPES)
    build.check("bag_combine", fn(
        build.ptr(gathered), build.ptr(weights), build.ptr(out), b, d, f,
        p.args["vec"], DTYPES[gathered.dtype], p.args["code"],
        *p.launch_dims(),
        build.stream_of(gathered.device) if stream is None else stream))


def bag_combine(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[B, D, F]`` x ``[B, D]`` -> ``[B, F]``, float32 or bf16 (the
    weights of the rows' dtype, the output too): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors; differentiable through
    :class:`BagCombine` where autograd records."""
    if torch.is_grad_enabled() and (gathered.requires_grad
                                    or weights.requires_grad):
        return BagCombine.apply(gathered, weights)
    return _forward(gathered, weights)


class BagCombine(torch.autograd.Function):
    """The forward of :func:`bag_combine` (kernel or plain version by
    device) with the plain backward. ``gathered`` is kept for the backward
    only when the weights need a gradient."""

    @staticmethod
    def forward(ctx, gathered, weights):
        ctx.save_for_backward(
            gathered if weights.requires_grad else None, weights)
        return _forward(gathered, weights)

    @staticmethod
    def backward(ctx, g):
        gathered, weights = ctx.saved_tensors
        d_gathered = d_w = None
        if ctx.needs_input_grad[0]:
            d_gathered = weights[:, :, None].to(g.dtype) * g[:, None, :]
        if ctx.needs_input_grad[1]:
            d_w = torch.einsum("bdf,bf->bd", gathered,
                               g.to(gathered.dtype)).to(weights.dtype)
        return d_gathered, d_w


def _forward(gathered: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    global launches
    dev = gathered.device
    if dev.type == "cpu":
        return plain(gathered, weights)
    if dev.type != "cuda":
        raise ValueError(f"bag_combine: no kernel for device {dev}")
    if gathered.dim() != 3:
        raise ValueError(f"bag_combine: gathered must be [B, D, F], got "
                         f"{tuple(gathered.shape)}")
    b, d, f = gathered.shape
    if gathered.dtype not in DTYPES:
        raise TypeError(f"bag_combine gathered: dtype {gathered.dtype}, "
                        f"expected one of {list(DTYPES)}")
    build.require(gathered, "bag_combine gathered", gathered.dtype, dev,
                  (b, d, f))
    build.require(weights, "bag_combine weights", gathered.dtype, dev, (b, d))
    if b == 0 or f == 0:
        return torch.empty((b, f), dtype=gathered.dtype, device=dev)
    p = plan(b, d, f, gathered.dtype, _vec(gathered), dev)
    out = torch.empty((b, f), dtype=gathered.dtype, device=dev)
    launch(p, gathered, weights, out)
    launches += 1
    return out
