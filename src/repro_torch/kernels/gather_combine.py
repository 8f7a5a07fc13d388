"""Fused embedding-bag gather + combine (``ShardedEmbeddingTable.lookup_bags``).

Replaces the Pallas kernel ``repro/kernels/gather_combine.py:gather_combine``
with ``csrc/gather_combine.cu``:

    out[b, f] = sum over slots d of w[b, d] * table[idx[b, d], f]

without materialising the ``[B, D, F]`` gathered rows. The table is float32
or bf16, the weights float32; the sums are float32 and the output, of the
table's dtype, is rounded once (the reference kernel's ``out_shape``). The
TPU kernel scalar-prefetches the ids and DMAs one row tile per sequential
grid step. On Hopper a call that fills the card (serve_bulk) walks each
bag's rows through L1, which keeps the hot rows, two 16-byte columns a
thread; other calls (serve_p99) take the row walk of ``csrc/bag_reduce.cuh``,
shared with ``bag_combine``, which keeps 16 rows a thread in flight, and a
call too small to fill the card (one retrieve query) spreads F over one
warp per block. Every path sums the slots in order with each product and
sum rounded on its own, so all agree bitwise with each other and with
``bag_combine``. Bound by device-memory bytes: the distinct rows the bags
name, their ids and weights, and the output. Ids must lie in ``[0, V)``:
callers map padding to row 0 with weight 0, as the reference does, since
torch's indexing raises where JAX's clamps.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0

# table dtypes with a kernel, and their element bytes
DTYPES = {torch.float32: 4, torch.bfloat16: 2}
# the paths of csrc/gather_combine.cu:gather_plan
PATHS = ("small_grid", "rows", "wide_rows")


def plain(table: torch.Tensor, idx: torch.Tensor,
          weights: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path): the gather, a
    float32 ``einsum("bdf,bd->bf")`` (``repro/kernels/ref.py``), and one
    rounding to the table's dtype."""
    out = torch.einsum("bdf,bd->bf", table[idx].float(), weights.float())
    return out.to(table.dtype)


def vec_width(*tensors: torch.Tensor) -> int:
    """4 (float4 rows) when every tensor's rows are 16-byte aligned, else 1."""
    ok = all(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0
             for t in tensors)
    return 4 if ok else 1


def _vec(table: torch.Tensor, out: torch.Tensor) -> int:
    """Elements per 16-byte column where the table's and output's rows are
    whole 16-byte columns on aligned bases (4 float32, 8 bf16), else 1."""
    per = 16 // DTYPES[table.dtype]
    ok = all(t.shape[-1] % per == 0 and t.data_ptr() % 16 == 0
             for t in (table, out))
    return per if ok else 1


def path(b: int, f: int, dtype: torch.dtype, aligned: bool,
         sms: int) -> str:
    """The path the kernel takes for ``b`` bags of ``f`` columns on a card
    of ``sms`` multiprocessors (``aligned``: the table's and output's bases
    are 16-byte aligned): "small_grid", "rows" or "wide_rows"."""
    fn = build.library().gather_combine_path
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    per = 16 // DTYPES[dtype]
    vec = per if aligned and f % per == 0 else 1
    return PATHS[fn(b, f, vec, DTYPES[dtype], int(aligned), sms)]


def gather_combine(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``[V, F]`` float32 or bf16 table, ``[B, D]`` int32 row ids, ``[B, D]``
    float32 weights -> ``[B, F]`` of the table's dtype: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    global launches
    dev = table.device
    if dev.type == "cpu":
        return plain(table, idx, weights)
    if dev.type != "cuda":
        raise ValueError(f"gather_combine: no kernel for device {dev}")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"gather_combine: table [V, F] and idx [B, D], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    (v, f), (b, d) = table.shape, idx.shape
    if table.dtype not in DTYPES:
        raise TypeError(f"gather_combine table: dtype {table.dtype}, "
                        f"expected one of {list(DTYPES)}")
    build.require(table, "gather_combine table", table.dtype, dev, (v, f))
    build.require(idx, "gather_combine idx", torch.int32, dev, (b, d))
    build.require(weights, "gather_combine weights", torch.float32, dev,
                  (b, d))
    out = torch.empty((b, f), dtype=table.dtype, device=dev)
    if b == 0 or f == 0:
        return out
    fn = build.entry("gather_combine", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    build.check("gather_combine", fn(
        build.ptr(table), build.ptr(idx), build.ptr(weights), build.ptr(out),
        b, d, f, _vec(table, out), DTYPES[table.dtype], build.sm_count(dev),
        build.stream_of(dev)))
    launches += 1
    return out
