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
torch's indexing raises where JAX's clamps. The launch comes from
:func:`plan` (``kernels/plan.py``), whose path rule this module also
gives ``bag_combine``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

# launches of the CUDA kernel (plain CPU calls do not count)
launches = 0

# table dtypes with a kernel, and their element bytes
DTYPES = {torch.float32: 4, torch.bfloat16: 2}
# the paths a call takes (:func:`path`)
PATHS = ("small_grid", "rows", "wide_rows")
# the launch variants of csrc/bag_reduce.cuh (BagPath): the small grid with
# 16 or 64 slots in flight a thread, the row walk with 16 rows loaded ahead
# or one, the wide row walk (gather only)
BAG_PATHS = ("small16", "small64", "deep", "flat", "wide")
_ELEM_NAME = {4: ("float", "float4"), 2: ("bf16", "bf16x8")}
BAG_MAX_ROWS = 8             # block rows (bags) of the row walk
BAG_DEEP_MAX_THREADS = 1 << 16
BAG_SMALL_SHORT = 16         # slots in flight on the small grid, d <= 16
WIDE_COLS = 2                # 16-byte columns a thread on the wide walk
WIDE_MAX_BAGS = 16
WIDE_THREADS = 256


def bag_geometry(n_bags: int, cols: int):
    """The row walk's ``(block, grid)`` for ``n_bags`` bags of ``cols``
    columns: up to 256 threads across the columns, up to 8 bags a block,
    128 threads a block where the columns are few."""
    tx = min(-(-cols // 32) * 32, 256)
    ty = max(1, min(BAG_MAX_ROWS, 128 // tx))
    return (tx, ty), (-(-n_bags // ty), -(-cols // tx))


def small_grid(n_bags: int, f: int, vec: int, sms: int) -> bool:
    """Whether a bag launch takes the small-grid path: the row walk's grid
    over ``f / vec`` columns has fewer blocks than the card's ``sms``
    multiprocessors, and the bags fit the small grid's second axis."""
    _, (gx, gy) = bag_geometry(n_bags, f // vec)
    return gx * gy < sms and n_bags <= 65535


def rule_vec(f: int, vec: int, elem: int) -> int:
    """The vec the path rules read: the launch's own for float32, float4
    columns (where f % 4 == 0) for bf16, so a bf16 call takes the path a
    float32 one of the same shape takes."""
    return (4 if f % 4 == 0 else 1) if elem == 2 else vec


def _path(b, f, vec, elem, aligned, sms, gather):
    rv = rule_vec(f, vec, elem)
    if small_grid(b, f, rv, sms):
        return "small_grid"
    if not gather:
        return "rows"
    row_bytes = f * elem
    cols = row_bytes // 16
    tpb = cols // WIDE_COLS
    if (not aligned or row_bytes % 16 or b * (f // rv) <= BAG_DEEP_MAX_THREADS
            or cols % WIDE_COLS or tpb < WIDE_THREADS // WIDE_MAX_BAGS
            or tpb > WIDE_THREADS):
        return "rows"
    return "wide_rows"


def bag_plan(b: int, d: int, f: int, elem: int, w_name: str, vec: int,
             aligned: bool, device, gather: bool,
             v: int = 0) -> plan_lib.LaunchPlan:
    """The launch of either bag kernel over ``b`` bags of ``d`` slots and
    ``f`` elements of ``elem`` bytes (weights ``w_name``), ``vec`` elements
    a column (1, or 16 bytes where the rows are whole 16-byte columns on
    aligned bases) on ``device``'s card: ``gather_combine`` from a table
    of ``v`` rows where ``gather``, else ``bag_combine``."""
    sms = plan_lib.device_model(device).sms
    route = _path(b, f, vec, elem, aligned, sms, gather)
    e, e16 = _ELEM_NAME[elem]
    g = int(gather)
    dt = "float32" if elem == 4 else "bfloat16"
    if route == "small_grid":
        variant = "small16" if d <= BAG_SMALL_SHORT else "small64"
        kernel = (f"bag_reduce_small_kernel<{e},{g},"
                  f"{16 if variant == 'small16' else 64},{w_name}>")
        grid, threads = (-(-f // 32), b), (32,)

        def out_tiles(x, y):
            return [((y, y + 1), (32 * x, 32 * x + 32))]

        def bags_of(x, y):
            return (y, y + 1)
    elif route == "rows":
        cols = f // vec
        variant = "deep" if b * cols <= BAG_DEEP_MAX_THREADS else "flat"
        (tx, ty), grid = bag_geometry(b, cols)
        threads = (tx, ty)
        kernel = (f"bag_reduce_kernel<{e if vec == 1 else e16},{g},"
                  f"{16 if variant == 'deep' else 1},{w_name}>")

        def out_tiles(x, y):
            return [((x * ty, x * ty + ty),
                     (y * tx * vec, (y + 1) * tx * vec))]

        def bags_of(x, y):
            return (x * ty, min(b, x * ty + ty))
    else:
        variant = "wide"
        tpb = f * elem // 16 // WIDE_COLS
        bpb = WIDE_THREADS // tpb
        grid, threads = (-(-b // bpb),), (bpb * tpb,)
        kernel = f"bag_reduce_wide_kernel<{e}>"

        def out_tiles(x):
            return [((x * bpb, x * bpb + bpb), (0, f))]

        def bags_of(x):
            return (x * bpb, min(b, x * bpb + bpb))

    def slots(*blk):
        return [(bags_of(*blk), (0, d))]

    arg = plan_lib.Arg
    if gather:
        operands = (arg("table", (v, f), dt), arg("idx", (b, d), "int32"),
                    arg("weights", (b, d), "float32"))
        reads = (plan_lib.INDIRECT, slots, slots)
        src = "table"
    else:
        operands = (arg("gathered", (b, d, f), dt),
                    arg("weights", (b, d), dt))

        def rows_read(*blk):
            ((lo, hi), (c0, c1)), = out_tiles(*blk)
            return [(bags_of(*blk), (0, d), (c0, min(f, c1)))]

        reads = (rows_read, slots)
        src = "gathered"
    wide16 = variant == "wide" or (variant in ("deep", "flat") and vec > 1)
    return plan_lib.LaunchPlan(
        name="gather_combine" if gather else "bag_combine",
        entry="gather_combine" if gather else "bag_combine", kernel=kernel,
        grid=grid, threads=threads, operands=operands,
        outputs=(arg("out", (b, f), dt),), writes=(out_tiles,), reads=reads,
        masked_edges=((True, True),),
        vectors=((src, f * elem, 0), ("out", f * elem, 0)) if wide16 else (),
        args={"path": route, "variant": variant,
              "code": BAG_PATHS.index(variant), "vec": vec})


_plans = plan_lib.cache("gather_combine")


def plan(b: int, d: int, v: int, f: int, dtype: torch.dtype, vec: int,
         aligned: bool, device=None) -> plan_lib.LaunchPlan:
    """The launch over ``b`` bags of ``d`` slots into a ``[v, f]`` table
    of ``dtype`` (``aligned``: its base is 16-byte aligned; ``vec`` from
    :func:`_vec`) on ``device``'s card, cached by shape."""
    return _plans.get_or_build((b, d, v, f, dtype, vec, aligned, device),
                               lambda: bag_plan(b, d, f, DTYPES[dtype],
                                                "float", vec, aligned,
                                                device, gather=True, v=v))


def example_plans():
    """The reference's example (``b=64, d=8, v=4096, f=256``), then each
    path in float32 and bf16: the wide walk of grids that fill the card
    (4,096 bags), serve_p99's row walk (512) and one retrieve query's
    small grid."""
    return [plan(64, 8, 4096, 256, torch.float32, 4, True)] + [
        plan(b, 50, 65_536, 256, dtype, vec, True)
        for dtype, vec in ((torch.float32, 4), (torch.bfloat16, 8))
        for b in (4096, 512, 1)]


def launch(p: plan_lib.LaunchPlan, table, idx, weights, out,
           stream=None) -> None:
    """One launch of ``p`` on the wrapper's checked tensors."""
    fn = build.entry("gather_combine", [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + build.LAUNCH_ARGTYPES)
    b, d = idx.shape
    build.check("gather_combine", fn(
        build.ptr(table), build.ptr(idx), build.ptr(weights), build.ptr(out),
        b, d, table.shape[1], p.args["vec"], DTYPES[table.dtype],
        p.args["code"], *p.launch_dims(),
        build.stream_of(table.device) if stream is None else stream))


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


def _vec(table: torch.Tensor) -> int:
    """Elements per 16-byte column where the table's rows are 16-byte
    columns on an aligned base (4 float32, 8 bf16), else 1. The output, a
    fresh ``torch.empty``, is always aligned."""
    per = 16 // DTYPES[table.dtype]
    return (per if table.shape[-1] % per == 0 and table.data_ptr() % 16 == 0
            else 1)


def path(b: int, f: int, dtype: torch.dtype, aligned: bool,
         sms: int) -> str:
    """The path the kernel takes for ``b`` bags of ``f`` columns on a card
    of ``sms`` multiprocessors (``aligned``: the table's and output's bases
    are 16-byte aligned): "small_grid", "rows" or "wide_rows" (the
    plan's rule)."""
    per = 16 // DTYPES[dtype]
    vec = per if aligned and f % per == 0 else 1
    return _path(b, f, vec, DTYPES[dtype], aligned, sms, gather=True)


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
    if b == 0 or f == 0:
        return torch.empty((b, f), dtype=table.dtype, device=dev)
    p = plan(b, d, v, f, table.dtype, _vec(table),
             table.data_ptr() % 16 == 0, dev)
    out = torch.empty((b, f), dtype=table.dtype, device=dev)
    launch(p, table, idx, weights, out)
    launches += 1
    return out
