"""Launch plans: the one description of a CUDA launch that both the
kernel's launcher and the static verifier consume.

Twin of ``repro/kernels/plan.py``. Every kernel module of this package
builds its launch (grid, threads, dynamic shared memory, the kernel
variant and its statics) through a cached ``plan(...)`` returning a
:class:`LaunchPlan`, and its wrapper passes exactly that plan's numbers to
the C launcher, which computes none of them and refuses what disagrees
with its compile-time constants or what the card cannot hold (it never
clips). ``repro_torch.analysis.kernels`` verifies plans without executing
anything: because the launch is built from the same plan object, the
verified configuration is the executed one. Each module also exposes
``example_plans()``, the plans at the reference's example shapes and one
more per launch variant, which ``KERNEL_REGISTRY`` lists.

Fields beyond what the launch needs are verifier declarations:

* ``writes[i]`` / ``reads[i]`` — per output / operand, a function from a
  block index (one int per grid dim) to the tiles that block writes /
  reads, a tile being half-open ``(lo, hi)`` ranges per dim, or a
  :class:`Tile` carrying a ``phase``; grid-stride and persistent loops
  list every tile the block takes. A read map may be :data:`INDIRECT` for
  a data-dependent gather.
* ``masked_edges[i]`` — per output dim, whether the kernel guards a
  ragged edge (a written tile may then overhang it).
* ``atomic_outputs`` / ``phases`` — the twins of ``out_accumulate`` /
  ``seq_axes``: blocks of a GPU grid run in no order, so two blocks may
  write one element only atomically, or in phases of a cooperative kernel
  separated by a grid barrier.
* ``tma`` — each tensor map's dtype, dims, byte strides, box and swizzle.
* ``vectors`` — declared 16-byte vector accesses: (tensor, row pitch
  bytes, base offset bytes).
* ``min_blocks_per_sm`` — what the source's ``__launch_bounds__``
  guarantees; the ``co-residency`` check assumes no more.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import (Any, Callable, Dict, Hashable, Iterable, List, Mapping,
                    NamedTuple, Optional, Sequence, Tuple, Union)

# a read map of a data-dependent gather
INDIRECT = "indirect"

ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
            "int64": 8, "uint8": 1, "bool": 1}

Ranges = Tuple[Tuple[int, int], ...]


class Tile(NamedTuple):
    """Half-open ranges per dim, written in ``phase`` (0 unless the plan
    is cooperative and has several barrier-separated phases)."""
    ranges: Ranges
    phase: int = 0


class Arg(NamedTuple):
    """An operand or output: its name, shape and dtype name."""
    name: str
    shape: Tuple[int, ...]
    dtype: str


class TensorMap(NamedTuple):
    """A TMA tensor map as the launcher encodes it: dims and box innermost
    first, global strides in bytes for dims 1.., swizzle span in bytes (0
    for none)."""
    name: str
    dtype: str
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    swizzle: int


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Everything static about one launch (see the module docstring).
    ``kernel`` names the ``__global__`` instance the launcher picks (its
    attributes and occupancy are queried by that name); ``args`` holds
    kernel-private statics (``path``, tile sizes), the twin of ``meta``."""
    name: str
    entry: str
    kernel: str
    grid: Tuple[Any, ...]
    threads: Tuple[int, ...]
    dyn_smem: int = 0
    smem_optin: bool = False
    cooperative: bool = False
    min_blocks_per_sm: int = 1
    operands: Tuple[Arg, ...] = ()
    outputs: Tuple[Arg, ...] = ()
    writes: Tuple[Callable[..., Iterable], ...] = ()
    reads: Tuple[Union[Callable[..., Iterable], str], ...] = ()
    masked_edges: Tuple[Tuple[bool, ...], ...] = ()
    atomic_outputs: Tuple[int, ...] = ()
    phases: int = 1
    tma: Tuple[TensorMap, ...] = ()
    vectors: Tuple[Tuple[str, int, int], ...] = ()
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def blocks(self) -> int:
        return math.prod(int(g) for g in self.grid)

    @property
    def block_threads(self) -> int:
        return math.prod(self.threads)

    def launch_dims(self) -> Tuple[int, ...]:
        """grid.x, grid.y, grid.z, block.x, block.y, block.z and the
        dynamic shared memory, as every launcher takes them (dims padded
        with 1s to a ``dim3``)."""
        def dim3(dims):
            return tuple(int(x) for x in dims) + (1,) * (3 - len(dims))
        return (*dim3(self.grid), *dim3(self.threads), int(self.dyn_smem))


# ---------------------------------------------------------------------------
# the card's limits
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """The limits the static checks assume. The defaults are the H100
    SXM5's published compute-capability-9.0 limits; :func:`device_model`
    reads them from the card where there is one."""
    name: str = "H100 SXM5 (published limits)"
    sms: int = 132
    max_threads_block: int = 1024
    max_threads_sm: int = 2048
    max_blocks_sm: int = 32
    regs_sm: int = 65536
    smem_sm: int = 228 * 1024
    smem_block_optin: int = 227 * 1024
    smem_block: int = 48 * 1024
    smem_reserved_block: int = 1024
    max_grid: Tuple[int, int, int] = (2 ** 31 - 1, 65535, 65535)

    def resident_blocks(self, threads: int, smem: int,
                        min_blocks_per_sm: int) -> int:
        """Blocks of ``threads`` threads and ``smem`` bytes of dynamic
        shared memory an SM is sure to hold: its thread, block and shared
        memory limits, and no more than the ``__launch_bounds__``
        guarantee of registers (``min_blocks_per_sm``)."""
        warps = -(-threads // 32) * 32
        by_threads = self.max_threads_sm // max(warps, 1)
        by_smem = self.smem_sm // (smem + self.smem_reserved_block)
        return max(0, min(by_threads, by_smem, self.max_blocks_sm,
                          max(1, min_blocks_per_sm)))


H100 = DeviceModel()


@functools.lru_cache(maxsize=None)
def device_model(device=None) -> DeviceModel:
    """The card's own limits (``torch.cuda.get_device_properties``) for a
    CUDA device, else the H100 defaults."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return H100
    p = torch.cuda.get_device_properties(torch.device(device))
    return DeviceModel(
        name=p.name, sms=int(p.multi_processor_count),
        max_threads_block=int(getattr(p, "max_threads_per_block",
                                      H100.max_threads_block)),
        max_threads_sm=int(getattr(p, "max_threads_per_multi_processor",
                                   H100.max_threads_sm)),
        regs_sm=int(getattr(p, "regs_per_multiprocessor", H100.regs_sm)),
        smem_sm=int(getattr(p, "shared_memory_per_multiprocessor",
                            H100.smem_sm)),
        smem_block_optin=int(getattr(p, "shared_memory_per_block_optin",
                                     H100.smem_block_optin)),
        smem_block=int(getattr(p, "shared_memory_per_block",
                               H100.smem_block)))


_occupancy: Dict[Tuple, int] = {}


def occupancy(entry: str, kernel: str, threads: int, smem: int,
              min_blocks_per_sm: int, device=None) -> int:
    """Blocks of ``kernel`` an SM holds at ``threads`` and ``smem``: on a
    card the card's own answer (``repro_occupancy``, asked once per kernel
    and shape), else the static model's."""
    import torch
    if device is None or torch.device(device).type != "cuda":
        return H100.resident_blocks(threads, smem, min_blocks_per_sm)
    key = (str(device), entry, kernel, threads, smem)
    got = _occupancy.get(key)
    if got is None:
        from repro_torch.kernels import build
        got = _occupancy[key] = build.occupancy(entry, kernel, threads,
                                                smem)
    return got


# ---------------------------------------------------------------------------
# plan caches: one per kernel module, so a launch pays a dictionary lookup
# ---------------------------------------------------------------------------

class PlanCache(dict):
    """Plans by shape key."""

    def get_or_build(self, key: Hashable,
                     build: Callable[[], LaunchPlan]) -> LaunchPlan:
        got = self.get(key)
        if got is None:
            got = self[key] = build()
        return got


_CACHES: Dict[str, PlanCache] = {}


def cache(name: str) -> PlanCache:
    """The plan cache of kernel module ``name``."""
    return _CACHES.setdefault(name, PlanCache())


def cached_plans(names: Optional[Sequence[str]] = None) -> List[LaunchPlan]:
    """Every plan built in this process, by kernel module."""
    return [p for n, c in sorted(_CACHES.items())
            if names is None or n in names for p in c.values()]


def strided(b: int, chunk: int, blocks: int, total: int,
            clip: bool = False) -> List[Ranges]:
    """The 1-d tiles block ``b`` of ``blocks`` takes in a grid-stride loop
    of ``chunk`` elements a block step over ``total`` elements: ``[lo, lo +
    chunk)`` for ``lo = b * chunk, (b + blocks) * chunk, ...`` below
    ``total``, cut to ``total`` where ``clip``."""
    step = chunk * blocks
    return [((lo, min(total, lo + chunk) if clip else lo + chunk),)
            for lo in range(b * chunk, total, step)]
