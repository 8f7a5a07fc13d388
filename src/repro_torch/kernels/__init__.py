"""Hand-written Hopper (sm_90a) kernels of the port and their dispatch.

One module per kernel, each holding the wrapper that launches
``csrc/<name>.cu`` on CUDA tensors, the plain PyTorch version that CPU
tensors run, a launch counter (``launches``) and a note on the TPU kernel it
replaces. ``ops.py`` is the public API; ``build.py`` compiles the sources
with ``nvcc`` at first use and loads them with ``ctypes``;
``cost_sites.py`` declares what a kernel site costs to the dry-run's
op-cost recorder (``launch/op_cost.py``), which cannot see a launch.

Every launch is built from a launch plan (``plan.py:LaunchPlan``, the twin
of the reference's ``KernelPlan``): each module's cached ``plan(...)``
gives the grid, threads, shared memory and kernel variant its wrapper
passes to the C launcher, which computes and clips none of them, and each
module's ``example_plans()`` is registered in ``KERNEL_REGISTRY`` below.
The static verifier (``repro_torch.analysis.kernels``) proves bounds,
coverage, write-race, shared-memory, co-residency and TMA properties on
the registered plans without executing anything, and a completeness test
pins that every module with a ``build.entry(`` launch is registered. A new
launch variant gets an example plan here before its launcher compiles into
a path. (``csrc/l2_read.cu`` is the smoke run's L2-rate probe, not a
kernel of the system, and is not registered.)

Kernels (the partitioner's main path):
  * ``match_keys`` — jittered masked arc keys of device heavy-edge matching,
    and ``match_round``, the whole matching round fused (the coarsening
    path's kernel).
  * ``bucket_assign`` — capacity-boundary bucket search of the device
    initial partition, and ``prefix_split``, the whole capacity-prefix
    split (scan, midpoints, count, clip) fused (the initial partition's
    kernel).
  * ``quotient_link_loads`` — the paper's objective: arc list -> per-link
    communication load.
  * ``partition_gain`` — the dense refinement round's ``[n, k]``
    connectivity rows (ELL).

Kernels (the two-tower serving path):
  * ``bag_combine`` — the weighted bag reduction of ``embedding_bag`` over
    pre-gathered rows (``TwoTower`` user tower input), float32 or bf16.
  * ``gather_combine`` — the same reduction with the row gather fused
    (``ShardedEmbeddingTable.lookup_bags``), on float32 or bf16 tables.

Kernel (the GIN path):
  * ``bsr_spmm`` — block-sparse ``A @ X`` over a BSR layout's 128 x 128
    blocks, one CUDA block per (block row, row tile, feature tile) walking
    the block-row pointers (GIN's sum aggregation,
    ``ops.gnn_aggregate_bsr``).

Kernel (the LM path):
  * ``flash_attention`` — the online-softmax attention forward with GQA,
    one CUDA block per (batch, head, 64-row q tile) walking the kv tiles
    (every layer of the transformer's ``forward`` / ``prefill``).
"""
import importlib
from typing import Callable, Dict, List

from repro_torch.kernels.plan import LaunchPlan  # noqa: F401


def _examples(stem: str) -> Callable[[], List[LaunchPlan]]:
    """``<stem>.example_plans``, imported when called: the kernel modules
    import the model layer, which imports this package."""
    def build() -> List[LaunchPlan]:
        module = importlib.import_module(f"repro_torch.kernels.{stem}")
        return module.example_plans()
    build.__qualname__ = f"{stem}.example_plans"
    return build


# kernel name (= module stem) -> zero-arg function giving its example plans
# (the reference's example shapes, then one per launch variant);
# repro_torch.analysis.kernels.verify_all walks this
KERNEL_REGISTRY: Dict[str, Callable[[], List[LaunchPlan]]] = {
    stem: _examples(stem) for stem in (
        "flash_attention", "bsr_spmm", "bag_combine", "gather_combine",
        "partition_gain", "quotient_link_loads", "match_keys",
        "bucket_assign")}
