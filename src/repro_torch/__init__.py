"""PyTorch/CUDA port of the multilevel makespan partitioner (``src/repro``).

Subpackages mirror the JAX package: ``graph`` (arc-list graphs and
generators), ``core`` (machine trees, the makespan objective, coarsening,
initial partition, refinement, the ``partition()`` entry point and block
placement), ``configs`` (two-tower, GIN-TU, dense-GQA and MoE + MLA LM
configurations and shape grids), ``data`` (seeded LM, recsys, GNN-feature
and molecule batches), ``models`` (MLP, the two-tower model, the GIN
forward, the GQA and MoE + MLA transformer with its loss), ``embed`` (the partition-sharded embedding
table, the hot-row cache, the sparse table optimizer and the prefetching
sampler), ``serving`` (paged KV cache, scheduler, paged decode, the
continuous-batching engine with its fault recovery), ``resilience``
(fault plans, the injector, the chaos harness), ``optim`` (AdamW),
``dist`` (int8 gradient compression), ``train`` (the train step, the
fault-tolerant loop and its restart supervisor),
``ckpt`` (checkpoints), ``tree`` (nested parameter trees), ``launch``
(the serving and training CLIs and the page mapper), ``analysis`` (the
traffic-matrix lint) and ``kernels``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: the four partitioner kernels, ``bag_combine``,
``gather_combine``, ``bsr_spmm`` and ``flash_attention``). The package
imports ``torch`` and ``numpy`` only.

Entry points take ``device=None``, meaning ``torch.device("cuda")``; they
raise when no CUDA device is present unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
from __future__ import annotations

from typing import Union

import torch

# The reference scores in full float32 (JAX on the TPU/CPU with x64 off).
# Products in the objective and the refinement prices must not drop to TF32
# on the H100, so both switches are pinned off for the whole port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> CUDA. Raises when CUDA is asked for and absent: the port
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path")
    return dev
