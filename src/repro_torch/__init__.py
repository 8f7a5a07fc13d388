"""PyTorch/CUDA port of the multilevel makespan partitioner (``src/repro``).

Subpackages mirror the JAX package: ``graph`` (arc-list graphs and
generators), ``core`` (machine trees, the makespan objective, coarsening,
initial partition, refinement and the ``partition()`` entry point) and
``kernels`` (hand-written CUDA kernels for Hopper, each beside its plain
PyTorch version). The package imports ``torch`` and ``numpy`` only.

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
