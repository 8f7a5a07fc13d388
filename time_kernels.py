#!/usr/bin/env python3
"""Time the port's workload kernels on one NVIDIA GPU at their paths'
shapes, with the checks and measurements of ``chip_smoke.py``'s kernels
phase: the bag kernels (``bag_combine``, ``gather_combine``) at the recsys
path's shapes, ``bsr_spmm`` at the gnn path's and ``flash_attention`` at
the lm path's (one 4 x 4,096 prefill call and one of 32,768 tokens):

    python3 time_kernels.py [SRC]

``SRC`` (default: this checkout's ``src``) is the directory holding the
``repro_torch`` package to time, so that two trees can be compared on one
card, one process each, in the order A, B, B, A. Prints the card's
``nvidia-smi`` line and one JSON line per kernel and shape; exits 2
without a CUDA device.
"""
from __future__ import annotations

import sys
from pathlib import Path

import chip_smoke


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        sys.path.insert(0, str(Path(sys.argv[1]).resolve()))
    state = {"launches": {}}
    chip_smoke.phase_env(state)
    chip_smoke.phase_build(state)
    chip_smoke.phase_kernels_recsys(state)
    chip_smoke.phase_kernels_gnn(state)
    chip_smoke.phase_kernels_lm(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
