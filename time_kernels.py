#!/usr/bin/env python3
"""Time the port's workload kernels on one NVIDIA GPU at their paths'
shapes, with the checks and measurements of ``chip_smoke.py``'s kernels
phase: the bag kernels (``bag_combine``, ``gather_combine``) at the recsys
path's shapes, with the one-query alternation against their plain versions
and library calls, ``bsr_spmm`` at the gnn path's and ``flash_attention``
at the lm path's (one 4 x 4,096 prefill call and one of 32,768 tokens):

    python3 time_kernels.py [SRC] [--only recsys,gnn,lm]

``SRC`` (default: this checkout's ``src``) is the directory holding the
``repro_torch`` package to time, so that two trees can be compared on one
card, one process each, in the order A, B, B, A. ``--only`` keeps the
named groups. Prints the card's ``nvidia-smi`` line and one JSON line per
kernel and shape; exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import chip_smoke

GROUPS = {"recsys": chip_smoke.phase_kernels_recsys,
          "gnn": chip_smoke.phase_kernels_gnn,
          "lm": chip_smoke.phase_kernels_lm}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=None)
    ap.add_argument("--only", default=",".join(GROUPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    state = {"launches": {}}
    chip_smoke.phase_env(state)
    chip_smoke.phase_build(state)
    for name in args.only.split(","):
        GROUPS[name](state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
