"""The launch plan of every port kernel at the shape the smoke run times it
(``chip_smoke.py``'s kernels phase), under the H100's published limits:
kernel instance, grid, threads, dynamic shared memory and, for a
cooperative plan, the blocks an SM must hold (the static ``co-residency``
check's assumption; the smoke's ``kernel_plans`` line (b) reports the
card's own). One JSON line a kernel; imports no JAX and needs no card.

    PYTHONPATH=src python scripts/plan_table.py
"""
from __future__ import annotations

import json

import torch

from repro_torch.analysis import kernels as akernels
from repro_torch.kernels import (bag_combine, bsr_spmm, bucket_assign,
                                 flash_attention, gather_combine, match_keys,
                                 partition_gain)
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import quotient_link_loads as qll

# (row, shape as the kernels phase names it, the plan)
TIMED = [
    ("match_keys", "m = 1,548,288", lambda: match_keys.plan(1_548_288)),
    ("match_round", "level 0: 1,548,288 arcs, 262,144 vertices",
     lambda: match_keys.round_plan(1_548_288, 262_144)),
    ("bucket_assign", "n = 12,400, k = 64",
     lambda: bucket_assign.plan(12_400, 63)),
    ("prefix_split", "n = 12,400, k = 64",
     lambda: bucket_assign.split_plan(12_400, 63)),
    ("prefix_split", "n = 1,000,000, k = 64",
     lambda: bucket_assign.split_plan(1_000_000, 63)),
    ("quotient_link_loads", "1,548,288 arcs, k = 64",
     lambda: qll.plan(1_548_288, 262_144, 64, 126)),
    ("quotient_link_loads", "a DeepSeek expert search: 2,560 arcs, k = 512, "
     "546 links", lambda: qll.plan(2_560, 512, 512, 546)),
    ("partition_gain", "n = 2,000, D = 19, k = 8",
     lambda: partition_gain.plan(2_000, 19, 8)),
    ("bsr_spmm", "bulk: 3,840 block rows, 11,008 blocks, F = 64",
     lambda: bsr_spmm.plan(3_840, 128, 64, 11_008, 3_840, True)),
    ("bag_combine", "B = 512, D = 50, F = 256 float32",
     lambda: bag_combine.plan(512, 50, 256, torch.float32, 4)),
    ("gather_combine", "serve_p99: 512 bags of 50, 1M x 256 float32",
     lambda: gather_combine.plan(512, 50, 1_000_000, 256, torch.float32, 4,
                                 True)),
    ("gather_combine", "serve_bulk: 262,144 bags",
     lambda: gather_combine.plan(262_144, 50, 1_000_000, 256, torch.float32,
                                 4, True)),
    ("flash_attention", "4 x 4,096, 12 heads on 2, D = 128 bf16",
     lambda: flash_attention.plan(4, 4096, 4096, 12, 2, 128, 128,
                                  torch.bfloat16)),
    ("flash_attention", "MLA 4 x 4,096, 16 heads, D = 192, Dv = 128 bf16",
     lambda: flash_attention.plan(4, 4096, 4096, 16, 16, 192, 128,
                                  torch.bfloat16)),
]


def main() -> None:
    model = plan_lib.H100
    for row, shape, build in TIMED:
        p = build()
        findings = akernels.verify_plan(p, device=model)
        print(json.dumps(dict(
            row=row, shape=shape, kernel=p.kernel, grid=list(p.grid),
            threads=list(p.threads), dyn_smem=p.dyn_smem,
            cooperative=p.cooperative,
            assumed_per_sm=(model.resident_blocks(
                p.block_threads, p.dyn_smem, p.min_blocks_per_sm)
                if p.cooperative else None),
            path=p.args.get("path"),
            verifier=sorted({f.check for f in findings
                             if f.severity != "info"}) or "clean")))


if __name__ == "__main__":
    main()
