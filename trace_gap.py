#!/usr/bin/env python3
"""Count how often a ``torch.profiler`` trace of one GIN-TU request forward
(``chip_smoke.py``'s gnn request: 128 molecules, five ``bsr_spmm``
launches) misses device events, with the recorded run launched at once
after the profiler's switch to its recorded cycle and after
``chip_smoke.TRACE_GAP_S`` idle seconds:

    python3 trace_gap.py [TRIES]

Each try is one ``chip_smoke._traced`` call, which raises when the trace
holds fewer ``bsr_spmm`` events than the launch counter counted; the two
settings alternate, ``TRIES`` (default 100) each. Prints the card's
``nvidia-smi`` line and one JSON line per setting; exits 2 without a CUDA
device.
"""
from __future__ import annotations

import json
import sys

import chip_smoke as cs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("trace_gap: no CUDA device", file=sys.stderr)
        return 2
    tries = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    from repro_torch.configs import gin_tu
    from repro_torch.models.gnn import GIN
    state = {"launches": {}}
    cs.phase_env(state)
    cs.phase_build(state)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = GIN(gin_tu.ARCH.make_config("molecule"), generator=gen,
                device=dev)
    inp = cs.gnn_inputs(state, cs.GNN_REQUEST_GRAPHS)

    def serve():
        return model(inp["request"], inp["layout"])
    serve()
    missed = {0.0: 0, cs.TRACE_GAP_S: 0}
    for _ in range(tries):
        for gap in missed:
            try:
                cs._traced(serve, {"bsr_spmm_kernel": ("bsr_spmm",)},
                           gap_s=gap, attempts=1)
            except AssertionError:
                missed[gap] += 1
    for gap, n in missed.items():
        print(json.dumps(dict(graphs=cs.GNN_REQUEST_GRAPHS, gap_s=gap,
                              tries=tries, traces_missing_events=n)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
