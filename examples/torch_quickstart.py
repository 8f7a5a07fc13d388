"""Quickstart on the port: the paper's objective on the card.

Twin of ``examples/quickstart.py`` over ``repro_torch``. Builds a machine
tree (2 pods x 4 chips, slow inter-pod link), partitions a mesh graph with
the makespan objective, compares against total-cut and random baselines,
realizes the result as a block placement, and re-runs the partition on a
registered heterogeneous machine preset (``core/machine.py``).

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import baselines
from repro_torch.core.machine import MachineSpec
from repro_torch.core.mapping import apply_placement, block_placement
from repro_torch.core.partitioner import PartitionConfig, partition, verify
from repro_torch.core.topology import balanced_tree
from repro_torch.graph.generators import grid2d

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: CUDA")
dev = ap.parse_args().device

# Machine: root -(slow DCN, F=8)- 2 pods -(fast ICI, F=1)- 4 chips each.
topo = balanced_tree((2, 4), level_cost=(8.0, 1.0))
print(f"machine tree: {topo.k} compute bins, {topo.n_links} links")

# Application: 2D mesh (SpMV-type stencil workload).
g = grid2d(48, 48)
print(f"graph: {g.n_nodes} vertices, {g.n_edges} edges")

# The paper's partitioner: minimize max(comp(b), F_l * comm(l)).
res = partition(g, topo, PartitionConfig(seed=0), device=dev)
verify(g, topo, res)     # cross-checked against the path-walking oracle
print(f"\nmakespan-opt: M(P)={res.makespan:.0f} "
      f"(comp_max={res.comp_max:.0f}, comm_max={res.comm_max:.0f})")

# Baselines: classic total-cut minimization, and random.
cut = baselines.total_cut_partition(g, topo.k, device=dev)
rand = baselines.random_partition(g.n_nodes, topo.k)
for name, part in [("cut-opt", cut), ("random", rand)]:
    s = baselines.score_all(g, topo, part, device=dev)
    print(f"{name:>12}: M(P)={s['makespan']:.0f} "
          f"(cut={s['total_cut']:.0f}, imbalance={s['imbalance']:.2f})")

# Realize the decision: permute vertices so contiguous row blocks coincide
# with bins; row-block i of any [N, F] array then belongs to bin i.
pl = block_placement(res.part, topo.k)
g2 = apply_placement(g, pl)
print(f"\nblock placement: {pl.n_pad} padded rows, "
      f"{pl.block} rows/bin; fill={pl.fill.tolist()}")
print("row-block i of any [N, F] array now lives on bin i — done.")

# Machine presets: the mixed-generation preset has nonuniform leaf speeds,
# so the objective becomes comp(b)/speed(b) and the partitioner sends more
# load to the fast pod.
print(f"\nregistered machines: {', '.join(MachineSpec.presets())}")
mixed = MachineSpec.preset("tpu-mixed-32")
topo_m = mixed.tree()
res_m = partition(g, topo_m, PartitionConfig(seed=0), device=dev)
verify(g, topo_m, res_m)   # the oracle is capacity-normalized too
raw = np.zeros(topo_m.k)
np.add.at(raw, res_m.part, g.node_weight)
print(f"{mixed.name}: M(P)={res_m.makespan:.0f} "
      f"fast-pod load={raw[:16].sum():.0f} "
      f"slow-pod load={raw[16:].sum():.0f} "
      f"(speeds {mixed.leaf_tflops[0]:.0f}/{mixed.leaf_tflops[-1]:.0f} TF)")
