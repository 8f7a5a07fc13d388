"""The paper's contribution: graph-constrained makespan partitioning.

Submodules: machine (declarative MachineSpec + preset registry), topology
(machine trees / routing oracles), objective (torch quotient-matrix
makespan over the quotient_link_loads kernel, capacity-normalized for
heterogeneous PEs), reference (path-walking oracle), coarsen / initial /
refine / partitioner (the multilevel algorithm).
"""
from repro_torch.core.machine import MachineSpec  # noqa: F401
from repro_torch.core.partitioner import (PartitionConfig,  # noqa: F401
                                          PartitionResult, partition)
from repro_torch.core.refine import RefineConfig  # noqa: F401
