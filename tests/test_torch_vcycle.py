"""Port parity for the device V-cycle end to end: ``partition(backend=
"device")`` fed the reference's draws (matching jitter and refinement)
passes the port's ``verify()`` and lands within 1.05x of the reference's
makespan on the ``tests/test_device_vcycle.py`` graph and trees and on the
heterogeneous ``tpu-mixed-32`` machine, at one seed each. ``run_band`` is
shared with the host backend's test in ``test_torch_partitioner.py``."""
import numpy as np
import pytest
import torch
from test_torch_replay import JaxDraws, float_graph

from repro.core.machine import MachineSpec
from repro.core.partitioner import PartitionConfig as JConfig
from repro.core.partitioner import partition as jpartition
from repro.core.topology import balanced_tree
from repro_torch import interop
from repro_torch.core import partitioner as tpart
from repro_torch.core.reference import total_cut_ref

torch.set_num_threads(1)

CASES = [("(2,4)", lambda: balanced_tree((2, 4)), 0),
         ("(2,2,2)", lambda: balanced_tree((2, 2, 2)), 1),
         ("tpu-mixed-32", lambda: MachineSpec.preset("tpu-mixed-32").tree(),
          2)]


def run_band(backend, topo_fn, seed):
    g = float_graph(2000, 8000, seed=0)
    topo = topo_fn()
    jcfg = JConfig(seed=seed, backend=backend)
    ref = jpartition(g, topo, jcfg)
    pg = interop.graph_from_arrays(g)
    pt = interop.topology_from_arrays(topo)
    res = tpart.partition(pg, pt, interop.partition_config_from(jcfg),
                          device="cpu", draws=JaxDraws(seed))
    tpart.verify(pg, pt, res)
    assert res.part.shape == (g.n_nodes,) and res.part.dtype == np.int32
    assert res.makespan <= 1.05 * ref.makespan
    assert len(res.level_makespans) == len(ref.level_makespans)
    # total_cut comes from the quotient matrix the evaluation's comm was
    # summed from; the path-walking oracle recounts it from the arcs
    assert res.total_cut > 0
    np.testing.assert_allclose(res.total_cut, total_cut_ref(res.part, pg),
                               rtol=1e-5)



@pytest.mark.parametrize("name,topo_fn,seed", CASES, ids=[c[0] for c in CASES])
def test_device_backend_within_band_of_reference(name, topo_fn, seed):
    run_band("device", topo_fn, seed)
