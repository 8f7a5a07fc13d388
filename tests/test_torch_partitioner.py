"""Port parity for the initial partition and the ``partition()`` entry point:
host initial partitions are the reference's exactly; the device prefix
split is exact on integer weights and flips only boundary midpoints on
float ones; end to end, the host backend fed the reference's draws passes
the port's ``verify()`` and lands within 1.05x of the reference's makespan
(the device backend's twin test is in ``test_torch_vcycle.py``)."""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_replay import float_graph
from test_torch_vcycle import CASES, run_band

from repro.core import initial as jinitial
from repro.core.topology import balanced_tree, with_bin_speed
from repro.graph.generators import grid2d
from repro_torch import interop
from repro_torch.core import initial as tinitial
from repro_torch.core import partitioner as tpart

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("speed", [False, True])
def test_host_initial_partition_is_the_reference_exactly(seed, speed):
    g = float_graph(400, 1600, seed=seed)
    topo = balanced_tree((2, 2, 2))
    if speed:
        topo = with_bin_speed(topo, np.linspace(1.0, 0.3, topo.k))
    ref = jinitial.initial_partition(g, topo, seed=seed)
    got = tinitial.initial_partition(interop.graph_from_arrays(g),
                                     interop.topology_from_arrays(topo),
                                     seed=seed)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tinitial.random_partition(400, 8, g.node_weight, seed=seed),
        jinitial.random_partition(400, 8, g.node_weight, seed=seed))


@pytest.mark.parametrize("branching", [(2, 4), (4, 4, 4)])
def test_device_initial_is_exact_on_integer_weights(branching):
    g = grid2d(40, 40)
    topo = balanced_tree(branching)
    ref = jinitial.initial_partition_device(g, topo)
    got = tinitial.initial_partition_device(
        interop.graph_from_arrays(g), interop.topology_from_arrays(topo),
        device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("speed", [False, True])
def test_device_initial_flips_only_boundary_midpoints_on_float_weights(speed):
    """float32 prefix sums taken in another order (the reference's scan vs
    torch's) can move a midpoint that sits within rounding of a capacity
    boundary into the neighbouring bin; any vertex that differs must be
    such a midpoint, one bin away."""
    g = float_graph(3000, 9000, seed=5)
    topo = balanced_tree((2, 4))
    if speed:
        topo = with_bin_speed(topo, [1, 1, 1, 1, .25, .25, .25, .25])
    ref = jinitial.initial_partition_device(g, topo)
    got = tinitial.initial_partition_device(
        interop.graph_from_arrays(g), interop.topology_from_arrays(topo),
        device="cpu")
    flips = np.nonzero(got != ref)[0]
    caps = np.ones(topo.k) if topo.bin_speed is None else topo.bin_speed
    bounds = (np.cumsum(caps)[:-1] / caps.sum()
              * float(g.node_weight.sum())).astype(np.float32)
    nw = g.node_weight.astype(np.float64)
    mid = np.cumsum(nw) - 0.5 * nw
    for v in flips:
        assert abs(int(got[v]) - int(ref[v])) == 1, v
        assert np.abs(bounds - mid[v]).min() <= 1e-3 * mid[v], v
    assert flips.size <= 2


def test_device_initial_rejects_zero_capacity_bins():
    g = interop.graph_from_arrays(float_graph(100, 300))
    dead = dataclasses.replace(
        interop.topology_from_arrays(balanced_tree((2, 2))),
        bin_speed=np.array([1, 1, 1, 0], np.float32))
    with pytest.raises(ValueError, match="zero-capacity"):
        tinitial.initial_partition_device(g, dead, device="cpu")


@pytest.mark.parametrize("name,topo_fn,seed", CASES, ids=[c[0] for c in CASES])
def test_host_backend_within_band_of_reference(name, topo_fn, seed):
    run_band("host", topo_fn, seed)


def test_best_of_seeds_never_worse_and_rejects_bad_configs():
    g = interop.graph_from_arrays(float_graph(600, 2400, seed=4))
    topo = interop.topology_from_arrays(balanced_tree((2, 2)))
    one = tpart.partition(g, topo, tpart.PartitionConfig(seed=1),
                          device="cpu")
    two = tpart.partition(g, topo, tpart.PartitionConfig(seed=1, seeds=3),
                          device="cpu")
    tpart.verify(g, topo, two)
    assert two.makespan <= one.makespan * (1 + 1e-5)
    with pytest.raises(ValueError, match="backend"):
        tpart.partition(g, topo, tpart.PartitionConfig(backend="gpu"),
                        device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        tpart.partition(g, topo, tpart.PartitionConfig(seeds=0), device="cpu")


def test_partition_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = interop.graph_from_arrays(float_graph(100, 300))
    topo = interop.topology_from_arrays(balanced_tree((2, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpart.partition(g, topo)
    res = tpart.partition(g, topo, device="cpu")
    assert np.isfinite(res.makespan)
