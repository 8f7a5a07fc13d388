"""Port parity: ``repro_torch.core.topology`` / ``machine`` build the same
machine arrays as the reference on every preset, with and without
``bin_speed``, degraded and not, and ``interop`` carries them over."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import machine as jmachine
from repro.core import topology as jtopo
from repro_torch import interop
from repro_torch.core import machine as tmachine
from repro_torch.core import topology as ttopo

torch.set_num_threads(1)

TREE_FIELDS = ("parent", "is_router", "link_cost", "compute_bins", "subtree",
               "link_nodes", "F_l", "bin_speed")


def assert_same_tree(a, b):
    for f in TREE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.distance_matrix(), b.distance_matrix())
    np.testing.assert_array_equal(a.lca_table(), b.lca_table())


def assert_same_routing(a, b):
    assert (a.k, a.n_links) == (b.k, b.n_links)
    for f in ("path_links", "path_frac", "F_l"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def assert_same_topology(a, b):
    if isinstance(a, jtopo.RoutingTopology):
        assert isinstance(b, ttopo.RoutingTopology)
        assert_same_routing(a, b)
    else:
        assert isinstance(b, ttopo.TreeTopology)
        assert_same_tree(a, b)


@pytest.mark.parametrize("name", jmachine.MachineSpec.presets())
def test_every_preset_matches_reference(name):
    assert tmachine.MachineSpec.presets() == jmachine.MachineSpec.presets()
    ref = jmachine.MachineSpec.preset(name)
    port = tmachine.MachineSpec.preset(name)
    assert_same_topology(ref.topology(), port.topology())
    assert ref.cache_token() == port.cache_token()
    np.testing.assert_array_equal(ref.peak_flops, port.peak_flops)
    b_ref, b_port = ref.bin_speed, port.bin_speed
    assert (b_ref is None) == (b_port is None)
    if b_ref is not None:
        np.testing.assert_array_equal(b_ref, b_port)


@pytest.mark.parametrize("name", ["tpu_v5e-256", "gpu-superpod",
                                  "tpu-mixed-32"])
def test_degraded_presets_match_reference(name):
    events = [{"kind": "leaf_death", "target": 3},
              {"kind": "straggler", "target": 5, "factor": 0.5}]
    if name != "gpu-superpod":
        events.append({"kind": "link_degrade", "target": "dcn",
                       "factor": 0.5})
    ref = jmachine.MachineSpec.preset(name).degrade(events)
    port = tmachine.MachineSpec.preset(name).degrade(events)
    assert ref.cache_token() == port.cache_token()
    assert_same_tree(ref.tree(), port.tree())
    assert jmachine.resolve(name).name == tmachine.resolve(name).name


@pytest.mark.parametrize("make_tree", [
    lambda m: m.balanced_tree((2, 4)),
    lambda m: m.balanced_tree((2, 2, 2), level_cost=(4.0, 1.0)),
    lambda m: m.production_tree(2, 4, 4),
    lambda m: m.fat_tree_topology(16, arity=4),
    lambda m: m.flat_topology(6),
    lambda m: m.guess_tree(12),
    lambda m: m.mesh_tree((2, 4, 4)),
], ids=["balanced", "balanced_cost", "production", "fat_tree", "flat",
        "guess", "mesh"])
@pytest.mark.parametrize("speed", [False, True])
def test_trees_match_reference_with_and_without_speed(make_tree, speed):
    ref, port = make_tree(jtopo), make_tree(ttopo)
    if speed:
        s = np.random.default_rng(ref.k).uniform(0.3, 1.0, ref.k)
        ref, port = jtopo.with_bin_speed(ref, s), ttopo.with_bin_speed(port, s)
    assert_same_tree(ref, port)
    dead = [0, ref.k - 1]
    assert_same_tree(jtopo.mask_bins(ref, dead), ttopo.mask_bins(port, dead))


@pytest.mark.parametrize("multipath", [False, True])
def test_torus_routing_matches_reference(multipath):
    ref = jtopo.torus2d_topology(3, 4, multipath=multipath)
    port = ttopo.torus2d_topology(3, 4, multipath=multipath)
    assert_same_routing(ref, port)
    np.testing.assert_array_equal(ref.path_incidence, port.path_incidence)


@pytest.mark.parametrize("name", jmachine.MachineSpec.presets())
def test_interop_topology_and_machine(name):
    ref = jmachine.MachineSpec.preset(name)
    port_spec = interop.topology_from_arrays(ref)
    assert isinstance(port_spec, tmachine.MachineSpec)
    assert port_spec.cache_token() == ref.cache_token()
    topo = ref.topology()
    assert_same_topology(topo, interop.topology_from_arrays(topo))


def test_interop_speed_tree_keeps_bin_speed():
    ref = jtopo.with_bin_speed(jtopo.balanced_tree((2, 2)), [1, 0.5, 1, 0.25])
    port = interop.topology_from_arrays(ref)
    assert_same_tree(ref, port)
    assert dataclasses.replace(port, bin_speed=None).bin_speed is None
