"""Port parity for ``core/mapping.py``. Block placement:
``block_placement`` and ``apply_placement`` give every field the reference
gives for the same ``part`` (unequal bins, an empty bin, a partitioner's
result), and the placed graph's BSR layout is the reference's. The
mesh-mapping search: the traffic model and the candidate enumeration row
for row, the batched and routing scorers against their oracles and the
reference, and the search's winner against the reference's on the
reference tests' inputs."""
import numpy as np
import pytest
import torch

from repro.core import mapping as jmapping
from repro.graph import generators as jgen
from repro.kernels import bsr_spmm as jbsr
from repro_torch.core import mapping as tmapping
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import balanced_tree
from repro_torch.graph import generators as tgen
from repro_torch.kernels import bsr_spmm as tbsr

torch.set_num_threads(1)

FIELDS = ("perm", "inverse", "n_pad", "block", "bin_of_row", "fill")


def _assert_placement_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def _assert_graph_equal(a, b):
    assert a.n_nodes == b.n_nodes
    for f in ("senders", "receivers", "edge_weight", "node_weight",
              "offsets"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _parts():
    rng = np.random.default_rng(0)
    skewed = rng.choice(6, 500, p=[0.4, 0.3, 0.2, 0.05, 0.05, 0.0])
    return {
        "uniform_k8": (rng.integers(0, 8, 1000), 8),
        "skewed_k6_empty_bin": (skewed, 6),       # bin 5 is empty
        "last_bins_empty_k10": (rng.integers(0, 7, 301), 10),
        "one_bin": (np.zeros(37, dtype=np.int64), 1),
        "int32_k4": (rng.integers(0, 4, 64).astype(np.int32), 4),
    }


PARTS = _parts()


@pytest.mark.parametrize("name", sorted(PARTS))
def test_block_placement_is_the_reference_exactly(name):
    part, k = PARTS[name]
    ref = jmapping.block_placement(part, k)
    got = tmapping.block_placement(part, k)
    _assert_placement_equal(ref, got)
    assert got.block % 8 == 0 and got.n_pad == got.block * k
    # each bin's vertices sit in its own block, in vertex order
    assert np.all(got.bin_of_row[got.perm] == part)


def test_an_empty_bin_is_all_padding():
    part, k = PARTS["skewed_k6_empty_bin"]
    pl = tmapping.block_placement(part, k)
    assert pl.fill[5] == 0
    assert np.all(pl.inverse[5 * pl.block:6 * pl.block] == part.shape[0])


@pytest.mark.parametrize("name", ["uniform_k8", "skewed_k6_empty_bin"])
def test_apply_placement_is_the_reference_exactly(name):
    part, k = PARTS[name]
    n = part.shape[0]
    jg = jgen.rmat(n, 4 * n, seed=1)
    tg = tgen.rmat(n, 4 * n, seed=1)
    ref = jmapping.apply_placement(jg, jmapping.block_placement(part, k))
    got = tmapping.apply_placement(tg, tmapping.block_placement(part, k))
    _assert_graph_equal(ref, got)


def test_placement_of_a_partition_and_its_bsr_layout():
    """The bsr_locality setup at a small size: the port's partition, placed
    by both packages, gives the same graph and the same BSR layout."""
    g = tgen.rmat(1024, 8192, seed=3)
    topo = balanced_tree((4, 8))
    res = partition(g, topo, PartitionConfig(seed=0), device="cpu")
    ref = jmapping.apply_placement(jgen.rmat(1024, 8192, seed=3),
                                   jmapping.block_placement(res.part, topo.k))
    got = tmapping.apply_placement(g, tmapping.block_placement(res.part,
                                                               topo.k))
    _assert_graph_equal(ref, got)
    a = jbsr.to_bsr(ref.n_nodes, ref.senders, ref.receivers, ref.edge_weight)
    b = tbsr.to_bsr(got.n_nodes, got.senders, got.receivers, got.edge_weight)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3] == got.n_nodes // 128 + (got.n_nodes % 128 > 0)


# ---------------------------------------------------------------------------
# The mesh-mapping search, on the reference tests' inputs
# (tests/test_mapping_e2e.py, tests/test_machine.py,
# tests/test_mapping_and_data.py)
# ---------------------------------------------------------------------------

from repro.core import machine as jmachine  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.machine import MachineSpec  # noqa: E402

CPU = dict(device="cpu")


def _sym_traffic(d, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.uniform(0, 1, (d, d))
    T = np.triu(T, 1)
    return T + T.T


def _two_level():
    return jtopo.balanced_tree((2, 8), level_cost=(8.0, 1.0))


def _bottleneck64(T, topo, d2b):
    """The exact (float64) bottleneck of a device->bin permutation."""
    W = np.zeros_like(T, dtype=np.float64)
    W[np.ix_(d2b, d2b)] = T
    if isinstance(topo, jtopo.RoutingTopology):
        loads = 0.5 * np.einsum("ij,ijl->l", W,
                                topo.path_incidence.astype(np.float64))
    else:
        S = topo.subtree.astype(np.float64)
        loads = 0.5 * (S @ W.sum(1) + S @ W.sum(0)
                       - 2.0 * ((S @ W) * S).sum(1))
    return float((topo.F_l * loads).max())


def _assert_same_mapping(got, want, T, topo, cands):
    """The reference's winner, or a candidate tied with it exactly.

    Many candidates tie in exact arithmetic (a reordering inside a leaf
    block moves no load), and the two packages' float32 canonical scorers
    round such ties apart in the last bits, each its own way: the first
    minimum is then the first in rounding, not in exact value. So where
    the reference's winner is the only candidate of ``cands`` at its
    float64 bottleneck (rel 1e-12), the port must return the same one;
    where others tie with it, the port's must be one of them and score
    within float32 rounding (rel 1e-6) in the reference's own scorer.
    Returns "same" or "tied"."""
    assert got.n_candidates == want.n_candidates
    np.testing.assert_allclose(got.bottleneck, want.bottleneck, rtol=1e-5)
    if (np.array_equal(got.device_to_bin, want.device_to_bin)
            and got.axis_perm == want.axis_perm):
        assert got.axis_orders == want.axis_orders
        return "same"
    best = _bottleneck64(T, topo, want.device_to_bin)
    ties = sum(abs(_bottleneck64(T, topo, c) - best) <= 1e-12 * best
               for c in cands)
    assert ties > 1, "the reference's winner is unique; the port's differs"
    np.testing.assert_allclose(_bottleneck64(T, topo, got.device_to_bin),
                               best, rtol=1e-12)
    np.testing.assert_allclose(
        jmapping.makespan_of_device_map(T, topo, got.device_to_bin),
        want.bottleneck, rtol=1e-6)
    return "tied"


def test_traffic_matrix_and_axis_orders_are_the_reference_exactly():
    for shape, ab in (((4, 4), {0: 100.0, 1: 50.0}),
                      ((2, 4, 4), {0: 7e3, 1: 5e2, 2: 11.0}),
                      ((2, 16), {0: 1e3, 1: 0.0})):
        np.testing.assert_array_equal(
            tmapping.collective_traffic_matrix(shape, ab),
            jmapping.collective_traffic_matrix(shape, ab))
    for size in range(1, 17):
        for a, b in zip(tmapping._axis_orders(size),
                        jmapping._axis_orders(size), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,n_random", [((4,), 0), ((2, 8), 0),
                                            ((2, 3, 4), 0), ((2, 8), 5),
                                            ((2, 16, 16), 3)])
def test_enumerate_candidates_row_for_row(shape, n_random):
    got, gmeta = tmapping.enumerate_candidates(shape, n_random=n_random,
                                               seed=3)
    want, wmeta = jmapping.enumerate_candidates(shape, n_random=n_random,
                                                seed=3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert gmeta == wmeta
    np.testing.assert_array_equal(got[0], np.arange(got.shape[1]))


def test_score_device_maps_matches_looped_scorer_and_reference():
    topo = _two_level()
    ttopo = interop.topology_from_arrays(topo)
    T = tmapping.collective_traffic_matrix((4, 4), {0: 100.0, 1: 7.0})
    cands, _ = tmapping.enumerate_candidates((4, 4), n_random=8, seed=0)
    batched = tmapping.score_device_maps(T, ttopo, cands, chunk=16, **CPU)
    looped = np.asarray([tmapping.makespan_of_device_map(T, ttopo, c, **CPU)
                         for c in cands])
    np.testing.assert_allclose(batched, looped, rtol=1e-4,
                               atol=1e-5 * float(looped.max()))
    want = jmapping.score_device_maps(T, topo, cands, chunk=16)
    np.testing.assert_allclose(batched, want, rtol=1e-5,
                               atol=1e-6 * float(want.max()))
    # a chunk that does not divide the candidates pads its tail
    np.testing.assert_array_equal(
        tmapping.score_device_maps(T, ttopo, cands, chunk=7, **CPU),
        tmapping.score_device_maps(T, ttopo, cands, chunk=7, **CPU))
    np.testing.assert_allclose(
        tmapping.score_device_maps(T, ttopo, cands, chunk=7, **CPU), batched,
        rtol=1e-6)


def test_device_map_scores_match_reference():
    topo = jtopo.production_tree(2, 2, 2)
    ttopo = interop.topology_from_arrays(topo)
    T = jmapping.collective_traffic_matrix((2, 4), {0: 100.0, 1: 3.0})
    for d2b in (np.arange(8), np.random.default_rng(1).permutation(8)):
        np.testing.assert_allclose(
            tmapping.link_loads_of_device_map(T, ttopo, d2b, **CPU),
            jmapping.link_loads_of_device_map(T, topo, d2b), rtol=1e-5,
            atol=1e-4)
        np.testing.assert_allclose(
            tmapping.makespan_of_device_map(T, ttopo, d2b, **CPU),
            jmapping.makespan_of_device_map(T, topo, d2b), rtol=1e-5)
    spec = jmachine.MachineSpec.preset("tpu-mixed-32")
    tspec = MachineSpec.preset("tpu-mixed-32")
    Tm = _sym_traffic(32, seed=4)
    for work in (0.0, 1.0, 1e4):
        np.testing.assert_allclose(
            tmapping.capacity_makespan(Tm, tspec.tree(), np.arange(32),
                                       shard_work=work, **CPU),
            jmapping.capacity_makespan(Tm, spec.tree(), np.arange(32),
                                       shard_work=work), rtol=1e-5)


def _random_traffic(d, seed, density=0.3):
    """tests/test_device_vcycle.py's traffic: normalised to O(1) link loads
    so that atol 1e-5 means something in float32."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(0, 4, (d, d)) * (rng.uniform(0, 1, (d, d)) > 1 - density)
    T = np.triu(T, 1)
    T = T + T.T
    return T / max(T.sum(), 1.0)


@pytest.mark.parametrize("multipath", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_routing_scorer_matches_dense_oracle(multipath, seed):
    """The reference's inputs (tests/test_device_vcycle.py): the torus-2d
    preset, or its 8 x 8 torus with multipath routes."""
    if multipath:
        topo = jtopo.torus2d_topology(8, 8, multipath=True)
        ttopo = interop.topology_from_arrays(topo)
    else:
        topo = jmachine.MachineSpec.preset("torus-2d").topology()
        ttopo = MachineSpec.preset("torus-2d").topology()
    d = topo.k
    rng = np.random.default_rng(seed)
    T = _random_traffic(d, seed)
    cands = np.stack([rng.permutation(d) for _ in range(5)] + [np.arange(d)])
    sparse = tmapping._routing_loads_batch(T, ttopo, cands, **CPU)
    dense = tmapping._routing_loads_dense(T, ttopo, cands, **CPU)
    np.testing.assert_allclose(sparse, dense, atol=1e-5)
    np.testing.assert_allclose(
        sparse, jmapping._routing_loads_batch(T, topo, cands), atol=1e-5)
    np.testing.assert_allclose(
        dense, jmapping._routing_loads_dense(T, topo, cands), atol=1e-5)


def test_routing_scores_match_the_dense_oracle_per_candidate():
    """tests/test_machine.py: the batched routing scores against the dense
    incidence per candidate."""
    topo = jtopo.torus2d_topology(3, 3)
    ttopo = interop.topology_from_arrays(topo)
    d = topo.k
    T = _sym_traffic(d, seed=2)
    rng = np.random.default_rng(2)
    cands = np.stack([np.arange(d)] + [rng.permutation(d) for _ in range(4)])
    got = tmapping.score_device_maps(T, ttopo, cands, **CPU)
    for c, g in zip(cands, got):
        W = np.zeros_like(T)
        W[np.ix_(c, c)] = T
        loads = 0.5 * np.einsum("ij,ijl->l", W, topo.path_incidence)
        np.testing.assert_allclose(g, float((topo.F_l * loads).max()),
                                   rtol=1e-4, atol=1e-5)


def _search_cases():
    rng = np.random.default_rng(0)
    cases = []
    for trial in range(3):     # test_searched_makespan_never_worse_...
        T = rng.uniform(0, 1, (16, 16))
        T = np.triu(T, 1)
        cases.append((f"random_{trial}", (4, 4), T + T.T, _two_level, {}))
    cases.append(("heavy_inner", (2, 8), jmapping.collective_traffic_matrix(
        (2, 8), {0: 1.0, 1: 1e3}), _two_level, {}))
    cases.append(("heavy_outer", (8, 2), jmapping.collective_traffic_matrix(
        (8, 2), {0: 1e3, 1: 1.0}), _two_level, {}))
    rng = np.random.default_rng(7)          # test_widened_search_monotone
    T = rng.uniform(0, 1, (16, 16))
    T = np.triu(T, 1)
    cases.append(("widened", (4, 4), T + T.T, _two_level,
                  dict(n_random=24, recursive=True)))
    cases.append(("pods_4x4", (4, 4), jmapping.collective_traffic_matrix(
        (4, 4), {0: 1e9, 1: 1e6}), lambda: jtopo.production_tree(2, 2, 4),
        {}))
    cases.append(("mesh_2x4x4", (2, 4, 4), jmapping.collective_traffic_matrix(
        (2, 4, 4), {0: 1e3, 1: 1e2, 2: 1e1}),
        lambda: jtopo.mesh_tree((2, 4, 4)), dict(recursive=True)))
    return cases


SEARCH_CASES = _search_cases()


@pytest.mark.parametrize("name,shape,T,mk_topo,kw", SEARCH_CASES,
                         ids=[c[0] for c in SEARCH_CASES])
def test_search_mesh_mapping_picks_the_reference_winner(name, shape, T,
                                                        mk_topo, kw):
    topo = mk_topo()
    want = jmapping.search_mesh_mapping(shape, {}, topo, traffic=T, **kw)
    got = tmapping.search_mesh_mapping(shape, {},
                                       interop.topology_from_arrays(topo),
                                       traffic=T, **kw, **CPU)
    cands, _ = jmapping.enumerate_candidates(
        shape, n_random=kw.get("n_random", 0))
    _assert_same_mapping(got, want, T, topo, cands)
    ident = tmapping.makespan_of_device_map(
        T, interop.topology_from_arrays(topo), np.arange(T.shape[0]), **CPU)
    assert got.bottleneck <= ident


@pytest.mark.parametrize("name", ["gpu-superpod", "torus-2d",
                                  "tpu-mixed-32", "tpu_v5e-256"])
def test_search_on_preset_picks_the_reference_winner(name):
    spec = jmachine.MachineSpec.preset(name)
    tspec = MachineSpec.preset(name)
    d = spec.n_devices
    T = _sym_traffic(d, seed=1)
    kw = dict(n_random=4) if d <= 64 else dict(max_axis_perms=1)
    want = jmapping.search(spec.mesh_shape, None, T, machine=spec, **kw)
    got = tmapping.search(tspec.mesh_shape, None, T, machine=tspec, **kw,
                          **CPU)
    cands, _ = jmapping.enumerate_candidates(
        spec.mesh_shape, kw.get("max_axis_perms"), kw.get("n_random", 0))
    _assert_same_mapping(got, want, T, spec.topology(), cands)
    topo = tspec.topology()
    ident = tmapping.makespan_of_device_map(T, topo, np.arange(d), **CPU)
    assert got.bottleneck <= ident
    assert (tmapping.capacity_makespan(T, topo, got.device_to_bin,
                                       shard_work=1.0, **CPU)
            <= tmapping.capacity_makespan(T, topo, np.arange(d),
                                          shard_work=1.0, **CPU))


def test_search_with_warm_starts_picks_the_reference_winner():
    topo = _two_level()
    ttopo = interop.topology_from_arrays(topo)
    T = _sym_traffic(16, seed=9)
    first = tmapping.search((4, 4), ttopo, T, n_random=8, **CPU)
    rng = np.random.default_rng(9)
    warm = [first.device_to_bin, rng.permutation(16)]
    want = jmapping.search((4, 4), topo, T, warm_starts=warm)
    got = tmapping.search((4, 4), ttopo, T, warm_starts=warm, **CPU)
    cands, _ = jmapping.enumerate_candidates((4, 4))
    _assert_same_mapping(got, want, T, topo, np.concatenate([cands, warm]))
    assert got.bottleneck <= first.bottleneck
    with pytest.raises(ValueError, match="permutations"):
        tmapping.search((4, 4), ttopo, T, warm_starts=[np.zeros(16)], **CPU)
    with pytest.raises(ValueError, match="topology"):
        tmapping.search((4,), None, np.zeros((4, 4)), **CPU)


def test_search_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T = tmapping.collective_traffic_matrix((2, 4), {0: 1.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmapping.search_mesh_mapping((2, 4), {0: 1.0},
                                     balanced_tree((2, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmapping.makespan_of_device_map(T, balanced_tree((2, 4)),
                                        np.arange(8))


def test_expert_placement_within_the_reference_band():
    """tests/test_mapping_and_data.py's clique case: both packages place
    the two co-activation cliques on separate pods; the port's makespan is
    below random and within 1.05x of the reference's."""
    from repro.core import baselines as jbaselines
    from repro_torch.core import baselines as tbaselines
    from repro_torch.graph.graph import from_edges
    rng = np.random.default_rng(0)
    e = 32
    traffic = rng.uniform(0, 1, (e, e))
    traffic = traffic + traffic.T
    traffic[:16, :16] += 10
    traffic[16:, 16:] += 10
    flops = np.ones(e)
    topo = jtopo.balanced_tree((2, 2, 8), level_cost=(8.0, 1.0, 1.0))
    ttopo = interop.topology_from_arrays(topo)
    _, jres = jmapping.expert_placement(traffic, flops, topo)
    part, res = tmapping.expert_placement(traffic, flops, ttopo, **CPU)
    iu = np.triu_indices(e, 1)
    g = from_edges(e, iu[0], iu[1], traffic[iu].astype(np.float32),
                   flops.astype(np.float32))
    ours = tbaselines.score_all(g, ttopo, part, **CPU)["makespan"]
    rand = tbaselines.score_all(
        g, ttopo, jbaselines.random_partition(e, topo.k, seed=0),
        **CPU)["makespan"]
    assert ours < rand
    assert res.makespan <= 1.05 * jres.makespan
    pods = part // 8
    assert len(set(pods[:16])) == 1 and len(set(pods[16:])) == 1
    assert pods[0] != pods[16]
