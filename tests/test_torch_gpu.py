"""Card tests: every CUDA kernel of the port against its plain PyTorch
version over a sweep of shapes, the wrappers' argument checks, and one
small ``partition()`` per backend through the oracle. Marked ``gpu``; each
test decides in the ``cuda`` fixture whether a card is present and skips
without one. Imports no JAX (the card's machine has none). Run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.machine import MachineSpec
from repro_torch.core.partitioner import PartitionConfig, partition, verify
from repro_torch.core.reference import total_cut_ref
from repro_torch.core.topology import balanced_tree, production_tree
from repro_torch.graph.generators import rmat
from repro_torch.graph.graph import from_edges
from repro_torch.kernels import (bucket_assign, match_keys, ops,
                                 partition_gain, quotient_link_loads)

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(cuda, seed):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("m", [1, 127, 1000, 1_000_003])
def test_match_keys_kernel_equals_plain(cuda, m):
    gen = _gen(cuda, m)
    w = torch.rand(m, generator=gen, device=cuda)
    u = torch.rand(m, generator=gen, device=cuda)
    mask = (torch.rand(m, generator=gen, device=cuda) > 0.4).float()
    before = match_keys.launches
    got = match_keys.match_keys(w, u, mask)
    assert match_keys.launches == before + 1
    assert torch.equal(got, match_keys.plain(w, u, mask))


@pytest.mark.parametrize("n,k", [(1, 2), (700, 3), (4096, 64), (5000, 257),
                                 (20_000, 1024)])
def test_bucket_assign_kernel_equals_plain(cuda, n, k):
    gen = _gen(cuda, n + k)
    nw = torch.rand(n, generator=gen, device=cuda) + 0.1
    cum = torch.cumsum(nw, 0) - 0.5 * nw
    bounds = (torch.arange(1, k, device=cuda, dtype=torch.float64) / k
              * float(nw.sum())).float()
    got = bucket_assign.bucket_assign(cum, bounds, k)
    assert got.dtype == torch.int32
    assert torch.equal(got, bucket_assign.plain(cum, bounds, k))
    assert torch.equal(got.long(), torch.searchsorted(bounds, cum,
                                                      right=True))


@pytest.mark.parametrize("topo_fn", [
    lambda: balanced_tree((2, 2)), lambda: balanced_tree((4, 4)),
    lambda: MachineSpec.preset("gpu-superpod").tree(),
    lambda: balanced_tree((2, 8, 8)), lambda: production_tree(2, 16, 16)],
    ids=["k4", "k16", "superpod_k64", "k128_global", "k512_global"])
@pytest.mark.parametrize("m_edges", [500, 200_000])
def test_quotient_link_loads_kernel_matches_plain(cuda, topo_fn, m_edges):
    topo = topo_fn()
    g = rmat(max(m_edges // 4, 64), m_edges, seed=topo.k)
    gen = _gen(cuda, topo.k)
    part = torch.randint(0, topo.k, (g.n_nodes,), generator=gen, device=cuda,
                         dtype=torch.int32)
    s = torch.as_tensor(g.senders, device=cuda)
    r = torch.as_tensor(g.receivers, device=cuda)
    w = torch.rand(g.n_arcs, generator=gen, device=cuda) + 0.1
    S = torch.as_tensor(topo.subtree, device=cuda)
    F = torch.as_tensor(topo.F_l, device=cuda)
    got, W = quotient_link_loads.loads_and_quotient(part, s, r, w, S, F,
                                                    topo.k)
    want = quotient_link_loads.plain(part, s, r, w, S, F, topo.k)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(
        W, quotient_link_loads.quotient_matrix(part, s, r, w, topo.k),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,m,k", [(1, 0, 2), (50, 150, 4), (2000, 8000, 8),
                                   (1001, 5003, 8), (3000, 12000, 64),
                                   (300, 2000, 512)])
def test_partition_gain_kernel_matches_plain(cuda, n, m, k):
    rng = np.random.default_rng(n + k)
    g = from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m),
                   rng.random(m).astype(np.float32) + 0.1)
    idx, ew = ops.to_ell(n, g.senders, g.receivers, g.edge_weight)
    nbr_idx = torch.as_tensor(idx, device=cuda)
    nbr_w = torch.as_tensor(ew, device=cuda)
    part = torch.as_tensor(rng.integers(0, k, n).astype(np.int32),
                           device=cuda)
    got = partition_gain.partition_gain(part, nbr_idx, nbr_w, k)
    want = partition_gain.plain(part, nbr_idx, nbr_w, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_check_their_arguments(cuda):
    x = torch.rand(64, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        match_keys.match_keys(x, x, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.rand(64, 2, device=cuda)[:, 0]
        match_keys.match_keys(y, y, y)
    with pytest.raises(ValueError, match="shape"):
        match_keys.match_keys(x, x[:10], x)
    with pytest.raises(ValueError, match="on cpu"):
        bucket_assign.bucket_assign(x, torch.rand(3), 4)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_small_partition_on_the_card_passes_the_oracle(cuda, backend):
    rng = np.random.default_rng(0)
    n, m = 600, 2400
    g = from_edges(n, rng.integers(0, n, m), rng.integers(0, n, m),
                   rng.random(m).astype(np.float32) + 0.1,
                   rng.random(n).astype(np.float32) + 0.5)
    topo = balanced_tree((2, 4))
    ops.reset_launch_counts()
    res = partition(g, topo, PartitionConfig(seed=0, backend=backend),
                    device=cuda)
    verify(g, topo, res)
    assert res.total_cut == pytest.approx(total_cut_ref(res.part, g),
                                          rel=1e-5)
    counts = ops.launch_counts()
    assert counts["quotient_link_loads"] > 0 and counts["partition_gain"] > 0
    if backend == "device":
        assert counts["match_keys"] > 0 and counts["bucket_assign"] == 1
