"""Card tests: every CUDA kernel of the port against its plain PyTorch
version over a sweep of shapes, the wrappers' argument checks, one small
``partition()`` per backend through the oracle, and the smoke-width LM
(prefill through ``flash_attention``, the serving engine) against its CPU
run, and the GNN training path (the BSR aggregation's transposed-layout
backward, GIN through the kernel against its plain path, PNA and
MeshGraphNet steps against the CPU). Marked ``gpu``; each
test decides in the ``cuda`` fixture whether a card is present and skips
without one. Imports no JAX (the card's machine has none). Run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.machine import MachineSpec
from repro_torch.core.partitioner import PartitionConfig, partition, verify
from repro_torch.core.reference import total_cut_ref
from repro_torch.core.topology import (balanced_tree, guess_tree,
                                       production_tree)
from repro_torch.graph.generators import grid3d, rmat
from repro_torch.graph.graph import from_edges
from repro_torch.configs import gin_tu
from repro_torch.configs.two_tower_retrieval import SMOKE, smoke_batch
from repro_torch.data.pipeline import molecule_batches
from repro_torch.embed import ShardedEmbeddingTable, identity_plan
from repro_torch.embed.sharded_table import ShardPlan
from repro_torch.graph.generators import molecule_batch
from repro_torch.kernels import (bag_combine, bsr_spmm, bucket_assign,
                                 flash_attention, gather_combine, match_keys,
                                 ops, partition_gain, quotient_link_loads)
from repro_torch.configs import (deepseek_v2_236b, deepseek_v2_lite_16b,
                                 qwen2_1_5b)
from repro_torch.models import common as mcommon
from repro_torch.models import transformer as tr
from repro_torch import tree
from repro_torch.configs import meshgraphnet, pna
from repro_torch.data.pipeline import gnn_features, minibatch_batches
from repro_torch.models import gnn
from repro_torch.models.gnn import GIN, gin_layout, gin_layouts
from repro_torch.train.steps import loss_and_grads
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.models.recsys import TwoTower

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402  (the smoke run's)
    TRAIN_LSE_TOL, NumpyDraws, _traced, asymmetric_batch, flash_bf16_judge,
    flash_grad_judge, gapped_graph)

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


def _split_inputs(cuda, n, k, seed, integer=True):
    gen = _gen(cuda, seed)
    nw = (torch.randint(1, 5, (n,), generator=gen, device=cuda).float()
          if integer else torch.rand(n, generator=gen, device=cuda) + 0.1)
    total = float(nw.double().sum())
    b = (np.cumsum(np.ones(k))[:-1] / k * total).astype(np.float32)
    return nw, torch.as_tensor(b, device=cuda)


@pytest.mark.parametrize("k", [1, 2, 64, 512])
@pytest.mark.parametrize("n", [0, 1, 1023, 12_400, 1_000_000])
def test_prefix_split_is_bitwise_the_plain_split(cuda, n, k):
    """Integer weights (every sum exact in any order): the kernel's bins
    equal the plain version's bitwise, two calls agree, one launch."""
    nw, bounds = _split_inputs(cuda, n, k, n + k)
    before = bucket_assign.split_launches
    got = bucket_assign.prefix_split(nw, bounds, k)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert bucket_assign.split_launches == before + (1 if n else 0)
    assert torch.equal(got, bucket_assign.prefix_split_plain(nw, bounds, k))
    assert torch.equal(got, bucket_assign.prefix_split(nw, bounds, k))
    if n:
        assert int(got.min()) >= 0 and int(got.max()) <= k - 1
        assert bool((got[1:] >= got[:-1]).all())


@pytest.mark.parametrize("n,k", [(12_400, 64), (1_000_000, 512),
                                 (40_000, 7)])
def test_prefix_split_float_weights_deterministic_and_banded(cuda, n, k):
    """Float weights: two calls bitwise equal; a bin differs from the plain
    version's only where the float64 midpoint lies within 2^-18 of the
    total of a boundary (the two float32 scans round apart)."""
    nw, bounds = _split_inputs(cuda, n, k, 7, integer=False)
    got = bucket_assign.prefix_split(nw, bounds, k)
    assert torch.equal(got, bucket_assign.prefix_split(nw, bounds, k))
    want = bucket_assign.prefix_split_plain(nw, bounds, k)
    cum = torch.cumsum(nw.double(), 0) - 0.5 * nw.double()
    near = ((cum[:, None] - bounds.double()[None, :]).abs()
            <= 2.0 ** -18 * float(cum[-1])).any(1)
    assert bool(((got == want) | near).all())


def test_prefix_split_refuses_unsorted_boundaries(cuda):
    nw, bounds = _split_inputs(cuda, 5000, 16, 3)
    before = bucket_assign.split_launches
    with pytest.raises(ValueError, match="non-decreasing"):
        bucket_assign.prefix_split(nw, bounds.flip(0), 16)
    with pytest.raises(ValueError, match="non-decreasing"):
        bucket_assign.prefix_split_host(nw.cpu().numpy(),
                                        bounds.flip(0).cpu().numpy(), 16,
                                        cuda)
    assert bucket_assign.split_launches == before


def test_prefix_split_paths(cuda):
    """One block up to one tile of vertices, a cooperative grid beyond."""
    tile = bucket_assign.SPLIT_TILE
    assert bucket_assign.split_blocks(tile, 63, cuda) == 1
    assert bucket_assign.split_blocks(tile + 1, 63, cuda) == 2
    assert bucket_assign.split_blocks(1_000_000, 63, cuda) == -(
        -1_000_000 // tile)


def test_initial_partition_device_is_one_kernel_between_two_copies(cuda):
    """The device initial partition: the weights and boundaries in one
    copy, ``prefix_split``, the bins back; nothing else on the card."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _device_work, _initial_before
    from repro_torch.core.initial import initial_partition_device
    g = grid3d(24, 24, 24)
    topo = MachineSpec.preset("gpu-superpod").tree()
    want = initial_partition_device(g, topo, device="cpu")
    got = initial_partition_device(g, topo, device=cuda)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _initial_before(g, topo, cuda))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        initial_partition_device(g, topo, device=cuda)
        torch.cuda.synchronize()
    events = [e.name for e in sorted(
        (e for e in prof.events() if _device_work(e)),
        key=lambda e: e.time_range.start)]
    assert len(events) == 3, events
    assert "HtoD" in events[0] and "DtoH" in events[2]
    assert "prefix_split" in events[1]


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


QLL_TOPOS = {4: lambda: guess_tree(4), 8: lambda: balanced_tree((2, 4)),
             64: lambda: MachineSpec.preset("gpu-superpod").tree(),
             128: lambda: balanced_tree((2, 8, 8)),
             512: lambda: production_tree(2, 16, 16)}


def _qll_case(cuda, k, m_edges, local, seed, n_links=None):
    """A CSR-ordered arc list of about 2 * m_edges arcs on k bins: local
    (receivers a few ids from their senders, part = arange(n) * k // n, so
    neighbouring arcs share their bin pair) or random (random endpoints and
    bins). ``n_links`` cuts the topology's links (0: none).

    Local lists carry integer weights (1-4, as the path's coarsened grids
    do): a subtree's comm is then a small difference of large sums (S r +
    S c - 2 diag(S W S^T)), which float weights leave to float32 rounding
    in the plain version too (1.6x the band against float64 at k = 512),
    while integer sums are exact in any order."""
    topo = QLL_TOPOS[k]()
    rng = np.random.default_rng(seed)
    n = max(m_edges // 3, 2 * k, 2)
    u = rng.integers(0, n, m_edges)
    if local:
        v = (u + rng.integers(1, 9, m_edges)) % n
        w = rng.integers(1, 5, m_edges).astype(np.float32)
    else:
        v = rng.integers(0, n, m_edges)
        w = rng.random(m_edges).astype(np.float32) + 0.1
    g = from_edges(n, u, v, w, dedup=False)
    part = (np.arange(n) * k // n if local
            else rng.integers(0, k, n)).astype(np.int32)
    links = topo.n_links if n_links is None else n_links
    return (torch.as_tensor(part, device=cuda),
            torch.as_tensor(g.senders, device=cuda),
            torch.as_tensor(g.receivers, device=cuda),
            torch.as_tensor(g.edge_weight, device=cuda),
            torch.as_tensor(topo.subtree[:links], device=cuda),
            torch.as_tensor(topo.F_l[:links], device=cuda), k)


# (k, edges, local, links): one block and a grid, each block's W in shared
# memory (k <= 128) or not, warps with one link chunk and with several,
# both inputs, no arcs, no links, in an order that switches k and launch
# from call to call
QLL_SEQUENCE = [(4, 2_135, True, None), (64, 100_000, True, None),
                (4, 0, False, None), (8, 4_000, False, None),
                (512, 50_000, False, None), (64, 100_000, False, None),
                (128, 30_000, True, None), (8, 4_097, True, None),
                (64, 700_000, True, 0), (512, 0, False, None),
                (4, 2_135, False, 0), (64, 0, True, None),
                (128, 30_000, False, None), (512, 50_000, True, None),
                (64, 100_000, True, None), (4, 2_135, True, None),
                (8, 20_000, True, None), (64, 2_000, True, None),
                (128, 5_000, False, None), (64, 2_000, False, None)]


def test_quotient_link_loads_interleaved_calls_match_plain(cuda):
    """Calls that change m, k and the launch (one block, a grid) each find
    their half of the per-k workspace zeroed by the call before: each call
    matches the plain version."""
    grids = set()
    for i, (k, edges, local, links) in enumerate(QLL_SEQUENCE):
        args = _qll_case(cuda, k, edges, local, seed=i, n_links=links)
        path = quotient_link_loads.qll_path(
            args[1].shape[0], k,
            torch.cuda.get_device_properties(cuda).multi_processor_count)
        grids.add((path.blocks > 1, path.smem > 0))
        got, W = quotient_link_loads.loads_and_quotient(*args)
        want, W_want = quotient_link_loads._plain_with_quotient(*args)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3,
                                   msg=f"call {i}: {(k, edges, local)}")
        torch.testing.assert_close(W, W_want, rtol=1e-4, atol=1e-3,
                                   msg=f"call {i}: W")
    assert grids == {(False, True), (True, True), (False, False),
                     (True, False)}


@pytest.mark.parametrize("k,edges", [(4, 2_135), (8, 4_000), (64, 2_000),
                                     (64, 100_000), (512, 50_000)])
def test_quotient_link_loads_is_one_device_kernel(cuda, k, edges):
    """One call is one device event, the kernel: nothing fills W or the
    workspace before it (a trace of 5 calls after an untraced warm-up)."""
    args = _qll_case(cuda, k, edges, True, seed=k)
    trace = _traced(lambda: [quotient_link_loads.quotient_link_loads(*args)
                             for _ in range(5)],
                    {"qll_": ("quotient_link_loads",)})
    assert trace["port_launches"]["qll_"] == dict(counted=5, traced=5)
    names = [name for name, _, _ in trace["top_device"]]
    assert len(names) == 1 and "qll_" in names[0], names


def _in_order_conn(part, nbr_idx, nbr_w, k):
    """conn by np.add.at: every row's slots summed in slot order in float32
    from +0, padding (ids >= n) and bins outside [0, k) skipped."""
    n = part.shape[0]
    conn = np.zeros((n, k), np.float32)
    rows = np.repeat(np.arange(n), nbr_idx.shape[1]).reshape(nbr_idx.shape)
    real = nbr_idx < n
    bins = part[nbr_idx[real]]
    keep = (bins >= 0) & (bins < k)
    np.add.at(conn, (rows[real][keep], bins[keep]), nbr_w[real][keep])
    return conn


# (n, edges, k, hub degree): ragged n, hub rows (D >= 64), k from 2 to
# 512, both sides of one row per SM and of MAX_ROWS, slots in chunks
PG_BITWISE = [(1, 0, 2, 0), (50, 150, 4, 0), (48, 200, 4, 0),
              (1280, 2135, 4, 0), (2000, 8000, 8, 0), (1001, 5003, 8, 0),
              (3000, 12000, 64, 80), (300, 2000, 512, 0), (132, 500, 2, 0),
              (133, 500, 2, 0), (8448, 30000, 8, 0), (8449, 30000, 8, 120),
              (9000, 20000, 4, 200)]


@pytest.mark.parametrize("n,edges,k,hub", PG_BITWISE)
def test_partition_gain_kernel_is_the_in_order_sum(cuda, n, edges, k, hub):
    rng = np.random.default_rng(n + k + hub)
    u = np.concatenate([rng.integers(0, n, edges), np.zeros(hub, np.int64)])
    v = np.concatenate([rng.integers(0, n, edges), np.arange(1, hub + 1)])
    w = rng.random(u.size).astype(np.float32) + 0.1
    g = from_edges(n, u, v, w)
    idx, ew = ops.to_ell(n, g.senders, g.receivers, g.edge_weight)
    part = rng.integers(0, k, n).astype(np.int32)
    assert hub < 64 or idx.shape[1] >= 64
    got = partition_gain.partition_gain(
        torch.as_tensor(part, device=cuda), torch.as_tensor(idx, device=cuda),
        torch.as_tensor(ew, device=cuda), k)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _in_order_conn(part, idx, ew, k))


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
        # the coarsening runs each matching round as one fused launch
        assert counts["match_round"] > 0 and counts["prefix_split"] == 1
        assert counts["match_keys"] == 0 and counts["bucket_assign"] == 0


def _hub_graph(n=30_000, hub_arcs=12_000, extra=60_000, seed=0):
    """Vertex 0 joined to 12,000 others (a CSR row of >= 10,000 arcs), and
    random edges; integer weights, so keys tie where the jitter is 0."""
    rng = np.random.default_rng(seed)
    hub = rng.choice(np.arange(1, n), hub_arcs, replace=False)
    u = np.concatenate([np.zeros(hub_arcs, np.int64),
                        rng.integers(0, n, extra)])
    v = np.concatenate([hub, rng.integers(0, n, extra)])
    return from_edges(n, u, v, rng.integers(1, 4, u.size).astype(np.float32),
                      np.ones(n, np.float32))


MATCH_ROUND_GRAPHS = {
    "grid": lambda: grid3d(24, 24, 24),
    "rmat": lambda: rmat(20_000, 120_000, seed=1),
    "hub": _hub_graph,
}


def _round_args(cuda, g, jitter, matched_share, seed=0):
    gen = _gen(cuda, seed)
    s = torch.as_tensor(g.senders, device=cuda)
    r = torch.as_tensor(g.receivers, device=cuda)
    w = torch.as_tensor(g.edge_weight, device=cuda)
    u = (torch.rand(g.n_arcs, generator=gen, device=cuda) if jitter
         else torch.zeros(g.n_arcs, device=cuda))
    matched = torch.rand(g.n_nodes, generator=gen, device=cuda) < matched_share
    return s, r, w, u, matched


@pytest.mark.parametrize("name", sorted(MATCH_ROUND_GRAPHS))
@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "ties"])
@pytest.mark.parametrize("matched_share", [0.0, 0.4])
def test_match_round_is_bitwise_the_plain_round(cuda, name, jitter,
                                                matched_share):
    g = MATCH_ROUND_GRAPHS[name]()
    args = _round_args(cuda, g, jitter, matched_share)
    before = match_keys.round_launches
    got = match_keys.match_round(*args)
    assert match_keys.round_launches == before + 1
    want = match_keys.match_round_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if name == "hub":
        assert int(np.diff(g.offsets).max()) >= 10_000
    assert bool((got >= 0).any())


@pytest.mark.parametrize("case", ["all_matched", "zero_weights", "no_arcs"])
def test_match_round_with_no_live_arc_gives_minus_one(cuda, case):
    g = grid3d(10, 10, 10)
    s, r, w, u, matched = _round_args(cuda, g, True, 0.0)
    if case == "all_matched":
        matched = torch.ones_like(matched)
    elif case == "zero_weights":
        w = torch.zeros_like(w)
    else:
        s, r, w, u = (x[:0] for x in (s, r, w, u))
    got = match_keys.match_round(s, r, w, u, matched)
    assert torch.equal(got, torch.full_like(got, -1))
    assert torch.equal(got, match_keys.match_round_plain(s, r, w, u, matched))


def test_match_round_word_buffer_stays_zero_across_sizes(cuda):
    """Calls on a larger, a smaller and a larger graph again share one word
    buffer: each call must find it zero and leave it zero."""
    for g in (grid3d(20, 20, 20), rmat(500, 3000, seed=2),
              grid3d(24, 24, 24), rmat(500, 3000, seed=3)):
        args = _round_args(cuda, g, True, 0.2, seed=g.n_arcs)
        assert torch.equal(match_keys.match_round(*args),
                           match_keys.match_round_plain(*args))
    words = match_keys._words[torch.device("cuda",
                                           torch.cuda.current_device())]
    assert int(words[1:].count_nonzero()) == 0


def test_match_round_checks_its_arguments(cuda):
    s, r, w, u, matched = _round_args(cuda, grid3d(4, 4, 4), True, 0.0)
    with pytest.raises(TypeError, match="dtype"):
        match_keys.match_round(s.long(), r, w, u, matched)
    with pytest.raises(TypeError, match="dtype"):
        match_keys.match_round(s, r, w, u, matched.float())
    with pytest.raises(ValueError, match="shape"):
        match_keys.match_round(s, r, w[:5], u, matched)
    with pytest.raises(ValueError, match="on cpu"):
        match_keys.match_round(s, r, w, u.cpu(), matched)


def _bag_inputs(cuda, b, d, f, v, seed=0):
    gen = _gen(cuda, seed)
    table = torch.randn(v, f, generator=gen, device=cuda)
    idx = torch.randint(0, v, (b, d), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.rand(b, d, generator=gen, device=cuda)
    return table, idx, w


def _assert_bag_close(got, want, rows, w):
    """rtol 1e-6 plus the rounding bound of two D-term float32 sums taken
    in different orders (the kernel's slot order, einsum's blocked one)."""
    bound = bag_combine.order_tolerance(rows, w)
    err = (got.double() - want.double()).abs()
    assert bool((err <= 1e-6 * want.double().abs() + bound).all()), \
        float(err.max())


# the main path's shape, the ragged one, D = 1, F not a multiple of 4, more
# slots than one staged chunk (64), and more columns than one block (256)
BAG_SHAPES = [(512, 50, 256, 1_000_000), (37, 7, 96, 5000), (64, 1, 256, 99),
              (33, 9, 33, 700), (5, 3, 2, 10), (16, 130, 64, 2000),
              (9, 4, 1100, 300), (1, 0, 8, 4), (1, 50, 256, 1000),
              (7, 17, 64, 500), (3, 33, 128, 400),
              # grids of more than 65,536 threads: the shallow loop
              (1100, 20, 256, 3000), (2048, 13, 130, 4000)]
# grids too small to fill the card (the small-grid path): one, two and
# three bags, D around the 16 and 64 rows a thread keeps in flight
BAG_SMALL_SHAPES = [(b, d, 256, 1000) for b in (1, 2, 3)
                    for d in (1, 50, 64, 65)] + [(1, 16, 33, 100),
                                                 (2, 17, 96, 300)]
BAG_SHAPES += BAG_SMALL_SHAPES


def _bag_small_grid(b, f, vec, sms):
    """The bag launches' choice of the small-grid path: their plans' rule
    (``kernels/gather_combine.py``), which the launchers take as given."""
    return gather_combine.small_grid(b, f, vec, sms)


@pytest.mark.parametrize("b,f,vec,sms,small", [
    (1, 256, 4, 132, True),       # one retrieve query: 1 block of 64 x 2
    (2, 256, 4, 132, True),
    (262, 256, 4, 132, True),     # 131 blocks of 2 bags
    (263, 256, 4, 132, False),    # 132 blocks: the grid fills the card
    (512, 256, 4, 132, False),    # serve_p99: 256 blocks
    (262144, 256, 4, 132, False),  # serve_bulk
    (37, 96, 4, 132, True),       # the ragged shape: 10 blocks of 4 bags
    (37, 96, 1, 132, True),
    (1100, 256, 4, 132, False),
    (70000, 8, 1, 100000, False),  # more bags than the grid's y axis
    (1, 1100, 1, 2, False),       # 5 blocks across F on 2 multiprocessors
    (1, 1100, 1, 8, True)])
def test_bag_small_grid_choice(cuda, b, f, vec, sms, small):
    assert _bag_small_grid(b, f, vec, sms) is small


@pytest.mark.parametrize("b,d,f,v", BAG_SMALL_SHAPES)
def test_bag_kernels_on_small_grids_equal_the_in_order_sum(cuda, b, d, f, v):
    """Both kernels bitwise equal to the slots summed in order with each
    product and sum rounded on its own, and to ``embedding_bag``."""
    table, idx, w = _bag_inputs(cuda, b, d, f, v, seed=3 * b + d + f)
    assert _bag_small_grid(b, f, gather_combine.vec_width(table),
                           torch.cuda.get_device_properties(cuda)
                           .multi_processor_count)
    rows = table[idx]
    want = torch.zeros(b, f, device=cuda)
    for j in range(d):
        want = want + w[:, j:j + 1] * rows[:, j]
    fused = gather_combine.gather_combine(table, idx, w)
    pre = bag_combine.bag_combine(rows, w)
    assert torch.equal(fused, want)
    assert torch.equal(pre, want)
    assert torch.equal(ops.embedding_bag(table, idx, w), fused)


@pytest.mark.parametrize("b,d,f,v", BAG_SHAPES)
def test_bag_kernels_match_plain(cuda, b, d, f, v):
    table, idx, w = _bag_inputs(cuda, b, d, f, v, seed=b + d + f)
    rows = table[idx]
    before = ops.launch_counts()
    fused = gather_combine.gather_combine(table, idx, w)
    pre = bag_combine.bag_combine(rows, w)
    after = ops.launch_counts()
    assert after["gather_combine"] == before["gather_combine"] + 1
    assert after["bag_combine"] == before["bag_combine"] + 1
    torch.cuda.synchronize()
    assert fused.shape == pre.shape == (b, f)
    _assert_bag_close(fused, gather_combine.plain(table, idx, w), rows, w)
    _assert_bag_close(pre, bag_combine.plain(rows, w), rows, w)
    # one accumulation order for both kernels: bitwise equal
    assert torch.equal(fused, pre)


def test_bag_kernels_on_unaligned_rows(cuda):
    """A table starting 4 bytes into its storage takes the one-float path
    (no 16-byte loads) and still matches."""
    gen = _gen(cuda, 3)
    base = torch.randn(300 * 64 + 1, generator=gen, device=cuda)
    table = base[1:].view(300, 64)
    assert table.data_ptr() % 16 != 0
    idx = torch.randint(0, 300, (40, 6), generator=gen, device=cuda,
                        dtype=torch.int32)
    w = torch.rand(40, 6, generator=gen, device=cuda)
    got = gather_combine.gather_combine(table, idx, w)
    assert torch.equal(got, bag_combine.bag_combine(table[idx], w))
    _assert_bag_close(got, gather_combine.plain(table, idx, w), table[idx], w)


def test_bag_wrappers_check_their_arguments(cuda):
    table, idx, w = _bag_inputs(cuda, 4, 3, 8, 10)
    with pytest.raises(TypeError, match="dtype"):
        gather_combine.gather_combine(table.double(), idx, w)
    with pytest.raises(TypeError, match="dtype"):
        gather_combine.gather_combine(table, idx.long(), w)
    with pytest.raises(TypeError, match="dtype"):
        bag_combine.bag_combine(table[idx].half(), w)
    with pytest.raises(ValueError, match="on cpu"):
        gather_combine.gather_combine(table, idx, w.cpu())
    with pytest.raises(ValueError, match="shape"):
        gather_combine.gather_combine(table, idx, w[:, :2].contiguous())
    with pytest.raises(ValueError, match="shape"):
        bag_combine.bag_combine(table[idx], w[:3])
    with pytest.raises(ValueError, match=r"\[B, D, F\]"):
        bag_combine.bag_combine(table, w)
    with pytest.raises(ValueError, match="contiguous"):
        bag_combine.bag_combine(table[idx].transpose(0, 1), w.t())


@pytest.mark.parametrize("b", [512, 262_144, 1])
def test_bag_combine_bf16_within_its_band(cuda, b):
    """bf16 rows and weights at the recsys shapes (50 slots of 256): the
    kernel within ``bf16_combine_judge``'s band of the float32 plain sum
    rounded once and within the reference's 5e-2; both planted faults
    fail the band; bf16 out, one launch."""
    from chip_smoke import bf16_combine_judge
    gen = _gen(cuda, b)
    rows = (torch.randn(b, 50, 256, generator=gen, device=cuda)
            * 0.01).to(torch.bfloat16)
    w = (torch.rand(b, 50, generator=gen, device=cuda) / 50).to(
        torch.bfloat16)
    before = bag_combine.launches
    got = bag_combine.bag_combine(rows, w)
    assert bag_combine.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 256)
    ok, _, read = bf16_combine_judge(rows, w, got,
                                     bag_combine.plain(rows, w))
    assert ok, read


def test_bag_combine_float32_unchanged_by_the_bf16_path(cuda):
    """The float32 path: bitwise the in-order sum gather_combine gives."""
    table, idx, w = _bag_inputs(cuda, 64, 50, 256, 1000)
    assert torch.equal(bag_combine.bag_combine(table[idx], w),
                       gather_combine.gather_combine(table, idx, w))


def _dup_bag_inputs(cuda, b, d, f, v, dtype, seed=0, offset=0):
    """Bags whose ids repeat within a bag (every third slot names the bag's
    first row) and across bags (ids from a small table, and row 0 in a
    fifth of the slots, as padding puts it), on a table of ``dtype``
    starting ``offset`` elements into its storage (unaligned where the
    offset is not a multiple of 16 bytes)."""
    gen = _gen(cuda, seed)
    base = torch.randn(v * f + offset, generator=gen, device=cuda).to(dtype)
    table = base[offset:].view(v, f)
    idx = torch.randint(0, v, (b, d), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[:, ::3] = idx[:, :1]
    idx[torch.rand(b, d, generator=gen, device=cuda) < 0.2] = 0
    w = torch.rand(b, d, generator=gen, device=cuda)
    return table, idx, w


def _in_order_sum(table, idx, w):
    """Each bag's slots summed from slot 0 in order in float32, every
    product and sum rounded on its own, then rounded once to the table's
    dtype."""
    rows = table[idx].float()
    acc = torch.zeros(idx.shape[0], table.shape[1], device=table.device)
    for j in range(idx.shape[1]):
        acc = acc + w[:, j:j + 1] * rows[:, j]
    return acc.to(table.dtype)


# (bags, slots, F, rows, table offset) and the path each takes in float32
GATHER_PATH_CASES = [
    ((512, 50, 256, 300, 0), "rows"),         # serve_p99's shape
    ((2048, 13, 256, 400, 0), "wide_rows"),   # a grid that fills the card
    ((3000, 70, 512, 900, 0), "wide_rows"),   # two chunks of 64 slots
    ((5000, 9, 128, 90, 0), "wide_rows"),     # 16 threads a bag
    ((1, 50, 256, 64, 0), "small_grid"),      # one retrieve query
    ((600, 9, 33, 80, 0), "rows"),            # F not a multiple of 4
    ((600, 9, 64, 80, 1), "rows"),            # an unaligned table
    ((70_000, 5, 32, 80, 0), "rows"),         # rows too narrow for two
]                                             # columns a thread


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,path", GATHER_PATH_CASES,
                         ids=[p + str(c[:3]) for c, p in GATHER_PATH_CASES])
def test_gather_combine_paths_are_bitwise_the_in_order_sum(cuda, dtype, case,
                                                          path):
    """Every path, in float32 and bf16, with ids repeated within and across
    the bags a block holds: bitwise the in-order float32 sum rounded once
    to the table's dtype."""
    b, d, f, v, offset = case
    table, idx, w = _dup_bag_inputs(cuda, b, d, f, v, dtype, offset=offset)
    aligned = table.data_ptr() % 16 == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if dtype == torch.float32:
        assert gather_combine.path(b, f, dtype, aligned, sms) == path
    got = gather_combine.gather_combine(table, idx, w)
    assert got.dtype == dtype and got.shape == (b, f)
    assert torch.equal(got, _in_order_sum(table, idx, w))


def test_gather_combine_path_rule(cuda):
    """The kernel's own choice at the recsys shapes, in either dtype:
    serve_bulk walks its rows two columns a thread, serve_p99 keeps 16 rows
    a thread in flight, one query takes the small grid; unaligned,
    serve_bulk takes the one-column row walk, as rows too narrow for two
    columns a thread do."""
    P = gather_combine.path
    for dtype in (torch.float32, torch.bfloat16):
        assert P(262_144, 256, dtype, True, 132) == "wide_rows"
        assert P(512, 256, dtype, True, 132) == "rows"
        assert P(1, 256, dtype, True, 132) == "small_grid"
        assert P(262_144, 256, dtype, False, 132) == "rows"
    assert P(262_144, 32, torch.float32, True, 132) == "rows"


def test_gather_combine_takes_bf16_and_float32_only(cuda):
    table, idx, w = _bag_inputs(cuda, 4, 3, 8, 10)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="dtype"):
            gather_combine.gather_combine(table.to(dtype), idx, w)
    before = gather_combine.launches
    out = gather_combine.gather_combine(table.to(torch.bfloat16), idx, w)
    assert out.dtype == torch.bfloat16
    assert gather_combine.launches == before + 1


def test_gather_combine_bf16_band_fails_planted_faults(cuda):
    """The smoke run's bf16 band (1 bf16 ulp of the float32 plain sum
    rounded once, plus the float32 band) holds the kernel at serve_p99's
    shape and fails the output x (1 + 2^-7) and a dropped slot."""
    from chip_smoke import bf16_bag_judge
    table, idx, w = _bag_inputs(cuda, 512, 50, 256, 5000, seed=9)
    t16 = (table * 0.01).to(torch.bfloat16)
    got = gather_combine.gather_combine(t16, idx, w)
    ok, _, read = bf16_bag_judge(t16, idx, w, got,
                                 gather_combine.plain(t16, idx, w))
    assert ok, read
    assert read["worst_share"] <= 1.0
    assert read["scaled_fault_share"] > 1.0
    assert read["dropped_fault_share"] > 1.0


def _shuffled_plan(n, seed=0):
    order = np.random.default_rng(seed).permutation(n)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    base = identity_plan(n, 1)
    return ShardPlan(row_to_device=base.row_to_device, n_devices=1,
                     order=order, perm=perm, offsets=base.offsets,
                     makespan=0.0)


def test_lookup_bags_equals_embedding_bag_bitwise(cuda):
    table, idx, w = _bag_inputs(cuda, 512, 50, 256, 100_000, seed=7)
    ids = torch.where(w < 0.2, torch.full_like(idx, -1), idx)
    valid = (ids >= 0).float()
    w = valid / valid.sum(-1, keepdim=True).clamp_min(1)
    st = ShardedEmbeddingTable(table, _shuffled_plan(100_000))
    got = st.lookup_bags(ids, w)
    want = ops.embedding_bag(table, ids.clamp_min(0), w)
    assert torch.equal(got, want)
    assert torch.equal(st.replicated(), table)


def test_two_tower_serving_on_the_card(cuda):
    """Row-perm transparency bitwise on the card, and the card's scores
    against the CPU's plain path on the same parameters."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = TwoTower(SMOKE, generator=gen, device=cuda)
    st = ShardedEmbeddingTable(model.item_table,
                               _shuffled_plan(model.item_table.shape[0]))
    permuted = TwoTower(SMOKE, device="meta")
    permuted.load_state_dict({**model.state_dict(), "item_table": st.data},
                             assign=True)
    row_perm = torch.as_tensor(st.plan.perm, device=cuda)
    batch = smoke_batch()
    ops.reset_launch_counts()
    for fn in ("user_embed", "item_embed", "score"):
        a = getattr(model, fn)(batch)
        assert torch.equal(a, getattr(permuted, fn)(batch, row_perm=row_perm))
    assert ops.launch_counts()["bag_combine"] == 4
    cpu = TwoTower(SMOKE, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
    torch.testing.assert_close(model.score(batch).cpu(), cpu.score(batch),
                               rtol=1e-5, atol=1e-6)


def _bsr_layout_case(cuda, graph, block, f, seed=0):
    """A graph's BSR layout on the card and a random ``x`` for it."""
    lay = ops.prepare_bsr(graph.n_nodes, graph.senders, graph.receivers,
                          graph.edge_weight, block, device=cuda)
    x = torch.randn(lay.n_block_rows * block, f, generator=_gen(cuda, seed),
                    device=cuda)
    return lay, x


def _bsr_args(lay, x):
    """The plain version's arguments: the layout's arrays and ``x``."""
    return (lay.row_ptr, lay.block_cols, lay.blocks, x)


def _with_block_rows(lay, nbr):
    """The layout cut to its first ``nbr`` block rows, or grown to ``nbr``
    by rows of one all-zero block each: the first rows' products stay."""
    dev = lay.blocks.device
    if nbr <= lay.n_block_rows:
        end = int(lay.row_ptr[nbr])
        return dataclasses.replace(
            lay, row_ptr=lay.row_ptr[:nbr + 1], block_cols=lay.block_cols[:end],
            blocks=lay.blocks[:end], occupancy=lay.occupancy[:end],
            n_block_rows=nbr, n_nodes=min(lay.n_nodes, nbr * lay.block))
    extra, nnzb = nbr - lay.n_block_rows, lay.blocks.shape[0]
    return dataclasses.replace(
        lay,
        row_ptr=torch.cat([lay.row_ptr, nnzb + 1 + torch.arange(
            extra, dtype=torch.int32, device=dev)]),
        block_cols=torch.cat([lay.block_cols, torch.zeros(
            extra, dtype=torch.int32, device=dev)]),
        blocks=torch.cat([lay.blocks, lay.blocks.new_zeros(
            (extra,) + tuple(lay.blocks.shape[1:]))]),
        occupancy=torch.cat([lay.occupancy, lay.occupancy.new_zeros(
            (extra,) + tuple(lay.occupancy.shape[1:]))]),
        n_block_rows=nbr)


# (graph, R, F): one molecule request (the narrow tile), 2,400 molecules
# (563 block rows: the wide tile), ragged F with an empty block row at
# R = 32, R = 16, one block row, F = 1, several feature tiles with a ragged
# last one, and a power-law graph
BSR_CASES = {
    "request_128mol": (lambda: molecule_batch(128, 30, 64, seed=0), 128, 64),
    "wide_2400mol": (lambda: molecule_batch(2400, 30, 64, seed=1), 128, 64),
    "ragged_R32_F96": (lambda: gapped_graph(400, 1500, (64, 128)), 32, 96),
    "R16_F8": (lambda: gapped_graph(300, 900, (0, 40), seed=2), 16, 8),
    "R32_F64": (lambda: rmat(700, 3000, seed=4), 32, 64),
    "one_block_row": (lambda: rmat(100, 400, seed=5), 128, 64),
    "F1": (lambda: rmat(500, 2000, seed=6), 128, 1),
    "F200_wide": (lambda: molecule_batch(1100, 30, 64, seed=7), 128, 200),
    "rmat_R128_F128": (lambda: rmat(3000, 20000, seed=8), 128, 128),
}


@pytest.mark.parametrize("name", sorted(BSR_CASES))
def test_bsr_spmm_kernel_matches_plain(cuda, name):
    make, block, f = BSR_CASES[name]
    lay, x = _bsr_layout_case(cuda, make(), block, f, seed=block + f)
    args = _bsr_args(lay, x)
    before = bsr_spmm.launches
    got = bsr_spmm.bsr_spmm(*args, lay.occupancy)
    assert bsr_spmm.launches == before + 1
    want = bsr_spmm.plain(*args)
    tol = bsr_spmm.order_tolerance(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got - want).abs()
    assert bool((err <= tol + 1e-6 * want.abs()).all()), float(err.max())


def test_bsr_spmm_tiles_on_both_sides_of_the_switch(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bsr_spmm.tile(30, 128, 64, sms) == bsr_spmm.NARROW_TILE
    assert bsr_spmm.tile(3840, 128, 64, sms) == bsr_spmm.WIDE_TILE
    g = molecule_batch(2400, 30, 64, seed=1)
    assert bsr_spmm.tile(-(-g.n_nodes // 128), 128, 64,
                         sms) == bsr_spmm.WIDE_TILE


@pytest.mark.parametrize("name", sorted(BSR_CASES))
def test_bsr_spmm_skipping_slabs_is_bitwise_the_dense_walk(cuda, name):
    """For finite x, reading only the layout's nonzero slabs gives bitwise
    the walk over every slab of every stored block (an occupancy with
    every bit set): a skipped slab's terms are fmaf(0, x, acc) == acc."""
    make, block, f = BSR_CASES[name]
    lay, x = _bsr_layout_case(cuda, make(), block, f, seed=block + f + 1)
    every = bsr_spmm.slab_occupancy(torch.ones_like(lay.blocks))
    rows = bsr_spmm.tile(lay.n_block_rows, block, f,
                         torch.cuda.get_device_properties(cuda)
                         .multi_processor_count)[0]
    read, stored = bsr_spmm.nonzero_slabs(every, rows)
    assert read == stored
    args = _bsr_args(lay, x)
    assert torch.equal(bsr_spmm.bsr_spmm(*args, lay.occupancy),
                       bsr_spmm.bsr_spmm(*args, every))


@pytest.mark.parametrize("name", sorted(BSR_CASES))
def test_bsr_spmm_tiles_agree_bitwise(cuda, name):
    """The layout's block rows under the other tile, reached by growing
    the layout with all-zero block rows to the switch's count or cutting
    it below: bitwise the same products (the same terms in the same
    order). R = 16 is below the wide tile and stays narrow."""
    make, block, f = BSR_CASES[name]
    lay, x = _bsr_layout_case(cuda, make(), block, f, seed=block + f + 2)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bm, bn = bsr_spmm.WIDE_TILE
    per_row = -(-block // bm) * -(-f // bn)
    switch = -(-bsr_spmm.WIDE_MIN_BLOCKS_PER_SM * sms // per_row)
    nbr = lay.n_block_rows
    other = _with_block_rows(lay, switch if nbr < switch else switch - 1)
    tiles = [bsr_spmm.tile(m, block, f, sms)
             for m in (nbr, other.n_block_rows)]
    assert (tiles[0] != tiles[1]) is (block >= bm)
    keep = min(nbr, other.n_block_rows) * block
    a = bsr_spmm.bsr_spmm(*_bsr_args(lay, x), lay.occupancy)
    b = bsr_spmm.bsr_spmm(*_bsr_args(other, x), other.occupancy)
    assert torch.equal(a[:keep], b[:keep])
    if other.n_block_rows > nbr:
        assert bool((b[keep:] == 0).all())


def test_bsr_spmm_on_all_zero_slabs_and_an_all_zero_block_row(cuda):
    """Blocks whose sub-blocks are mostly zero and one block row with no
    arc at all (to_bsr's zero block there: every slab skipped)."""
    g = gapped_graph(700, 400, (256, 384), seed=9)
    lay, x = _bsr_layout_case(cuda, g, 128, 64, seed=4)
    read, stored = bsr_spmm.nonzero_slabs(lay.occupancy, 64)
    assert 0 < read < stored
    assert int(lay.occupancy[int(lay.row_ptr[2])].abs().sum()) == 0
    got = ops.gnn_aggregate_bsr(lay, x[:700])
    assert bool((got[256:384] == 0).all())
    want = bsr_spmm.plain(lay.row_ptr, lay.block_cols, lay.blocks, x)[:700]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bsr_spmm_non_finite_x_follows_segment_sum_where_slabs_are_zero(
        cuda):
    """An inf in x reaches exactly the row tiles that read its slab
    (there a stored zero times inf is NaN, as in the dense product); every
    other row equals ``ops.gnn_aggregate`` (the reference's segment_sum),
    including rows whose block column holds the inf but whose slab is all
    zero, where the dense product would give NaN."""
    g = molecule_batch(1024, 30, 64, seed=11)
    lay, x = _bsr_layout_case(cuda, g, 128, 64, seed=5)
    n, r = g.n_nodes, lay.block
    v = 5 * r + 37                       # column slab 2 of block column 5
    x[v, 3] = float("inf")
    got = ops.gnn_aggregate_bsr(lay, x[:n])
    s = torch.as_tensor(g.senders, device=cuda)
    rc = torch.as_tensor(g.receivers, device=cuda)
    w = torch.as_tensor(g.edge_weight, device=cuda)
    seg = ops.gnn_aggregate(s, rc, w, x[:n], n)
    # the row tiles that read slab v // 16 of block column v // R
    bm = bsr_spmm.tile(lay.n_block_rows, r, 64,
                       torch.cuda.get_device_properties(cuda)
                       .multi_processor_count)[0]
    reads = torch.zeros(lay.n_block_rows * r, dtype=torch.bool, device=cuda)
    rows = torch.repeat_interleave(
        torch.arange(lay.n_block_rows, device=cuda),
        (lay.row_ptr[1:] - lay.row_ptr[:-1]).long())
    bit = ((lay.occupancy[..., 0] >> ((v % r) // 16)) & 1).bool()
    per = bm // 16
    for t in torch.nonzero(lay.block_cols == v // r).flatten().tolist():
        for m0 in range(0, r, bm):
            if bool(bit[t, m0 // 16:m0 // 16 + per].any()):
                b0 = int(rows[t]) * r + m0
                reads[b0:b0 + bm] = True
    reads = reads[:n]
    bad = ~torch.isfinite(got[:, 3])
    assert torch.equal(bad, reads | ~torch.isfinite(seg[:, 3]))
    dense_nan = torch.zeros_like(reads)
    for t in torch.nonzero(lay.block_cols == v // r).flatten().tolist():
        b0 = int(rows[t]) * r
        dense_nan[b0:b0 + r] = True
    assert bool((dense_nan[:n] & ~bad).any())     # the pinned difference
    ok = ~bad
    torch.testing.assert_close(got[ok], seg[ok], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[:, :3], seg[:, :3], rtol=1e-5, atol=1e-5)


def test_bsr_spmm_is_deterministic(cuda):
    lay, x = _bsr_layout_case(cuda, molecule_batch(1024, 30, 64, seed=3),
                              128, 64)
    a = bsr_spmm.bsr_spmm(*_bsr_args(lay, x), lay.occupancy)
    b = bsr_spmm.bsr_spmm(*_bsr_args(lay, x), lay.occupancy)
    assert torch.equal(a, b)


def test_bsr_spmm_checks_its_arguments(cuda):
    lay, x = _bsr_layout_case(cuda, rmat(300, 1000, seed=1), 32, 16)
    row_ptr, cols, blocks, occ = (lay.row_ptr, lay.block_cols, lay.blocks,
                                  lay.occupancy)
    with pytest.raises(TypeError, match="dtype"):
        bsr_spmm.bsr_spmm(row_ptr.long(), cols, blocks, x, occ)
    with pytest.raises(TypeError, match="dtype"):
        bsr_spmm.bsr_spmm(row_ptr, cols, blocks, x.double(), occ)
    with pytest.raises(ValueError, match="on cpu"):
        bsr_spmm.bsr_spmm(row_ptr, cols.cpu(), blocks, x, occ)
    with pytest.raises(ValueError, match=r"\[nnzb, R, R\]"):
        bsr_spmm.bsr_spmm(row_ptr, cols, blocks[:, :, :16], x, occ)
    with pytest.raises(ValueError, match="n_block_cols"):
        bsr_spmm.bsr_spmm(row_ptr, cols, blocks, x[:-1], occ)
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm.bsr_spmm(row_ptr, cols, blocks, x.t().contiguous().t(), occ)
    with pytest.raises(TypeError, match="dtype"):
        bsr_spmm.bsr_spmm(row_ptr, cols, blocks, x, occ.long())


def test_gin_on_the_card_matches_its_cpu_plain_path(cuda):
    """GIN-TU at full width on 32 molecules: 5 launches per forward, and the
    card's logits against the CPU's plain path on the same parameters."""
    cfg = gin_tu.ARCH.make_config("molecule")
    model = GIN(cfg, generator=_gen(cuda, 0), device=cuda)
    batch = next(molecule_batches(32, 30, 64, 16, 2, seed=0))
    ops.reset_launch_counts()
    got = model(batch, gin_layout(batch, device=cuda))
    assert ops.launch_counts()["bsr_spmm"] == cfg.n_layers
    cpu = GIN(cfg, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        assign=True)
    want = cpu(batch, gin_layout(batch, device="cpu"))
    scale = float(want.abs().max())
    err = (got.cpu() - want).abs()
    assert bool((err <= 1e-5 * (scale + want.abs())).all()), float(err.max())


@pytest.mark.parametrize("arcs", ["symmetric", "asymmetric"])
def test_bsr_aggregate_backward_matches_plain(cuda, arcs):
    """``gnn_aggregate_bsr``'s autograd Function: one kernel launch forward
    on A and one backward on Aᵀ (the same layout where the arcs are
    symmetric), each against the plain block product on its layout, and
    the backward against ``Aᵀ @ dout`` from the arc list."""
    batch = next(molecule_batches(64, 30, 64, 16, 2, seed=3))
    if arcs == "asymmetric":
        batch = asymmetric_batch(batch)
    lays = gin_layouts(batch, device=cuda)
    assert (lays["bsr_t"] is lays["bsr"]) == (arcs == "symmetric")
    n = batch["x"].shape[0]
    x = torch.randn(n, 64, generator=_gen(cuda, 1), device=cuda,
                    requires_grad=True)
    dout = torch.randn(n, 64, generator=_gen(cuda, 2), device=cuda)
    before = bsr_spmm.launches
    out = ops.gnn_aggregate_bsr(lays["bsr"], x, lays["bsr_t"])
    (dx,) = torch.autograd.grad(out, x, dout)
    assert bsr_spmm.launches == before + 2
    for lay, inp, got in ((lays["bsr"], x.detach(), out.detach()),
                          (lays["bsr_t"], dout, dx)):
        pad = lay.n_block_rows * lay.block - n
        args = _bsr_args(lay, torch.nn.functional.pad(inp, (0, 0, 0, pad)))
        want = bsr_spmm.plain(*args)[:n]
        tol = bsr_spmm.order_tolerance(*args)[:n]
        err = (got - want).abs()
        assert bool((err <= tol + 1e-6 * want.abs()).all()), float(err.max())
    s = torch.as_tensor(batch["senders"], device=cuda)
    r = torch.as_tensor(batch["receivers"], device=cuda)
    want = ops.gnn_aggregate(r, s, torch.ones(s.shape[0], device=cuda), dout,
                             n)
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-4)


def test_gin_grads_through_the_kernel_match_the_plain_path(cuda):
    """GIN-TU's molecule config on 64 molecules with a seeded half of one
    direction of their edges dropped: ``loss_fn``'s loss and every
    gradient leaf through ``bsr_spmm`` (10 launches) against the plain
    ``edge_apply`` path on the card (the smoke's gate (a) bands)."""
    cfg = gin_tu.ARCH.make_config("molecule")
    batch = asymmetric_batch(next(molecule_batches(64, 30, 64, 16, 2,
                                                   seed=4)))
    params = gnn.init(cfg, _gen(cuda, 0), device=cuda)
    dev_batch = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
    before = bsr_spmm.launches
    loss_k, _, grads_k = loss_and_grads(
        lambda p, b: gnn.loss_fn(p, b, cfg), params,
        dict(dev_batch, **gin_layouts(batch, device=cuda)))
    assert bsr_spmm.launches == before + 2 * cfg.n_layers
    loss_p, _, grads_p = loss_and_grads(
        lambda p, b: gnn.loss_fn(p, b, cfg, gnn.plain_aggregate(b)), params,
        dev_batch)
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b in zip(tree.leaves(grads_k), tree.leaves(grads_p)):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-4


def test_gin_on_the_card_without_layouts_raises(cuda):
    """A CUDA batch without its BSR layouts never takes the plain
    aggregation: ``loss_fn`` raises, naming ``gin_layouts``."""
    cfg = gin_tu.ARCH.make_config("molecule")
    batch = next(molecule_batches(8, 30, 64, 16, 2, seed=5))
    params = gnn.init(cfg, _gen(cuda, 0), device=cuda)
    dev_batch = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
    with pytest.raises(ValueError, match="gin_layouts"):
        gnn.loss_fn(params, dev_batch, cfg)


@pytest.mark.parametrize("kind", ["pna", "mgn"])
def test_pna_and_mgn_train_steps_match_the_cpu(cuda, kind):
    """A smoke-config step of ``loss_fn`` on the card against the CPU on
    the same params and sampled batch: MeshGraphNet in float32, PNA in
    float64 (its float32 std is rounding noise where messages nearly
    coincide; tests/test_torch_gnn_train.py)."""
    mod = {"pna": pna, "mgn": meshgraphnet}[kind]
    dtype = torch.float64 if kind == "pna" else torch.float32
    cfg = dataclasses.replace(mod.SMOKE, dtype=dtype)
    g = rmat(2000, 12000, seed=1)
    feats = gnn_features(g, cfg.d_in, cfg.n_classes, seed=0)
    batch = next(minibatch_batches(g, feats, 64, (5, 3), 1024, 2048, seed=0))
    params = gnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    loss_c, _, grads_c = loss_and_grads(
        lambda p, b: gnn.loss_fn(p, b, cfg), params, batch)
    loss_g, _, grads_g = loss_and_grads(
        lambda p, b: gnn.loss_fn(p, b, cfg),
        tree.map_(lambda t: t.to(cuda), params),
        {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()})
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for a, b in zip(tree.leaves(grads_g), tree.leaves(grads_c)):
        assert float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)) \
            <= 1e-4


# tests/test_flash_kernel.py's CASES (b, sq, sk, h, kh, d, causal), the LM's
# head shape, the smoke configs' head dims (12, 16), ragged lengths on both
# sides of the 64-row tiles, one row, Sq != Sk (top-left causal), and
# batches of 2 whose lengths cross the bf16 kernel's 128-row and 128-key
# tiles (a tensor map that read across the batch boundary would show)
FLASH_CASES = [
    (2, 64, 64, 4, 2, 32, True), (1, 100, 100, 4, 1, 16, True),
    (2, 64, 64, 8, 8, 32, False), (1, 128, 128, 4, 2, 64, True),
    (2, 300, 300, 12, 2, 128, True), (1, 65, 65, 4, 2, 12, True),
    (3, 1, 1, 2, 1, 16, True), (1, 127, 127, 6, 3, 128, False),
    (1, 40, 200, 4, 2, 64, True), (1, 200, 40, 4, 2, 64, True),
    (2, 129, 129, 12, 2, 128, True), (2, 257, 131, 4, 2, 64, False),
    (2, 200, 333, 6, 1, 128, True),
]
# float32: the reference's band for its kernel (tests/test_flash_kernel.py)
FLASH_F32 = dict(rtol=2e-5, atol=2e-5)
# bf16: held to the function's value, the float32 plain version on the same
# bf16 inputs: the kernel's largest and root-mean-square error at most this
# many times the bf16 plain version's own (chip_smoke.py's
# flash_bf16_judge; the reference's atol of 3e-2 is as large as |o| and
# could not fail a wrong kernel)
FLASH_BF16_RATIO = 2.0


def _flash_inputs(cuda, case, dtype):
    b, sq, sk, h, kh, d, _ = case
    gen = _gen(cuda, sum(case[:6]))
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    q, k, v = _flash_inputs(cuda, case, dtype)
    causal = case[-1]
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = mcommon.flash_attention(q, k, v, causal=causal, q_chunk=64,
                                   kv_chunk=64)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FLASH_F32)
    else:
        truth = mcommon.flash_attention(q.float(), k.float(), v.float(),
                                        causal=causal, q_chunk=64,
                                        kv_chunk=64)

        def errs(x):
            diff = x.float() - truth
            return float(diff.abs().max()), float(diff.square().mean().sqrt())
        (k_max, k_rms), (p_max, p_rms) = errs(got), errs(want)
        assert k_max <= FLASH_BF16_RATIO * p_max, (k_max, p_max)
        assert k_rms <= FLASH_BF16_RATIO * p_rms, (k_rms, p_rms)
    assert torch.equal(flash_attention.flash_attention(q, k, v,
                                                       causal=causal), got)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16),
                                     (torch.bfloat16, 128)],
                         ids=["simt_f32", "tensor_core_bf16"])
def test_flash_attention_with_no_keys_gives_zeros(cuda, dtype, d):
    """Every key masked (Sk = 0): m stays -inf, the isfinite guards keep
    NaN out, and the output is acc / max(l, 1e-20) = 0."""
    q = torch.randn(1, 5, 2, d, device=cuda).to(dtype)
    k = torch.zeros(1, 0, 1, d, device=cuda, dtype=dtype)
    got = flash_attention.flash_attention(q, k, k, causal=False)
    assert torch.equal(got, torch.zeros_like(q))


# (b, sq, sk, h, kh, d, causal) for the bf16 Hopper kernel's two products
# in isolation; the one-hot cases need sk <= d
FLASH_ONE_HOT_CASES = [(2, 200, 128, 4, 2, 128, True),
                       (1, 129, 100, 6, 3, 128, False),
                       (2, 130, 64, 4, 1, 64, True)]
FLASH_MEAN_CASES = [(2, 300, 300, 12, 2, 128, True),
                    (2, 257, 131, 4, 2, 64, False),
                    (1, 333, 200, 6, 1, 128, True)]


def _visible(sq, sk, causal, device):
    """[sq, sk] mask of the keys each row sees (top-left causal)."""
    rows = torch.arange(sq, device=device)[:, None]
    keys = torch.arange(sk, device=device)[None, :]
    return (keys <= rows) if causal else torch.ones_like(keys <= rows)


@pytest.mark.parametrize("case", FLASH_ONE_HOT_CASES, ids=str)
def test_flash_attention_bf16_scores_with_one_hot_values(cuda, case):
    """S = Q K^T alone: with v[j] the one-hot row e_j, o[i, j] is the
    softmax probability of key j itself. Held to the float32 softmax of the
    same bf16 q and k within two bf16 roundings (P before the PV product,
    the output) and the float32 sums' error."""
    b, sq, sk, h, kh, d, causal = case
    gen = _gen(cuda, sum(case[:6]))
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, kh, d), generator=gen, device=cuda).bfloat16()
    v = (torch.eye(sk, d, device=cuda)[None, :, None, :]
         .expand(b, sk, kh, d).contiguous().bfloat16())
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    kf = k.float().repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), kf) / np.sqrt(d)
    s = s.masked_fill(~_visible(sq, sk, causal, cuda)[None, :, None, :],
                      -torch.inf)
    want = torch.zeros((b, sq, h, d), device=cuda)
    want[..., :sk] = torch.softmax(s, dim=-1)
    torch.testing.assert_close(got.float(), want, rtol=2 * 2.0 ** -8 + 1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("case", FLASH_MEAN_CASES, ids=str)
def test_flash_attention_bf16_values_with_zero_keys(cuda, case):
    """O += P V alone: with every key zero each visible score is 0, P is 1
    on every visible key (exact in bf16), and o[i] is the mean of the
    visible v rows, a closed form: (v_0 + ... + v_min(i, sk-1)) /
    min(i + 1, sk) when causal, the mean of all sk rows otherwise. Held to
    that within one bf16 rounding of the output (2x margin) and the float32
    sums' error."""
    b, sq, sk, h, kh, d, causal = case
    gen = _gen(cuda, sum(case[:6]))
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda).bfloat16()
    k = torch.zeros((b, sk, kh, d), device=cuda, dtype=torch.bfloat16)
    v = torch.randn((b, sk, kh, d), generator=gen, device=cuda).bfloat16()
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    vf = v.float().repeat_interleave(h // kh, dim=2)
    if causal:
        last = torch.arange(sq, device=cuda).clamp(max=sk - 1)
        want = (vf.cumsum(dim=1)[:, last]
                / (last + 1).float()[None, :, None, None])
    else:
        want = vf.mean(dim=1, keepdim=True).expand(b, sq, h, d)
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7, atol=1e-5)


def test_flash_attention_rejects_misaligned_bf16_bases(cuda):
    """TMA reads 16-byte-aligned bases only: a contiguous view at an odd
    element offset is refused before any launch."""
    b, s, h, kh, d = 1, 16, 4, 2, 128
    flat = torch.randn(b * s * h * d + 1, device=cuda).bfloat16()
    q = flat[1:].view(b, s, h, d)
    assert q.is_contiguous() and q.data_ptr() % 16
    k = torch.randn(b, s, kh, d, device=cuda).bfloat16()
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention(q, k, k)
    kv = flat[1:b * s * kh * d + 1].view(b, s, kh, d)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.flash_attention(q.clone(), kv, kv)
    assert flash_attention.launches == before


def test_flash_attention_checks_its_arguments(cuda):
    q = torch.randn(1, 8, 4, 16, device=cuda)
    k = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(
            torch.randn(1, 8, 2, 256, device=cuda),
            torch.randn(1, 8, 1, 256, device=cuda),
            torch.randn(1, 8, 1, 256, device=cuda))
    with pytest.raises(ValueError, match="query heads"):
        flash_attention.flash_attention(q[:, :, :3].contiguous(), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="on cpu"):
        flash_attention.flash_attention(q, k.cpu(), k)


# the log-sum-exp output: the reference's CASES (tests/test_flash_attention.py)
# with Dv = D as (b, sq, sk, h, kh, d, causal), a ragged bf16 case on the
# Hopper kernel, and the training shape; its MLA-like case (Dv != D) and
# MLA's (192, 128) are in MLA_FLASH_CASES below
LSE_CASES = [(2, 64, 64, 4, 4, 32, True), (2, 64, 64, 8, 2, 32, True),
             (1, 100, 100, 4, 1, 16, True), (2, 64, 64, 4, 4, 32, False),
             (2, 64, 64, 4, 2, 32, True), (2, 300, 300, 12, 2, 128, True),
             (4, 4096, 4096, 12, 2, 128, True)]


@pytest.mark.parametrize("case", LSE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_lse_matches_plain(cuda, case, dtype):
    """The kernel's lse against the plain forward's on the same inputs
    (float32: the reference's band; bf16: ``TRAIN_LSE_TOL``), in the
    reference's layout, and the output bitwise the same with and without
    it."""
    q, k, v = _flash_inputs(cuda, case, dtype)
    b, sq, _, h, _, _, causal = case
    before = flash_attention.launches
    out, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                               return_lse=True)
    assert flash_attention.launches == before + 1
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, sq, h)
    assert torch.equal(out, flash_attention.flash_attention(q, k, v,
                                                            causal=causal))
    _, want = mcommon.flash_attention_fwd(q, k, v, causal, 512, 512)
    if dtype == torch.float32:
        torch.testing.assert_close(lse, want, **FLASH_F32)
    else:
        assert float((lse - want).abs().max()) <= TRAIN_LSE_TOL


def test_flash_attention_lse_without_keys_is_minus_inf(cuda):
    q = torch.randn(1, 5, 2, 128, device=cuda).bfloat16()
    k = torch.zeros(1, 0, 1, 128, device=cuda, dtype=torch.bfloat16)
    for qq, kk in ((q, k), (q.float()[..., :16].contiguous(),
                           k.float()[..., :16].contiguous())):
        _, lse = flash_attention.flash_attention(qq, kk, kk, causal=False,
                                                 return_lse=True)
        assert bool((lse == -torch.inf).all())


# (b, sq, sk, h, kh, d, dv, causal) with Dv != D: MLA's prefill heads (D =
# 192 = 128 nope + 64 rope, Dv = 128: the bf16 Hopper instance), 16 heads on
# 16 and grouped, ragged Sq / Sk on both sides of the 128-row tiles, one
# row, top-left causal with Sq != Sk; the reference's MLA-like case
# (tests/test_flash_attention.py: D = 24, Dv = 16) and other (D, Dv) pairs
# on the SIMT kernel
MLA_FLASH_CASES = [
    (1, 300, 300, 16, 16, 192, 128, True), (2, 129, 129, 16, 16, 192, 128,
                                            False),
    (2, 257, 131, 8, 2, 192, 128, True), (1, 200, 333, 4, 1, 192, 128, True),
    (3, 1, 1, 2, 2, 192, 128, True), (2, 33, 33, 4, 2, 24, 16, True),
    (1, 100, 100, 4, 4, 192, 64, True), (1, 70, 90, 4, 2, 64, 128, False),
    (2, 65, 65, 6, 3, 160, 96, True),
]


def _mla_inputs(cuda, case, dtype):
    b, sq, sk, h, kh, d, dv, _ = case
    gen = _gen(cuda, sum(case[:7]))
    return [torch.randn(shape, generator=gen, device=cuda).to(dtype)
            for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, dv))]


@pytest.mark.parametrize("case", MLA_FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_value_head_dim_apart(cuda, case, dtype):
    """v of its own head dim: the output [B, Sq, H, Dv] against the plain
    version (float32: the reference's band; bf16: ``flash_bf16_judge``'s,
    2x the bf16 plain version's max and rms error against float32, per
    128-row tile too, and both planted faults rejected), one launch, two
    calls bitwise, and the lse (float32 [B, Sq, H]) against the plain
    forward's with the output bitwise the same with and without it."""
    q, k, v = _mla_inputs(cuda, case, dtype)
    b, sq, _, h, _, _, dv, causal = case
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, sq, h, dv)
    want, want_lse = mcommon.flash_attention_fwd(q, k, v, causal, 64, 64)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FLASH_F32)
    elif causal:
        ok, _, readings = flash_bf16_judge(q, k, v, got, want, 64, 64)
        assert ok, readings
    else:
        truth = mcommon.flash_attention(q.float(), k.float(), v.float(),
                                        causal=False, q_chunk=64,
                                        kv_chunk=64)
        for x in (got, want):
            assert x.shape == truth.shape
        k_err, p_err = (x.float() - truth for x in (got, want))
        assert float(k_err.abs().max()) <= FLASH_BF16_RATIO * float(
            p_err.abs().max())
        assert float(k_err.square().mean()) <= FLASH_BF16_RATIO ** 2 * float(
            p_err.square().mean())
    assert torch.equal(flash_attention.flash_attention(q, k, v,
                                                       causal=causal), got)
    out, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                               return_lse=True)
    assert torch.equal(out, got)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, sq, h)
    if dtype == torch.float32:
        torch.testing.assert_close(lse, want_lse, **FLASH_F32)
    else:
        assert float((lse - want_lse).abs().max()) <= TRAIN_LSE_TOL


def test_flash_attention_mla_instance_rejects_misaligned_bases(cuda):
    """The (192, 128) Hopper instance reads by TMA too: a misaligned q, k
    or v is refused before any launch."""
    b, s, h = 1, 16, 4
    flat = torch.randn(b * s * h * 192 + 1, device=cuda).bfloat16()
    q = flat[1:].view(b, s, h, 192)
    k = torch.randn(b, s, h, 192, device=cuda).bfloat16()
    v = torch.randn(b, s, h, 128, device=cuda).bfloat16()
    before = flash_attention.launches
    for args in ((q, k, v), (k, q, v),
                 (k, k, flat[1:b * s * h * 128 + 1].view(b, s, h, 128))):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention.flash_attention(*args)
    assert flash_attention.launches == before


def test_flash_attention_head_dim_limits(cuda):
    """D up to 192, Dv up to 128; v's rows must match k's."""
    q = torch.randn(1, 8, 2, 192, device=cuda)
    v = torch.randn(1, 8, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="value head dim"):
        flash_attention.flash_attention(q, q, torch.randn(1, 8, 2, 160,
                                                          device=cuda))
    with pytest.raises(ValueError, match="head dim 256"):
        big = torch.randn(1, 8, 2, 256, device=cuda)
        flash_attention.flash_attention(big, big, v)
    with pytest.raises(ValueError, match="shape"):
        flash_attention.flash_attention(q, q, v[:, :4].contiguous())


# (b, sq, sk, h, kh, d, causal) for the training path's gradients
GRAD_CASES = [(2, 64, 64, 8, 2, 32, True), (1, 100, 100, 4, 1, 16, True),
              (2, 300, 300, 12, 2, 128, True), (1, 1024, 1024, 12, 2, 128,
                                                True)]
# float32: the kernel path's gradients against the plain path's (the plain
# forward's residuals), relative L2 per gradient (chip_smoke's gate (b))
GRAD_F32_REL_L2 = 1e-4


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_function_grads_through_the_kernel(cuda, case, dtype):
    """``FlashAttention`` launches the kernel once in its forward and none
    in its backward; its dq/dk/dv against the plain path: float32 to a
    relative L2 of 1e-4, bf16 by ``flash_grad_judge`` (gate (a): 2x the
    bf16 plain path's error against float32, the planted faults
    rejected)."""
    q, k, v = _flash_inputs(cuda, case, dtype)
    causal = case[-1]
    do = torch.randn(q.shape, generator=_gen(cuda, 7), device=cuda).to(dtype)
    if dtype == torch.bfloat16:
        ok, readings = flash_grad_judge(q, k, v, do, 64, 64)
        assert ok, readings
        return
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = flash_attention.launches
    out = ops.flash_attention(*leaves, causal=causal, q_chunk=64, kv_chunk=64)
    assert flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == before + 1
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention.FlashAttention.apply(
        *leaves, causal, 64, 64, mcommon.flash_attention_fwd)
    want = torch.autograd.grad(out, leaves, do)
    for g, w in zip(got, want):
        rel = float((g - w).norm() / w.norm())
        assert rel <= GRAD_F32_REL_L2, rel


@pytest.mark.parametrize("block", [None, 256])
def test_compress_roundtrip_on_the_card_equals_the_cpu(cuda, block):
    """The int8 round trip divides tensor by tensor, so the card gives the
    CPU's numbers bitwise (a CUDA tensor divided by a Python number is
    multiplied by the reciprocal instead), over stacked layer leaves."""
    from repro_torch import tree
    from repro_torch.dist import compress
    gen = _gen(cuda, 3)
    grads = {"ln_f": torch.randn(48, generator=gen, device=cuda),
             "layers": [{"w": torch.randn(48, 24, generator=gen,
                                          device=cuda).bfloat16() * (10 ** -i),
                         "b": torch.randn(24, generator=gen, device=cuda)}
                        for i in range(3)]}
    state = None
    cpu_grads, cpu_state = tree.map_(lambda t: t.cpu(), grads), None
    for _ in range(2):
        out, state = compress.roundtrip(grads, state, block=block)
        cpu_out, cpu_state = compress.roundtrip(cpu_grads, cpu_state,
                                                block=block)
        for a, c in zip(tree.leaves((out, state)),
                        tree.leaves((cpu_out, cpu_state))):
            assert torch.equal(a.cpu(), c)


def _smoke_lm(cuda, cfg=qwen2_1_5b.SMOKE):
    params = tr.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = {"embed": params["embed"].to(cuda),
               "unembed": params["unembed"].to(cuda),
               "ln_f": params["ln_f"].to(cuda),
               "layers": [{k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                               if isinstance(v, dict) else v.to(cuda))
                           for k, v in layer.items()}
                          for layer in params["layers"]]}
    return cfg, params, on_card


@pytest.mark.parametrize("arch", [qwen2_1_5b, deepseek_v2_lite_16b,
                                  deepseek_v2_236b],
                         ids=lambda a: a.FULL.name)
def test_smoke_prefill_on_the_card_matches_its_cpu_plain_path(cuda, arch):
    """The SMOKE configs in float32 through the kernel on the card (the
    DeepSeek ones with MLA at D = 24, Dv = 16 on the SIMT kernel and MoE
    layers) against their plain path on the CPU."""
    cfg, params, on_card = _smoke_lm(cuda, arch.SMOKE)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 150)))
    ops.reset_launch_counts()
    got = tr.prefill(on_card, toks.to(cuda), cfg)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    want = tr.prefill(params, toks, cfg)
    scale = float(want.abs().max())
    err = (got.cpu() - want).abs()
    assert bool((err <= 2e-5 * (scale + want.abs())).all()), float(err.max())


@pytest.mark.parametrize("arch", [deepseek_v2_lite_16b, deepseek_v2_236b],
                         ids=lambda a: a.FULL.name)
def test_smoke_mla_decode_on_the_card_matches_the_cpu(cuda, arch):
    """The absorbed MLA decode with MoE layers, stepped on the card and on
    the CPU over the same tokens: logits within the prefill test's band,
    both caches too."""
    cfg, params, on_card = _smoke_lm(cuda, arch.SMOKE)
    b, t = 2, 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (b, t)))
    caches = (tr.init_cache(cfg, b, t, device="cpu"),
              tr.init_cache(cfg, b, t, device=cuda))
    for pos in range(t):
        want, _ = tr.decode_step(params, caches[0], toks[:, pos:pos + 1],
                                 pos, cfg)
        got, _ = tr.decode_step(on_card, caches[1],
                                toks[:, pos:pos + 1].to(cuda), pos, cfg)
        scale = float(want.abs().max())
        err = (got.cpu() - want).abs()
        assert bool((err <= 2e-5 * (scale + want.abs())).all()), \
            float(err.max())
    for key in ("c_kv", "k_rope"):
        torch.testing.assert_close(caches[1][key].cpu(), caches[0][key],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t,capacity_factor", [(16384, 1.5), (64, 0.5),
                                               (4, 1.5)])
def test_moe_dispatch_on_the_card_equals_the_cpu(cuda, t, capacity_factor):
    """Sort, positions, the dropped set and slots on the card equal the
    CPU's on the same expert ids (tied ids, a stable sort), and a bf16
    ``moe_ffn`` on the card is bitwise the same twice (no atomics)."""
    import dataclasses as dc
    cfg = dc.replace(deepseek_v2_lite_16b.SMOKE, dtype=torch.bfloat16,
                     capacity_factor=capacity_factor, n_experts=64,
                     top_k=6)
    gen = _gen(cuda, t)
    top_i = torch.stack([torch.randperm(64, generator=gen, device=cuda)[:6]
                         for _ in range(min(t, 512))])
    top_i = top_i.repeat(-(-t // top_i.shape[0]), 1)[:t]
    cap = tr.capacity(cfg, t)
    for a, c in zip(tr.dispatch(top_i, 64, cap),
                    tr.dispatch(top_i.cpu(), 64, cap)):
        assert torch.equal(a.cpu(), c)
    d = cfg.d_model
    p = {"router": torch.randn(d, 64, generator=gen, device=cuda),
         "w_gate": torch.randn(64, d, 32, generator=gen,
                               device=cuda).bfloat16(),
         "w_up": torch.randn(64, d, 32, generator=gen,
                             device=cuda).bfloat16(),
         "w_down": torch.randn(64, 32, d, generator=gen,
                               device=cuda).bfloat16(),
         "ws_gate": torch.randn(d, 64, generator=gen,
                                device=cuda).bfloat16(),
         "ws_up": torch.randn(d, 64, generator=gen, device=cuda).bfloat16(),
         "ws_down": torch.randn(64, d, generator=gen,
                                device=cuda).bfloat16()}
    x = torch.randn(t, d, generator=gen, device=cuda).bfloat16()
    y1, s1 = tr.moe_ffn(p, x, cfg)
    y2, s2 = tr.moe_ffn(p, x, cfg)
    assert torch.equal(y1, y2) and torch.equal(s1.aux_loss, s2.aux_loss)
    assert torch.equal(s1.dropped_frac, s2.dropped_frac)


def test_smoke_engine_on_the_card_gives_the_cpu_greedy_tokens(cuda):
    cfg, params, on_card = _smoke_lm(cuda)
    rng = np.random.default_rng(11)
    work = [(rng.integers(0, cfg.vocab, int(rng.integers(2, 12))),
             int(rng.integers(1, 9))) for _ in range(8)]
    out = []
    for p, dev in ((params, "cpu"), (on_card, cuda)):
        eng = ServingEngine(p, cfg, EngineConfig(
            n_slots=3, page_size=4, n_pages=32, max_pages_per_req=6,
            temperature=0.0, replace_every=5, place_devices=4), device=dev)
        for prompt, gen in work:
            eng.submit(prompt, gen)
        rep = eng.run()
        out.append({r["rid"]: r["generated"] for r in rep.requests})
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The total-cut baselines and the mesh-mapping search on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 16])
def test_cut_refine_conn_is_bitwise_the_plain_version(cuda, k, monkeypatch):
    """Every ``partition_gain`` call of a CUDA ``total_cut_partition``
    equals the plain version on the same inputs bitwise, and on integer
    weights the whole partition equals its CPU run with the same draws."""
    from repro_torch.core import baselines
    from repro_torch.graph.generators import grid2d
    g = grid2d(48, 48)
    calls = []
    orig = ops.partition_gain

    def recording(part, nbr_idx, nbr_w, kk):
        out = orig(part, nbr_idx, nbr_w, kk)
        if part.is_cuda:
            calls.append((part.clone(), nbr_idx, nbr_w, kk, out.clone()))
        return out
    monkeypatch.setattr(ops, "partition_gain", recording)
    ops.reset_launch_counts()
    got = baselines.total_cut_partition(g, k, device=cuda,
                                        draws=NumpyDraws())
    assert ops.launch_counts()["partition_gain"] == len(calls) > 0
    for part, nbr_idx, nbr_w, kk, out in calls[::7]:
        want = partition_gain.plain(part.cpu(), nbr_idx.cpu(), nbr_w.cpu(),
                                    kk)
        assert torch.equal(out.cpu(), want)
    want = baselines.total_cut_partition(g, k, device="cpu",
                                         draws=NumpyDraws())
    np.testing.assert_array_equal(got, want)


def _mapping_inputs(shape):
    from repro_torch.core import mapping
    from repro_torch.core.topology import mesh_tree
    topo = mesh_tree(shape)
    T = mapping.collective_traffic_matrix(
        shape, {a: 10.0 ** (3 - a) for a in range(len(shape))})
    return topo, T


@pytest.mark.parametrize("shape", [(4, 4, 4), (2, 16, 16)])
def test_score_device_maps_on_the_card_equals_its_cpu_run(cuda, shape):
    from repro_torch.core import mapping
    topo, T = _mapping_inputs(shape)
    cands, _ = mapping.enumerate_candidates(shape, n_random=8, seed=1)
    got = mapping.score_device_maps(T, topo, cands, device=cuda)
    want = mapping.score_device_maps(T, topo, cands, device="cpu")
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale)
    ops.reset_launch_counts()
    looped = [mapping.makespan_of_device_map(T, topo, c, device=cuda)
              for c in cands[:5]]
    assert ops.launch_counts()["quotient_link_loads"] == 5
    np.testing.assert_allclose(looped, want[:5], rtol=1e-3,
                               atol=1e-4 * scale)


def _bottleneck64(T, topo, d2b):
    W = np.zeros_like(T, dtype=np.float64)
    W[np.ix_(d2b, d2b)] = T
    S = topo.subtree.astype(np.float64)
    loads = 0.5 * (S @ W.sum(1) + S @ W.sum(0) - 2.0 * ((S @ W) * S).sum(1))
    return float((topo.F_l * loads).max())


@pytest.mark.parametrize("shape,kw", [((4, 4, 4), {}),
                                      ((2, 16, 16), dict(n_random=8)),
                                      ((2, 4, 4), dict(recursive=True))])
def test_search_on_the_card_picks_the_cpu_winner(cuda, shape, kw):
    """The same candidate, or one tied with it exactly (float64): the two
    devices' float32 scorers may round exact ties apart."""
    from repro_torch.core import mapping
    topo, T = _mapping_inputs(shape)
    got = mapping.search(shape, topo, T, device=cuda, **kw)
    want = mapping.search(shape, topo, T, device="cpu", **kw)
    assert got.n_candidates == want.n_candidates
    np.testing.assert_allclose(got.bottleneck, want.bottleneck, rtol=1e-5)
    if not np.array_equal(got.device_to_bin, want.device_to_bin):
        np.testing.assert_allclose(_bottleneck64(T, topo, got.device_to_bin),
                                   _bottleneck64(T, topo, want.device_to_bin),
                                   rtol=1e-12)
    assert got.bottleneck <= mapping.makespan_of_device_map(
        T, topo, np.arange(topo.k), device=cuda)


# ---------------------------------------------------------------------------
# Fault recovery and two-tower training on the card
# ---------------------------------------------------------------------------

def test_smoke_engine_recovers_on_the_card_with_the_cpu_tokens(cuda):
    """A leaf death in the smoke stream on the card: every request
    completes with the clean CPU run's greedy tokens, the retired pages
    read zero, and the forced re-placement launches the partition
    kernels."""
    from repro_torch.resilience import FaultInjector, parse_fault_plan
    cfg, params, on_card = _smoke_lm(cuda)
    rng = np.random.default_rng(12)
    work = [(rng.integers(0, cfg.vocab, int(rng.integers(4, 12))),
             int(rng.integers(2, 9))) for _ in range(8)]
    out = []
    for p, dev, plan in ((params, "cpu", None), (on_card, cuda,
                                                  "5:leaf_death:2")):
        ops.reset_launch_counts()
        eng = ServingEngine(p, cfg, EngineConfig(
            n_slots=3, page_size=2, n_pages=48, max_pages_per_req=10,
            temperature=0.0, replace_every=0, place_devices=4), device=dev,
            injector=plan and FaultInjector(parse_fault_plan(plan)))
        for prompt, gen in work:
            eng.submit(prompt, gen)
        rep = eng.run()
        out.append({r["rid"]: r["generated"] for r in rep.requests})
    assert out[0] == out[1] and rep.requests_failed == 0
    rec = rep.recoveries[0]
    assert rec["device"] == 2 and rec["n_alive"] == 3 and rec["replaced"]
    dead = torch.as_tensor(eng.cache.allocator.dead_pages(), device=cuda)
    assert dead.numel() == rec["pages_lost"] > 0
    for pool in (eng.cache.k_pool, eng.cache.v_pool):
        assert not bool(pool.index_select(1, dead).any())
    counts = ops.launch_counts()
    assert counts["quotient_link_loads"] > 0
    assert counts["partition_gain"] > 0


@pytest.mark.parametrize("b,d,f", [(32, 50, 256), (7, 3, 96)])
def test_bag_combine_autograd_through_the_kernel(cuda, b, d, f):
    """The Function's forward launches the kernel; its gradients are the
    plain version's (autograd of the einsum) on the same inputs."""
    gen = _gen(cuda, 31)
    g0 = torch.randn(b, d, f, generator=gen, device=cuda)
    w0 = torch.rand(b, d, generator=gen, device=cuda)
    cot = torch.randn(b, f, generator=gen, device=cuda)
    grads = []
    for fn in (bag_combine.bag_combine, bag_combine.plain):
        g, w = g0.clone().requires_grad_(), w0.clone().requires_grad_()
        before = bag_combine.launches
        out = fn(g, w)
        launched = bag_combine.launches - before
        grads.append((out.detach(), *torch.autograd.grad(out, (g, w), cot)))
        assert launched == (1 if fn is bag_combine.bag_combine else 0)
    (ok, gk, wk), (op, gp, wp) = grads
    tol = bag_combine.order_tolerance(g0, w0)
    assert bool(((ok - op).abs() <= 1e-6 * op.abs() + tol).all())
    assert torch.equal(gk, gp)            # one product per element
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-5)


def test_take_rows_backward_is_repeatable_on_the_card(cuda):
    gen = _gen(cuda, 32)
    table = torch.randn(1000, 64, generator=gen, device=cuda,
                        requires_grad=True)
    idx = (torch.rand(200_000, generator=gen, device=cuda) ** 4 * 1000
           ).long()                        # many duplicates of hot rows
    cot = torch.randn(200_000, 64, generator=gen, device=cuda)
    outs = [torch.autograd.grad(ops.take_rows(table, idx), table, cot)[0]
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    want = torch.zeros(1000, 64, dtype=torch.float64).index_add_(
        0, idx.cpu(), cot.cpu().double())
    torch.testing.assert_close(outs[0].cpu().double(), want, rtol=1e-4,
                               atol=1e-3)


def test_row_updates_on_the_card_bitwise_and_equal_the_cpu(cuda):
    from repro_torch import embed
    gen = _gen(cuda, 33)
    table = torch.randn(5000, 128, generator=gen, device=cuda)
    accum = torch.rand(5000, generator=gen, device=cuda)
    rows = torch.unique(torch.randint(0, 5000, (1500,), generator=gen,
                                      device=cuda))
    g = torch.zeros_like(table)
    g[rows] = torch.randn(rows.numel(), 128, generator=gen, device=cuda)
    dense = embed.dense_row_update(table, accum, g)
    masked = embed.masked_row_update(table, accum, g)
    sparse = embed.sparse_row_update(table, accum, rows, g[rows])
    cpu = embed.dense_row_update(table.cpu(), accum.cpu(), g.cpu())
    for x, y, z, c in zip(dense, masked, sparse, cpu):
        assert torch.equal(x, y) and torch.equal(x, z)
        torch.testing.assert_close(x.cpu(), c, rtol=1e-6, atol=1e-6)


def test_smoke_recsys_step_on_the_card_matches_its_cpu_run(cuda):
    """Three sparse embed steps at SMOKE width from the same weights and
    batches, on the card (bag_combine launching once a step) and on the
    CPU."""
    from repro_torch import tree
    from repro_torch.data.pipeline import recsys_batches
    from repro_torch.embed import training as etr
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    params = recsys.init(SMOKE, torch.Generator().manual_seed(0),
                         device="cpu")
    ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=0)
    ecfg = etr.EmbedConfig()
    step = etr.make_embed_train_step(
        lambda p, b: recsys.loss_fn(p, b, SMOKE), ocfg, ecfg)
    batches = list(zip(range(3), recsys_batches(
        SMOKE.n_items, SMOKE.n_cats, 64, SMOKE.hist_len, SMOKE.d_dense)))
    runs = []
    for dev in ("cpu", cuda):
        p = tree.map_(lambda t: t.to(dev), params)
        o, e = etr.init_dense_opt(p, ecfg, ocfg), etr.init_embed_state(
            p, ecfg)
        before, losses = bag_combine.launches, []
        for _, b in batches:
            p, o, e, m = step(p, o, e, {k: torch.as_tensor(v, device=dev)
                                        for k, v in b.items()})
            losses.append(float(m["loss"]))
        runs.append((losses, p, e, bag_combine.launches - before))
    (lc, pc, ec, nc), (lg, pg, eg, ng) = runs
    assert nc == 0 and ng == 3
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for a, b in zip(tree.leaves((pg, eg)), tree.leaves((pc, ec))):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_place_on_the_card_equals_the_cpu_search(cuda, tmp_path):
    """``PlacementSession.place`` on qwen2-1.5b at the reference's tiny
    overrides on ``tpu-mixed-32``'s (2, 4, 4) mesh: the searches run on the
    card (``quotient_link_loads`` launched) and find the CPU's order, or
    one tied with it in float64 on the host, and makespans within rel
    1e-4 (the mapping band); searched <= identity."""
    from chip_smoke import host_map_makespan
    from repro_torch.kernels import quotient_link_loads
    from repro_torch.launch.placement import PlacementSession
    tiny = {"n_layers": 1, "batch": 4, "seq": 8}
    kw = dict(machine="tpu-mixed-32", overrides=tiny, recompile=True)
    before = quotient_link_loads.launches
    card = PlacementSession(cache_dir=str(tmp_path), device=None).place(
        "qwen2-1.5b", "train_4k", **kw)
    assert quotient_link_loads.launches > before
    cpu = PlacementSession(cache_dir=str(tmp_path), device="cpu").place(
        "qwen2-1.5b", "train_4k", **kw)
    a, b = card.report, cpu.report
    topo = MachineSpec.preset("tpu-mixed-32").topology()
    if a.device_order != b.device_order:
        t = card.record.traffic
        ha = host_map_makespan(t, topo, a.device_order)
        hb = host_map_makespan(t, topo, b.device_order)
        assert abs(ha - hb) <= 1e-9 * hb
    for side in ("identity", "searched"):
        assert a.__dict__[side]["makespan"] == pytest.approx(
            b.__dict__[side]["makespan"], rel=1e-4)
    assert a.searched["makespan"] <= a.identity["makespan"]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-lite-16b"])
def test_decode_cells_trace_under_the_cards_torch(cuda, arch):
    """The decode cells through the placement trace under the card's torch
    (meta DTensors; the card only selects the machine) at tiny overrides on
    a (2, 4) fake world: the decode attention's heads merge
    (``sharding.merge_dims``) and MLA's heads split and merge, whose
    DTensor flatten the card's torch refused."""
    from repro_torch.launch.placement import PlacementSession
    s = PlacementSession(cache_dir="", device="cpu")
    rec = s.measure(arch, "decode_32k", mesh_shape=(2, 4),
                    axes=("data", "model"),
                    overrides={"n_layers": 2, "batch": 2, "seq": 16})
    assert rec.n_collectives > 0 and rec.traffic.shape == (8, 8)
    assert s.verify(kernels=False) == []
    assert [f for f in s.verify() if f.severity != "info"] == []



# the tiny dense LM cell of tests/test_torch_dryrun.py's closed forms
DRYRUN_TINY = {"n_layers": 2, "batch": 4, "seq": 32, "d_model": 64,
               "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 512}


def test_dryrun_counts_under_the_cards_torch(cuda):
    """The op-cost recorder under the card's torch, whose DTensor
    dispatches its ops otherwise than the CPU tests' torch: a tiny qwen2
    train cell traced on a (2, 4) fake world under the sp profile counts
    one device's product FLOPs at the closed form (every product split
    eight ways; ``chip_smoke.lm_product_flops``, the CPU test's) and
    leaves no op unclassified; on one device (plain meta tensors) its
    attention declarations are ``chip_smoke.lm_attention_sites`` and its
    counts are the card's step's, op for op (``dryrun.lm_train_args``)."""
    import dataclasses as dc

    from chip_smoke import lm_attention_sites, lm_product_flops
    from repro_torch import configs
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.placement import PlacementSession
    arch = configs.get("qwen2-1.5b")
    cfg = dc.replace(arch.make_config("train_4k"),
                     **{k: v for k, v in DRYRUN_TINY.items()
                        if k not in ("batch", "seq")})
    b, s = DRYRUN_TINY["batch"], DRYRUN_TINY["seq"]
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"))
        _, cost, _ = dryrun._trace(arch, arch.shapes["train_4k"], mesh,
                                   DRYRUN_TINY, profile="sp")
    assert cost.unclassified == []
    products = sum(v["flops"] for k, v in cost.by_op.items()
                   if k in ("mm", "bmm", "addmm", "baddbmm"))
    assert products == lm_product_flops(cfg, b, s, 8)  # DTensor: no early stop
    one = PlacementSession(cache_dir="", device="cpu").measure(
        "qwen2-1.5b", "train_4k", mesh_shape=(1, 1), axes=("data", "model"),
        overrides=DRYRUN_TINY)
    site, want = one.ops["sites"]["flash_attention"], lm_attention_sites(
        cfg, b, s)
    assert site["count"] == want["count"]
    assert site["flops"] == pytest.approx(want["flops"], rel=1e-12)
    cell, args = dryrun.lm_train_args("qwen2-1.5b", "train_4k",
                                      DRYRUN_TINY, device=cuda)
    card = op_cost.OpCostRecorder()
    card.arguments(*args)
    with card:
        out = cell["step"](*args)
    card.outputs(out)
    for k in ("flops", "bytes", "bytes_tight", "transcendentals"):
        assert card.totals[k] == pytest.approx(one.hlo_cal[k], rel=1e-9), k


def test_restore_sharded_on_the_card_is_bitwise(cuda, tmp_path):
    """The elastic restore through a one-rank NCCL group: every leaf a
    DTensor on the card's mesh (``train.loop._default_mesh``, clamped to
    the world), bitwise the plain restore."""
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.dist import sharding
    from repro_torch.train import loop
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    state = {"w": torch.randn(64, 32, generator=gen, device=cuda),
             "b": torch.randn(32, generator=gen, device=cuda).bfloat16()}
    ckpt.save(str(tmp_path / "c"), 3, state)
    plain, _ = ckpt.restore(str(tmp_path / "c"), state)
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        mesh = loop._default_mesh(8)
        assert mesh.device_type == "cuda" and mesh.size() == 1
        placed, step = ckpt.restore_sharded(
            str(tmp_path / "c"), state,
            {"w": sharding.Spec("data", None), "b": None}, mesh)
        assert step == 3
        for k in state:
            assert placed[k].device_mesh is mesh
            assert placed[k].device.type == "cuda"
            assert torch.equal(placed[k].full_tensor(), plain[k])
    finally:
        dist.destroy_process_group()


def test_ranks_one_rank_nccl_world_is_bitwise(cuda, tmp_path):
    """The smoke's ``ranks`` gates at SMOKE on a one-rank NCCL world
    (``chip_smoke.ranks_runs``): the train CLI's 3 steps at 1 x 2,048 on
    the mesh, with real DTensors, bitwise the run without a process group
    (losses, grad norms, parameters, AdamW state) with the same
    ``flash_attention`` launches, above 0; ``--topology-aware`` a no-op;
    the one-shot server's tokens the same, greedy and at 0.8."""
    from chip_smoke import ranks_runs
    out = ranks_runs("cuda", smoke=True, tmp=str(tmp_path))
    assert all(out["checks"].values()), out["checks"]
    assert out["record"]["launches"]["flash_attention"] > 0
