"""Port parity for block placement: ``block_placement`` and
``apply_placement`` give every field the reference gives for the same
``part`` (unequal bins, an empty bin, a partitioner's result), and the
placed graph's BSR layout is the reference's."""
import numpy as np
import pytest

from repro.core import mapping as jmapping
from repro.graph import generators as jgen
from repro.kernels import bsr_spmm as jbsr
from repro_torch.core import mapping as tmapping
from repro_torch.core.partitioner import PartitionConfig, partition
from repro_torch.core.topology import balanced_tree
from repro_torch.graph import generators as tgen
from repro_torch.kernels import bsr_spmm as tbsr

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
