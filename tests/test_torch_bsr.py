"""Port parity for the BSR aggregation: ``to_bsr`` / ``bsr_density``
exactly, the plain ``bsr_spmm`` against the reference's Pallas kernel (in
interpret mode) and its dense oracle, and ``gnn_aggregate`` /
``gnn_aggregate_bsr`` against the reference's ``ops.gnn_aggregate``, all on
the same numpy inputs. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import generators as jgen
from repro.kernels import bsr_spmm as jbsr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.graph import generators as tgen
from repro_torch.graph.graph import from_edges
from repro_torch.kernels import bsr_spmm as tbsr
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

# the reference's own band for bsr_spmm (tests/test_kernels.py:70-71) holds
# tighter here: float32 sums of at most a few hundred O(1) terms in two
# orders differ by ~1e-6
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)


def _gapped_graph(n, m, gap, seed=0):
    """A random multigraph with no arc touching the vertices in ``gap``, so
    the block rows there are empty and ``to_bsr`` fills them with a zero
    block."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(n), np.arange(*gap))
    u, v = rng.choice(keep, m), rng.choice(keep, m)
    w = rng.random(m).astype(np.float32) + 0.1
    return from_edges(n, u, v, w)


def _graphs():
    return {
        "rmat_300": tgen.rmat(300, 1200, seed=128),
        "rmat_500": tgen.rmat(500, 2000, seed=256),
        "molecules_8": tgen.molecule_batch(8, 30, 64, seed=0),
        "gapped_200": _gapped_graph(200, 600, (64, 100)),
    }


GRAPHS = _graphs()


@pytest.mark.parametrize("block", [128, 32])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_to_bsr_is_the_reference_exactly(name, block):
    g = GRAPHS[name]
    ref = jbsr.to_bsr(g.n_nodes, g.senders, g.receivers, g.edge_weight, block)
    got = tbsr.to_bsr(g.n_nodes, g.senders, g.receivers, g.edge_weight, block)
    for a, b in zip(ref[:3], got[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ref[3] == got[3]
    assert jbsr.bsr_density(ref[0], ref[3], ref[3]) == \
        tbsr.bsr_density(got[0], got[3], got[3])
    ptr = tbsr.row_pointers(got[0], got[3])
    assert ptr.dtype == np.int32 and ptr[0] == 0 and ptr[-1] == got[0].size
    # every block row is present, and the pointers delimit its run
    assert np.all(np.diff(ptr) >= 1)
    for r in range(got[3]):
        assert np.all(got[0][ptr[r]:ptr[r + 1]] == r)


def test_the_gapped_graph_has_an_empty_block_row():
    g = GRAPHS["gapped_200"]
    rows, cols, blocks, nb = tbsr.to_bsr(g.n_nodes, g.senders, g.receivers,
                                         g.edge_weight, 32)
    # vertices 64..99 carry no arc: block row 2 (64..95) only has the zero
    # block to_bsr inserts, at key ``row * nb``, i.e. in block column 0 (its
    # comment says "diagonal"; the port keeps the reference's layout)
    assert not np.any((g.senders >= 64) & (g.senders < 96))
    sel = rows == 2
    assert sel.sum() == 1 and cols[sel][0] == 0
    assert not blocks[sel].any()


def test_reference_generators_agree_with_the_ports():
    a, b = jgen.molecule_batch(8, 30, 64, seed=0), GRAPHS["molecules_8"]
    np.testing.assert_array_equal(a.senders, b.senders)
    np.testing.assert_array_equal(a.receivers, b.receivers)


def _layout_and_x(g, block, feat, seed):
    rows, cols, blocks, nb = tbsr.to_bsr(g.n_nodes, g.senders, g.receivers,
                                         g.edge_weight, block)
    x = np.random.default_rng(seed).normal(
        size=(nb * block, feat)).astype(np.float32)
    return rows, cols, blocks, nb, x


@pytest.mark.parametrize("n,feat", [(300, 128), (500, 256), (130, 128),
                                    (300, 64), (500, 96)])
def test_plain_bsr_spmm_matches_the_pallas_kernel(n, feat):
    g = tgen.rmat(n, 4 * n, seed=feat)
    rows, cols, blocks, nb, x = _layout_and_x(g, 128, feat, seed=n)
    feat_blk = 128 if feat % 128 == 0 else feat
    want = np.asarray(jbsr.bsr_spmm(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(blocks),
        jnp.asarray(x), n_block_rows=nb, feat_blk=feat_blk, interpret=True))
    got = tbsr.plain(torch.as_tensor(tbsr.row_pointers(rows, nb)),
                     torch.as_tensor(cols), torch.as_tensor(blocks),
                     torch.as_tensor(x))
    assert got.shape == (nb * 128, feat) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)


@pytest.mark.parametrize("name,block,feat", [
    ("rmat_300", 128, 128), ("molecules_8", 32, 64), ("gapped_200", 32, 96),
    ("gapped_200", 16, 8), ("rmat_500", 128, 1)])
def test_plain_bsr_spmm_matches_the_dense_oracle(name, block, feat):
    g = GRAPHS[name]
    rows, cols, blocks, nb, x = _layout_and_x(g, block, feat, seed=feat)
    want = np.asarray(jref.bsr_spmm_ref(jnp.asarray(rows), jnp.asarray(cols),
                                        jnp.asarray(blocks), jnp.asarray(x),
                                        nb))
    ptr = torch.as_tensor(tbsr.row_pointers(rows, nb))
    args = (ptr, torch.as_tensor(cols), torch.as_tensor(blocks),
            torch.as_tensor(x))
    occ = tbsr.slab_occupancy(args[2])
    got = tbsr.bsr_spmm(*args, occ)            # CPU tensors: the plain path
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)
    # chunking the blocks changes nothing; the order bound covers the gap
    np.testing.assert_array_equal(tbsr.plain(*args, chunk=3).numpy(),
                                  got.numpy())
    tol = tbsr.order_tolerance(*args).numpy()
    assert np.all(np.abs(got.numpy() - want) <= tol + 1e-6 * np.abs(want))


@pytest.mark.parametrize("n,feat", [(300, 128), (500, 64), (130, 96)])
@pytest.mark.parametrize("block", [128, 32])
def test_gnn_aggregates_match_the_reference(n, feat, block):
    g = tgen.rmat(n, 4 * n, seed=n)
    ones = np.ones(g.n_arcs, np.float32)
    x = np.random.default_rng(n).normal(size=(n, feat)).astype(np.float32)
    want = np.asarray(jops.gnn_aggregate(
        jnp.asarray(g.senders), jnp.asarray(g.receivers), jnp.asarray(ones),
        jnp.asarray(x), n))
    xt = torch.as_tensor(x)
    direct = tops.gnn_aggregate(torch.as_tensor(g.senders),
                                torch.as_tensor(g.receivers),
                                torch.as_tensor(ones), xt, n)
    np.testing.assert_allclose(direct.numpy(), want, **SPMM_TOL)
    layout = tops.prepare_bsr(n, g.senders, g.receivers, ones, block,
                              device="cpu")
    assert layout.block == block and layout.n_nodes == n
    got = tops.gnn_aggregate_bsr(layout, xt)
    assert got.shape == (n, feat)
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)
    # the reference's own BSR path (Pallas in interpret mode)
    jlay = jops.prepare_bsr(n, g.senders, g.receivers, ones, block)
    ref_bsr = np.asarray(jops.gnn_aggregate_bsr(jlay, jnp.asarray(x),
                                                interpret=True))
    np.testing.assert_allclose(got.numpy(), ref_bsr, **SPMM_TOL)


def test_weighted_gnn_aggregate_matches_the_reference():
    g = tgen.rmat(200, 900, seed=5)
    w = np.random.default_rng(5).random(g.n_arcs).astype(np.float32)
    x = np.random.default_rng(6).normal(size=(200, 24)).astype(np.float32)
    want = np.asarray(jops.gnn_aggregate(
        jnp.asarray(g.senders), jnp.asarray(g.receivers), jnp.asarray(w),
        jnp.asarray(x), 200))
    got = tops.gnn_aggregate(torch.as_tensor(g.senders),
                             torch.as_tensor(g.receivers),
                             torch.as_tensor(w), torch.as_tensor(x), 200)
    np.testing.assert_allclose(got.numpy(), want, **SPMM_TOL)
    lay = tops.prepare_bsr(200, g.senders, g.receivers, w, 32, device="cpu")
    np.testing.assert_allclose(
        tops.gnn_aggregate_bsr(lay, torch.as_tensor(x)).numpy(), want,
        **SPMM_TOL)


@pytest.mark.parametrize("nbr,r,f,sms,wide", [
    (3840, 128, 64, 132, True),     # the bulk batch: 116 blocks per SM
    (30, 128, 64, 132, False),      # one request: 240 blocks of 16 rows
    (98, 128, 64, 132, False),      # the placed bsr_locality graph
    (32, 128, 64, 132, False),      # the unplaced one
    # 528 blocks of 32 x 64: 4 a multiprocessor, short of 16
    (132, 128, 64, 132, False), (66, 128, 128, 132, False),
    (528, 128, 64, 132, True),      # exactly 16 blocks per SM
    (527, 128, 64, 132, False),
    (264, 128, 128, 132, True),     # two feature tiles
    (5000, 32, 96, 132, True),      # R at the wide tile's height
    (32, 32, 96, 132, False),       # the ragged R = 32, F = 96 layout
    (5000, 16, 96, 132, False),     # R below it
    (100000, 16, 64, 132, False),
    (2, 256, 64, 1, True), (1, 32, 64, 0, True), (1, 32, 64, 1, False)])
def test_tile_choice(nbr, r, f, sms, wide):
    """``tile`` takes the wide tile at 16 blocks of it per SM, else the
    narrow one."""
    assert tbsr.tile(nbr, r, f, sms) == (tbsr.WIDE_TILE if wide
                                         else tbsr.NARROW_TILE)


def _occupancy_numpy(blocks, grain=16):
    """Per block, per 16-row strip, the bits of the 16-column groups that
    hold a nonzero, as uint32 words (numpy, from the host blocks)."""
    nnzb, r, _ = blocks.shape
    s = -(-r // grain)
    nz = np.zeros((nnzb, s * grain, s * grain), bool)
    nz[:, :r, :r] = blocks != 0
    sub = nz.reshape(nnzb, s, grain, s, grain).any(axis=(2, 4))
    words = np.zeros((nnzb, s, -(-s // 32)), np.uint32)
    for j in range(s):
        words[:, :, j // 32] |= sub[:, :, j].astype(np.uint32) << (j % 32)
    return words


OCC_CASES = [(name, block) for name in sorted(GRAPHS) for block in (128, 32)]
OCC_CASES += [("gapped_200", 40), ("rmat_500", 24), ("rmat_500", 600)]


@pytest.mark.parametrize("name,block", OCC_CASES)
def test_prepare_bsr_occupancy_is_a_count_of_the_blocks(name, block):
    """The layout's occupancy against a numpy count over ``to_bsr``'s
    blocks, at R = 128 and 32, R not a multiple of 16 (40, 24) and R of
    more than 32 strips (600: two words a strip)."""
    g = GRAPHS[name]
    _, _, blocks, _ = tbsr.to_bsr(g.n_nodes, g.senders, g.receivers,
                                  g.edge_weight, block)
    lay = tops.prepare_bsr(g.n_nodes, g.senders, g.receivers, g.edge_weight,
                           block, device="cpu")
    assert lay.occupancy.dtype == torch.int32
    np.testing.assert_array_equal(lay.occupancy.numpy().view(np.uint32),
                                  _occupancy_numpy(blocks))


def test_occupancy_marks_the_empty_block_row_zero():
    """The gapped graph's block row without arcs holds one zero block,
    with no bit set."""
    g = GRAPHS["gapped_200"]
    lay = tops.prepare_bsr(g.n_nodes, g.senders, g.receivers, g.edge_weight,
                           32, device="cpu")
    t = int(lay.row_ptr[2])
    assert int(lay.row_ptr[3]) == t + 1
    assert not bool(lay.blocks[t].any())
    assert int(lay.occupancy[t].abs().sum()) == 0


@pytest.mark.parametrize("rows", [16, 32, 64, 128])
@pytest.mark.parametrize("name", ["molecules_8", "rmat_300"])
def test_nonzero_slabs_counts_what_a_row_tile_reads(name, rows):
    """Slabs read by row tiles of ``rows``: the 16-column groups with a
    nonzero in any of the tile's rows, counted in numpy."""
    g = GRAPHS[name]
    lay = tops.prepare_bsr(g.n_nodes, g.senders, g.receivers, g.edge_weight,
                           128, device="cpu")
    b = lay.blocks.numpy() != 0
    nnzb = b.shape[0]
    tiles = b.reshape(nnzb, 128 // rows, rows, 8, 16).any(axis=(2, 4))
    assert tbsr.nonzero_slabs(lay.occupancy, rows) == (
        int(tiles.sum()), nnzb * (128 // rows) * 8)


def test_kernel_path_refuses_other_devices_and_no_card(monkeypatch):
    lay = tops.prepare_bsr(40, np.array([0, 1]), np.array([1, 0]),
                           np.ones(2, np.float32), 16, device="cpu")
    x = torch.zeros(48, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tbsr.bsr_spmm(lay.row_ptr.to("meta"), lay.block_cols.to("meta"),
                      lay.blocks.to("meta"), x, lay.occupancy.to("meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.prepare_bsr(40, np.array([0, 1]), np.array([1, 0]),
                         np.ones(2, np.float32), 16)


@pytest.mark.parametrize("s,r", [([0, 40], [1, 0]), ([0, 1], [-1, 0])])
def test_prepare_bsr_refuses_arcs_outside_the_graph(s, r):
    with pytest.raises(ValueError, match="outside"):
        tops.prepare_bsr(40, np.array(s), np.array(r),
                         np.ones(2, np.float32), 16, device="cpu")


def test_bsr_spmm_is_registered_for_launch_counts():
    assert tops.KERNEL_MODULES["bsr_spmm"] is tbsr
    tops.reset_launch_counts()
    assert tops.launch_counts()["bsr_spmm"] == 0
    g = GRAPHS["molecules_8"]
    lay = tops.prepare_bsr(g.n_nodes, g.senders, g.receivers,
                           np.ones(g.n_arcs, np.float32), device="cpu")
    tops.gnn_aggregate_bsr(lay, torch.zeros(g.n_nodes, 8))
    assert tops.launch_counts()["bsr_spmm"] == 0   # plain CPU calls do not count
