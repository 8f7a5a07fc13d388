"""Port parity for the kernel layer: each kernel's plain PyTorch version
(the path CPU tensors take) against the reference op, both its XLA path
(``pallas=False``) and its Pallas kernel in interpret mode, on the same
numpy inputs; the vectorised ``to_ell`` against the reference loop; and
the device dispatch rules (CPU -> plain version, no launch counted;
another device -> error). The bag reductions are held at rtol 1e-6 plus
the rounding bound of two D-term sums taken in different orders
(``bag_combine.order_tolerance``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topology import balanced_tree as jbalanced_tree
from repro.core.topology import production_tree as jproduction_tree
from repro.graph.generators import rmat as jrmat
from repro.kernels import bag_combine as jbag_combine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import (bag_combine, bsr_spmm, bucket_assign,
                                 gather_combine, match_keys, ops)
from repro_torch.kernels import (flash_attention, partition_gain,
                                 quotient_link_loads)

torch.set_num_threads(1)


@pytest.mark.parametrize("m", [1, 100, 4096, 10_001])
def test_match_keys_plain_matches_reference(m):
    rng = np.random.default_rng(m)
    w = rng.random(m).astype(np.float32)
    u = rng.random(m).astype(np.float32)
    mask = (rng.random(m) > 0.4).astype(np.float32)
    got = ops.match_keys(torch.from_numpy(w), torch.from_numpy(u),
                         torch.from_numpy(mask)).numpy()
    xla = np.asarray(jops.match_keys(jnp.asarray(w), jnp.asarray(u),
                                     jnp.asarray(mask), pallas=False))
    pal = np.asarray(jops.match_keys(jnp.asarray(w), jnp.asarray(u),
                                     jnp.asarray(mask), interpret=True))
    # f32 elementwise: the same ops, at most an FMA contraction apart
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, pal, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got < 0, mask == 0)


@pytest.mark.parametrize("n,k", [(1, 2), (700, 3), (4096, 64), (5000, 257)])
def test_bucket_assign_plain_matches_reference(n, k):
    rng = np.random.default_rng(n + k)
    nw = rng.random(n).astype(np.float32) + 0.1
    cum = (np.cumsum(nw) - 0.5 * nw).astype(np.float32)
    bounds = (np.cumsum(np.ones(k)) / k * nw.sum())[:-1].astype(np.float32)
    got = ops.bucket_assign(torch.from_numpy(cum), torch.from_numpy(bounds),
                            k).numpy()
    assert got.dtype == np.int32
    xla = np.asarray(jops.bucket_assign(jnp.asarray(cum), jnp.asarray(bounds),
                                        k, pallas=False))
    pal = np.asarray(jops.bucket_assign(jnp.asarray(cum), jnp.asarray(bounds),
                                        k, interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pal)


def test_bucket_assign_counts_unsorted_boundaries_exactly():
    """The count needs no sorted boundaries (a binary search would)."""
    cum = torch.tensor([0.5, 1.5, 2.5, 3.5])
    bounds = torch.tensor([3.0, 1.0, 2.0])
    got = bucket_assign.plain(cum, bounds, 4)
    np.testing.assert_array_equal(got.numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(bucket_assign.plain(cum, bounds, 2).numpy(),
                                  [0, 1, 1, 1])


@pytest.mark.parametrize("n,m,k", [(50, 150, 4), (200, 800, 16), (33, 70, 7)])
def test_partition_gain_plain_matches_reference(n, m, k):
    g = jrmat(n, m, seed=n + k)
    rng = np.random.default_rng(n)
    part = rng.integers(0, k, n).astype(np.int32)
    w = (rng.random(g.n_arcs).astype(np.float32) + 0.1)
    nbr_idx, nbr_w = jops.to_ell(n, g.senders, g.receivers, w)
    got = ops.partition_gain(torch.from_numpy(part), torch.from_numpy(nbr_idx),
                             torch.from_numpy(nbr_w), k).numpy()
    pal = np.asarray(jops.partition_gain_pallas(
        jnp.asarray(part), jnp.asarray(nbr_idx), jnp.asarray(nbr_w), k,
        interpret=True))
    arcs = np.asarray(jops.partition_gain(
        jnp.asarray(part), jnp.asarray(g.senders), jnp.asarray(g.receivers),
        jnp.asarray(w), k))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, arcs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,k", [(50, 150, 4), (200, 800, 16), (33, 70, 7)])
def test_partition_gain_plain_is_the_in_order_float32_sum(n, m, k):
    """The card's kernel is held bitwise to the in-order float32 sum
    (``np.add.at``); the plain version on the CPU is that sum too."""
    g = jrmat(n, m, seed=n + k)
    rng = np.random.default_rng(n)
    part = rng.integers(0, k, n).astype(np.int32)
    w = (rng.random(g.n_arcs).astype(np.float32) + 0.1)
    nbr_idx, nbr_w = jops.to_ell(n, g.senders, g.receivers, w)
    got = partition_gain.plain(torch.from_numpy(part),
                               torch.from_numpy(nbr_idx),
                               torch.from_numpy(nbr_w), k).numpy()
    want = np.zeros((n, k), np.float32)
    rows = np.repeat(np.arange(n), nbr_idx.shape[1]).reshape(nbr_idx.shape)
    real = nbr_idx < n
    np.add.at(want, (rows[real], part[nbr_idx[real]]), nbr_w[real])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,d,k,sms,rows,d_chunk,threads", [
    (2000, 19, 8, 132, 16, 19, 128),      # the small cell: 125 blocks
    (1280, 10, 4, 132, 10, 10, 64),       # serve_wide's pool
    (48, 6, 4, 132, 1, 6, 32),            # serve's pool: a block per row
    (1, 1, 2, 132, 1, 1, 32),
    (133, 12, 2, 132, 2, 12, 32),         # one row past a row per SM
    (8448, 20, 8, 132, 64, 20, 256),      # MAX_ROWS reached
    (100_000, 20, 2, 132, 64, 20, 128),
    (300, 15, 512, 132, 3, 15, 256),      # threads capped
    (8449, 300, 8, 132, 64, 96, 256),     # hub rows: slots in chunks
])
def test_partition_gain_tile_rule(n, d, k, sms, rows, d_chunk, threads):
    t = partition_gain.tile(n, d, k, sms)
    assert t == (rows, d_chunk, threads)
    assert t.threads % 32 == 0 and t.threads <= partition_gain.MAX_THREADS
    assert 8 * t.rows * t.d_chunk <= partition_gain.STAGE_BYTES
    # the fewest rows that keep the grid within one block per SM: one row
    # fewer would need more blocks than SMs
    assert -(-n // t.rows) <= sms or t.rows == partition_gain.MAX_ROWS
    assert t.rows == 1 or -(-n // (t.rows - 1)) > sms


@pytest.mark.parametrize("m,k,sms,blocks", [
    (0, 4, 132, 1),                   # empty arc list
    (2_048, 4, 132, 1),               # the crossover
    (2_049, 4, 132, 2),
    (4_270, 4, 132, 3),               # serve_wide's pool
    (8_192, 8, 132, 4),               # the small cell
    (122_656, 64, 132, 60),           # full cell, coarsest
    (1_548_288, 64, 132, 264),        # full cell, finest
    (1_548_288, 128, 132, 264),       # the largest W in shared memory
    (1_548_288, 129, 132, 264),
    (1_548_288, 512, 132, 264),
    (1_548_288, 512, 78, 156),        # fewer SMs, fewer blocks
    (10, 1, 132, 1),                  # k = 1
])
def test_quotient_link_loads_path_rule(m, k, sms, blocks):
    path = quotient_link_loads.qll_path(m, k, sms)
    assert path == (blocks, quotient_link_loads.THREADS,
                    4 * k * k if k <= 128 else 0)
    assert (blocks == 1) == (m <= quotient_link_loads.SINGLE_BLOCK_ARCS)
    assert blocks <= max(1, sms * quotient_link_loads.BLOCKS_PER_SM)
    assert blocks == 1 or blocks * quotient_link_loads.ARCS_PER_BLOCK >= min(
        m, sms * quotient_link_loads.BLOCKS_PER_SM
        * quotient_link_loads.ARCS_PER_BLOCK)


def test_quotient_link_loads_workspace_halves_alternate():
    """Each call takes the half of the workspace the call before zeroed;
    the halves alternate per (device, k)."""
    dev = torch.device("cpu")
    quotient_link_loads._workspaces.pop((dev, 3), None)
    ws, halves = None, []
    for _ in range(4):
        buf, half = quotient_link_loads._workspace(dev, 3)
        assert ws is None or buf is ws
        ws = buf
        halves.append(half)
    assert halves == [0, 1, 0, 1]
    assert ws.shape == (2 * 9 + 2,) and not ws.any()
    quotient_link_loads._workspaces.pop((dev, 3))


@pytest.mark.parametrize("topo_fn", [
    lambda: jbalanced_tree((2, 2)), lambda: jbalanced_tree((2, 2, 2)),
    lambda: jbalanced_tree((4, 4), level_cost=(4.5, 1.0)),
    lambda: jproduction_tree(2, 2, 4)],
    ids=["2x2", "2x2x2", "4x4_cost", "production"])
def test_quotient_link_loads_plain_matches_reference(topo_fn):
    topo = topo_fn()
    k = topo.k
    g = jrmat(120, 500, seed=k)
    rng = np.random.default_rng(k)
    part = rng.integers(0, k, 120).astype(np.int32)
    w = rng.random(g.n_arcs).astype(np.float32) + 0.1
    got = ops.link_loads(torch.from_numpy(part), torch.from_numpy(g.senders),
                         torch.from_numpy(g.receivers), torch.from_numpy(w),
                         torch.from_numpy(topo.subtree),
                         torch.from_numpy(topo.F_l), k).numpy()
    args = (jnp.asarray(part), jnp.asarray(g.senders),
            jnp.asarray(g.receivers), jnp.asarray(w),
            jnp.asarray(topo.subtree), jnp.asarray(topo.F_l), k)
    xla = np.asarray(jops.link_loads(*args, pallas=False))
    pal = np.asarray(jops.link_loads(*args, interpret=True))
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, pal, rtol=1e-4, atol=1e-3)


BAG_SHAPES = [(4, 5, 96, 128), (6, 7, 48, 64), (37, 7, 96, 300),
              (3, 1, 5, 11), (8, 50, 256, 1000)]


def _bag_inputs(b, d, f, v):
    rng = np.random.default_rng(b * d + f)
    table = rng.normal(0, 1, (v, f)).astype(np.float32)
    idx = rng.integers(0, v, (b, d)).astype(np.int32)
    w = rng.random((b, d)).astype(np.float32)
    return table, idx, w


def _assert_bag_close(got, want, rows, w):
    bound = bag_combine.order_tolerance(torch.from_numpy(rows),
                                        torch.from_numpy(w)).numpy()
    err = np.abs(got - np.asarray(want))
    assert (err <= 1e-6 * np.abs(np.asarray(want)) + bound).all(), err.max()


@pytest.mark.parametrize("b,d,f,v", BAG_SHAPES)
def test_bag_reductions_plain_match_reference(b, d, f, v):
    table, idx, w = _bag_inputs(b, d, f, v)
    rows = table[idx]
    t, i, ww = map(torch.from_numpy, (table, idx, w))
    jt, ji, jw = map(jnp.asarray, (table, idx, w))
    got = ops.embedding_bag(t, i, ww).numpy()
    for want in (jops.embedding_bag(jt, ji, jw, interpret=True),
                 jops.embedding_bag(jt, ji, jw, pallas=False),
                 jref.embedding_bag_ref(jt, ji, jw)):
        _assert_bag_close(got, want, rows, w)
    fused = ops.gather_combine(t, i, ww).numpy()
    _assert_bag_close(fused, jops.gather_combine(jt, ji, jw, interpret=True),
                      rows, w)
    assert np.array_equal(fused, got)   # the same plain einsum
    pre = bag_combine.bag_combine(torch.from_numpy(rows), ww).numpy()
    _assert_bag_close(pre, jbag_combine.bag_combine(
        jnp.asarray(rows), jw, interpret=True), rows, w)


def test_order_tolerance_bounds_a_reordered_sum():
    """The tolerance covers summing the same slots in reverse order."""
    table, idx, w = _bag_inputs(64, 50, 256, 1000)
    rows = torch.from_numpy(table[idx])
    ww = torch.from_numpy(w)
    fwd = torch.zeros(64, 256)
    rev = torch.zeros(64, 256)
    for j in range(50):
        fwd = fwd + ww[:, j, None] * rows[:, j]
        rev = rev + ww[:, 49 - j, None] * rows[:, 49 - j]
    assert not torch.equal(fwd, rev)
    assert ((fwd - rev).abs() <= bag_combine.order_tolerance(rows, ww)).all()


@pytest.mark.parametrize("case", ["csr", "shuffled", "capped", "isolated"])
def test_to_ell_matches_reference_loop(case):
    g = jrmat(80, 300, seed=3)
    s, r, w = g.senders, g.receivers, g.edge_weight.copy()
    w += np.arange(w.size, dtype=np.float32) * 1e-3   # distinguish arcs
    n, cap = g.n_nodes, None
    if case == "shuffled":
        perm = np.random.default_rng(3).permutation(s.size)
        s, r, w = s[perm], r[perm], w[perm]
    elif case == "capped":
        cap = 3
    elif case == "isolated":
        n = g.n_nodes + 5                      # trailing vertices, no arcs
    ref_idx, ref_w = jops.to_ell(n, s, r, w, max_degree=cap)
    idx, ew = ops.to_ell(n, s, r, w, max_degree=cap)
    assert idx.dtype == ref_idx.dtype and ew.dtype == ref_w.dtype
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(ew, ref_w)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random(64).astype(np.float32))
    ops.match_keys(x, x, x)
    arcs = torch.arange(64, dtype=torch.int32) % 8
    ops.match_round(arcs, arcs.flip(0), x, x, torch.zeros(8, dtype=torch.bool))
    ops.bucket_assign(x, torch.tensor([0.5]), 2)
    part = torch.zeros(64, dtype=torch.int32)
    idx = torch.full((64, 1), 64, dtype=torch.int32)
    ops.partition_gain(part, idx, torch.zeros(64, 1), 2)
    ops.link_loads(part, torch.zeros(3, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32), torch.ones(3),
                   torch.ones(2, 2), torch.ones(2), 2)
    bags = torch.zeros(4, 3, dtype=torch.int32)
    ops.embedding_bag(x.view(16, 4), bags, torch.ones(4, 3))
    ops.gather_combine(x.view(16, 4), bags, torch.ones(4, 3))
    lay = ops.prepare_bsr(64, np.arange(63), np.arange(1, 64),
                          np.ones(63, np.float32), 16, device="cpu")
    ops.gnn_aggregate_bsr(lay, x.view(64, 1))
    ops.flash_attention(x.view(1, 16, 2, 2), x.view(1, 16, 2, 2)[:, :, :1],
                        x.view(1, 16, 2, 2)[:, :, 1:])
    assert set(ops.KERNEL_MODULES) == {
        "match_keys", "bucket_assign", "quotient_link_loads",
        "partition_gain", "bag_combine", "gather_combine", "bsr_spmm",
        "flash_attention"}
    ops.prefix_split(x, torch.tensor([0.5]), 2)
    assert ops.launch_counts() == {name: 0 for name in
                                   [*ops.KERNEL_MODULES, "match_round",
                                    "prefix_split"]}


@pytest.mark.parametrize("call,refused", [
    (lambda t: match_keys.match_keys(t, t, t), True),
    (lambda t: bucket_assign.bucket_assign(t, t, 2), True),
    (lambda t: partition_gain.partition_gain(t.int(), t.int()[:, None],
                                             t[:, None], 2), True),
    (lambda t: quotient_link_loads.quotient_link_loads(
        t.int(), t.int(), t.int(), t, t[None, :], t[:1], 4), True),
    (lambda t: bag_combine.bag_combine(t.view(1, 2, 2), t.view(2, 2)[:1]),
     True),
    (lambda t: gather_combine.gather_combine(t.view(2, 2),
                                             t.int().view(2, 2),
                                             t.view(2, 2)), True),
    (lambda t: bsr_spmm.bsr_spmm(t.int()[:2], t.int()[:1], t.view(1, 2, 2),
                                 t.view(2, 2), t.int().view(1, 1, 4)[..., :1]),
     True),
    (lambda t: flash_attention.flash_attention(
        t.view(1, 2, 1, 2), t.view(1, 2, 1, 2), t.view(1, 2, 1, 2)), False),
    (lambda t: bucket_assign.prefix_split(t, t[:1], 2), True),
], ids=["match_keys", "bucket_assign", "partition_gain",
        "quotient_link_loads", "bag_combine", "gather_combine", "bsr_spmm",
        "flash_attention", "prefix_split"])
def test_wrappers_refuse_devices_without_a_kernel(call, refused):
    """Dispatch is by the tensor's device: no silent plain path on a
    device other than the CPU (here ``meta``). The one exception is
    ``flash_attention``, whose plain version takes meta tensors for the
    placement session's trace: it returns an empty output of the right
    shape on meta and computes nothing."""
    if refused:
        with pytest.raises(ValueError, match="no kernel for device"):
            call(torch.zeros(4, device="meta"))
    else:
        out = call(torch.zeros(4, device="meta"))
        assert out.device.type == "meta" and tuple(out.shape) == (1, 2, 1, 2)


def _bf16_bag_inputs(b, d, f, v):
    rng = np.random.default_rng(b + d + f)
    table = rng.normal(0, 1, (v, f)).astype(np.float32)
    idx = rng.integers(0, v, (b, d)).astype(np.int32)
    w = rng.random((b, d)).astype(np.float32)
    return torch.from_numpy(table).to(torch.bfloat16), idx, w


@pytest.mark.parametrize("b,d,f,v", [(4, 5, 96, 128), (37, 7, 256, 500),
                                     (3, 6, 33, 64)])
def test_gather_combine_bf16_plain_matches_reference(b, d, f, v):
    """A bf16 table: the plain version against the reference kernel in
    interpret mode at the reference's own bf16 band and bag depths
    (``tests/test_embed.py``: rtol = atol = 2e-2; the reference rounds
    each slot's product into its bf16 output block, so its error grows
    with D)."""
    t16, idx, w = _bf16_bag_inputs(b, d, f, v)
    got = gather_combine.gather_combine(t16, torch.from_numpy(idx),
                                        torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == (b, f)
    ref = jops.gather_combine(jnp.asarray(t16.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(idx), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,d,f,v", [(4, 5, 96, 128), (16, 50, 256, 1000),
                                     (3, 50, 33, 64)])
def test_gather_combine_bf16_plain_rounds_the_float32_sum_once(b, d, f, v):
    """The plain version on a bf16 table is the float32 sum of the bf16
    rows (numpy, float64 products summed in float32 order aside) rounded
    once to bf16: within one bf16 ulp of it."""
    t16, idx, w = _bf16_bag_inputs(b, d, f, v)
    got = gather_combine.gather_combine(t16, torch.from_numpy(idx),
                                        torch.from_numpy(w))
    rows = t16.float().numpy()[idx]
    want = torch.from_numpy(np.einsum("bdf,bd->bf", rows, w)).to(
        torch.bfloat16).float()
    err = (got.float() - want).abs()
    ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want)[1] - 8)
    assert bool((err <= ulp).all()), float((err / ulp).max())


def test_gather_combine_plain_keeps_float32_unchanged():
    """In float32 the plain version is the gather and einsum it was
    (``repro/kernels/ref.py``): bitwise ``embedding_bag``'s plain path."""
    table, idx, w = _bag_inputs(64, 50, 256, 1000)
    t, i, ww = map(torch.from_numpy, (table, idx, w))
    want = torch.einsum("bdf,bd->bf", t[i], ww)
    assert torch.equal(gather_combine.plain(t, i, ww), want)
    assert gather_combine.plain(t, i, ww).dtype == torch.float32


@pytest.mark.parametrize("b,d,f", [(32, 10, 64), (100, 5, 200), (8, 50, 32)])
def test_bag_combine_bf16_plain_matches_reference(b, d, f):
    """bf16 rows and weights: the plain version against the reference
    kernel in interpret mode at the reference's own bf16 cases and band
    (``tests/test_kernels.py``: rtol = atol = 5e-2); bf16 out."""
    rng = np.random.default_rng(b + d + f)
    g16 = torch.from_numpy(rng.normal(size=(b, d, f)).astype(
        np.float32)).to(torch.bfloat16)
    w16 = torch.from_numpy(rng.normal(size=(b, d)).astype(
        np.float32)).to(torch.bfloat16)
    got = bag_combine.bag_combine(g16, w16)
    assert got.dtype == torch.bfloat16 and got.shape == (b, f)
    ref = jbag_combine.bag_combine(
        jnp.asarray(g16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w16.float().numpy()).astype(jnp.bfloat16),
        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("b,d,f", [(32, 10, 64), (16, 50, 256), (1, 50, 256)])
def test_bag_combine_bf16_plain_rounds_the_float32_sum_once(b, d, f):
    """The plain version on bf16 rows and weights is the float32 sum of the
    bf16 values rounded once to bf16 (within one bf16 ulp of numpy's), as
    the kernel sums; float32 inputs keep their einsum bitwise."""
    rng = np.random.default_rng(b * d)
    g16 = torch.from_numpy(rng.normal(size=(b, d, f)).astype(
        np.float32)).to(torch.bfloat16)
    w16 = torch.from_numpy(rng.random((b, d)).astype(np.float32)).to(
        torch.bfloat16)
    got = bag_combine.plain(g16, w16)
    want = torch.from_numpy(np.einsum(
        "bdf,bd->bf", g16.float().numpy(), w16.float().numpy())).to(
        torch.bfloat16).float()
    err = (got.float() - want).abs()
    ulp = torch.ldexp(torch.ones_like(err), torch.frexp(want)[1] - 8)
    assert bool((err <= ulp).all()), float((err / ulp).max())
    g, w = g16.float(), w16.float()
    assert torch.equal(bag_combine.plain(g, w),
                       torch.einsum("bdf,bd->bf", g, w))


def _jax_graph(g):
    from repro.graph.graph import from_edges as jfrom_edges
    return jfrom_edges(g.n_nodes, g.senders, g.receivers, g.edge_weight,
                       g.node_weight)


def _split_cases():
    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.topology import (balanced_tree, production_tree,
                                           with_bin_speed)
    from repro_torch.graph.generators import grid2d, grid3d, rmat
    return [
        ("grid2d_k2", lambda: grid2d(30, 30), lambda: balanced_tree((2,))),
        ("grid3d_k16", lambda: grid3d(12, 12, 12),
         lambda: balanced_tree((4, 4))),
        ("rmat_superpod", lambda: rmat(3000, 12000, seed=1),
         lambda: MachineSpec.preset("gpu-superpod").tree()),
        ("grid3d_k512", lambda: grid3d(16, 16, 16),
         lambda: production_tree(2, 16, 16)),
        ("rmat_speeds", lambda: rmat(2000, 8000, seed=2),
         lambda: with_bin_speed(balanced_tree((4, 4)),
                                [1.0] * 8 + [0.5] * 8)),
    ]


def _integer_weights(g, seed):
    import dataclasses
    w = np.random.default_rng(seed).integers(1, 6, g.n_nodes)
    return dataclasses.replace(g, node_weight=w.astype(np.float32))


@pytest.mark.parametrize("case", [c[0] for c in _split_cases()])
def test_prefix_split_plain_matches_reference_initial(case):
    """``initial_partition_device`` through ``prefix_split``'s plain version
    against the reference's on the same graph and tree, with integer node
    weights (every scan exact): equal bins, every bin in [0, k-1], and
    non-decreasing in the vertex order."""
    from repro.core.initial import initial_partition_device as jinitial
    from repro.core.topology import make_tree as jmake_tree
    from repro.core.topology import with_bin_speed as jwith_speed
    from repro_torch.core.initial import initial_partition_device
    _, mk_g, mk_t = next(c for c in _split_cases() if c[0] == case)
    g, topo = _integer_weights(mk_g(), 3), mk_t()
    got = initial_partition_device(g, topo, device="cpu")
    jtopo = jmake_tree(topo.parent, topo.is_router)
    if topo.bin_speed is not None:
        jtopo = jwith_speed(jtopo, topo.bin_speed)
    want = jinitial(_jax_graph(g), jtopo)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= topo.k - 1
    assert (np.diff(got) >= 0).all()
    assert len(np.unique(got)) == topo.k


def test_prefix_split_plain_with_float_weights_within_the_scan_rounding():
    """Float node weights: the port's float32 cumsum and the reference's
    scan round apart, so a bin may differ only where the float64 midpoint
    lies within 2^-18 of the total of a boundary."""
    from repro.core.initial import initial_partition_device as jinitial
    from repro.core.topology import balanced_tree as jbt
    from repro_torch.core.initial import initial_partition_device
    from repro_torch.core.topology import balanced_tree
    from repro_torch.graph.generators import rmat, weighted_nodes
    g = weighted_nodes(rmat(6000, 24000, seed=5), seed=5, lo=0.1, hi=8.0)
    got = initial_partition_device(g, balanced_tree((8, 8)), device="cpu")
    want = jinitial(_jax_graph(g), jbt((8, 8)))
    nw = g.node_weight.astype(np.float64)
    cum = np.cumsum(nw) - 0.5 * nw
    bounds = np.arange(1, 64) / 64 * nw.sum()
    near = (np.abs(cum[:, None] - bounds[None, :])
            <= 2.0 ** -18 * nw.sum()).any(1)
    assert ((got == want) | near).all()
    assert (np.diff(got) >= 0).all()


def test_prefix_split_plain_is_the_bucket_assign_of_the_float32_cumsum():
    rng = np.random.default_rng(0)
    nw = torch.from_numpy(rng.random(5000).astype(np.float32) + 0.1)
    b = torch.from_numpy((np.arange(1, 64) / 64 * float(nw.double().sum()))
                         .astype(np.float32))
    cum = torch.cumsum(nw, 0) - 0.5 * nw
    assert torch.equal(ops.prefix_split(nw, b, 64),
                       bucket_assign.plain(cum, b, 64))
    assert torch.equal(ops.prefix_split(nw, b, 64), torch.from_numpy(
        ops.prefix_split_host(nw.numpy(), b.numpy(), 64,
                              torch.device("cpu"))))


def test_prefix_split_refuses_unsorted_boundaries():
    nw = torch.ones(8)
    with pytest.raises(ValueError, match="non-decreasing"):
        ops.prefix_split(nw, torch.tensor([3.0, 1.0, 2.0]), 4)
    with pytest.raises(ValueError, match="non-decreasing"):
        ops.prefix_split_host(nw.numpy(), np.array([2.0, 1.0], np.float32),
                              3, torch.device("cpu"))
    # equal boundaries are non-decreasing: a bin may stay empty
    got = ops.prefix_split(nw, torch.tensor([4.0, 4.0, 4.0]), 4)
    np.testing.assert_array_equal(got.numpy(), [0] * 4 + [3] * 4)
