"""Port parity for the kernel layer: each kernel's plain PyTorch version
(the path CPU tensors take) against the reference op, both its XLA path
(``pallas=False``) and its Pallas kernel in interpret mode, on the same
numpy inputs; the vectorised ``to_ell`` against the reference loop; and
the device dispatch rules (CPU -> plain version, no launch counted;
another device -> error)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topology import balanced_tree as jbalanced_tree
from repro.core.topology import production_tree as jproduction_tree
from repro.graph.generators import rmat as jrmat
from repro.kernels import ops as jops
from repro_torch.kernels import bucket_assign, match_keys, ops
from repro_torch.kernels import partition_gain, quotient_link_loads

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
    ops.bucket_assign(x, torch.tensor([0.5]), 2)
    part = torch.zeros(64, dtype=torch.int32)
    idx = torch.full((64, 1), 64, dtype=torch.int32)
    ops.partition_gain(part, idx, torch.zeros(64, 1), 2)
    ops.link_loads(part, torch.zeros(3, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32), torch.ones(3),
                   torch.ones(2, 2), torch.ones(2), 2)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_MODULES}


@pytest.mark.parametrize("call", [
    lambda t: match_keys.match_keys(t, t, t),
    lambda t: bucket_assign.bucket_assign(t, t, 2),
    lambda t: partition_gain.partition_gain(t.int(), t.int()[:, None],
                                            t[:, None], 2),
    lambda t: quotient_link_loads.quotient_link_loads(
        t.int(), t.int(), t.int(), t, t[None, :], t[:1], 4),
], ids=["match_keys", "bucket_assign", "partition_gain",
        "quotient_link_loads"])
def test_wrappers_refuse_devices_without_a_kernel(call):
    """Dispatch is by the tensor's device: no silent plain path on a
    device other than the CPU (here ``meta``)."""
    with pytest.raises(ValueError, match="no kernel for device"):
        call(torch.zeros(4, device="meta"))
