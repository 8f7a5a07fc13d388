"""Port parity for the Wigner-D recursion (``repro_torch.models.so3``):
``block_diag_wigner`` and ``edge_rotation`` against the JAX package's on
the same numpy rotations and directions, the gradient through the edge
directions against ``jax.grad``, and the reference's own properties
(``tests/test_so3.py``: orthogonality, the homomorphism, ``Y(Rr) =
D(R) Y(r)``) on the port, through its copy of ``real_sph_harm``. Float32
unless said; each tolerance is stated where it is used."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import so3 as jso3
from repro_torch.models import so3

torch.set_num_threads(1)
# the recursion's products and sums in the same order in both packages:
# measured bitwise equal, held to the reference tests' 1e-5
WIGNER_TOL = 1e-5
# Rodrigues' formula: one 3x3 product (vx @ vx) summed in either order
ROT_TOL = 1e-6


def _rand_rot(n, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.linalg.det(q)[:, None, None]


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("l_max", [1, 2, 4, 6])
def test_block_diag_wigner_matches_the_reference(l_max):
    q = _rand_rot(16, seed=7).astype(np.float32)
    want = np.asarray(jso3.block_diag_wigner(jnp.asarray(q), l_max))
    got = so3.block_diag_wigner(_t(q), l_max).numpy()
    assert got.shape == want.shape == (16, (l_max + 1) ** 2,
                                       (l_max + 1) ** 2)
    assert np.abs(got - want).max() <= WIGNER_TOL


@pytest.mark.parametrize("l_max", [2, 6])
def test_wigner_d_stack_blocks_match_the_reference(l_max):
    q = _rand_rot(4, seed=8).astype(np.float32)
    want = jso3.wigner_d_stack(jnp.asarray(q), l_max)
    got = so3.wigner_d_stack(_t(q), l_max)
    assert len(got) == len(want) == l_max + 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= WIGNER_TOL


@pytest.mark.parametrize("l_max", [1, 2, 4, 6])
def test_orthogonality(l_max):
    d = so3.block_diag_wigner(_t(_rand_rot(8)), l_max).numpy()
    eye = np.eye(d.shape[-1])
    assert np.abs(d @ np.swapaxes(d, -1, -2) - eye).max() < 1e-5


@pytest.mark.parametrize("l_max", [2, 6])
def test_composition_homomorphism(l_max):
    q = _rand_rot(8, seed=1)
    d1 = so3.block_diag_wigner(_t(q[:4]), l_max).numpy()
    d2 = so3.block_diag_wigner(_t(q[4:]), l_max).numpy()
    d12 = so3.block_diag_wigner(_t(q[:4] @ q[4:]), l_max).numpy()
    assert np.abs(d12 - d1 @ d2).max() < 1e-5


@pytest.mark.parametrize("l_max", [1, 3, 6])
def test_rotates_real_spherical_harmonics(l_max):
    """Y(R r) = D(R) Y(r), the defining property, through the port's copy
    of the oracle (equal to the reference's)."""
    q = _rand_rot(8, seed=2)
    rng = np.random.default_rng(3)
    r = rng.normal(size=(8, 3))
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    np.testing.assert_array_equal(so3.real_sph_harm(r, l_max),
                                  jso3.real_sph_harm(r, l_max))
    d = so3.block_diag_wigner(_t(q), l_max).numpy()
    lhs = so3.real_sph_harm(np.einsum("bij,bj->bi", q, r), l_max)
    rhs = np.einsum("bmn,bn->bm", d, so3.real_sph_harm(r, l_max))
    assert np.abs(lhs - rhs).max() < 1e-5


def _directions():
    """Random unit directions and the rows the reference test adds: +z, -z
    and a direction 1e-8 off +z (the blend's branch), plus one within the
    antiparallel flip's 1e-5 of -z and an unnormalised one."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    extra = [[0, 0, 1.0], [0, 0, -1.0], [1e-8, 0, 1.0], [1e-3, 0, -1.0],
             [3.0, -4.0, 12.0]]
    return np.concatenate([d, extra]).astype(np.float32)


def test_edge_rotation_matches_the_reference():
    d = _directions()
    want = np.asarray(jso3.edge_rotation(jnp.asarray(d)))
    got = so3.edge_rotation(_t(d)).numpy()
    assert np.abs(got - want).max() <= ROT_TOL
    # the +z, -z and near-+z rows on their own: identity, the flip, ~identity
    np.testing.assert_allclose(got[64], np.eye(3), atol=ROT_TOL)
    np.testing.assert_allclose(got[65], np.diag([1.0, -1.0, -1.0]),
                               atol=ROT_TOL)
    np.testing.assert_allclose(got[66], np.asarray(want[66]), atol=ROT_TOL)


def test_edge_rotation_aligns_to_z():
    d = _directions()
    unit = d / np.linalg.norm(d, axis=-1, keepdims=True)
    r = so3.edge_rotation(_t(d)).numpy()
    z = np.einsum("bij,bj->bi", r, unit)
    # the flip stands in for every direction within its window of -z, so
    # it aligns those only up to their angle from -z (1e-3 for row 67)
    exact = np.ones(len(d), bool)
    exact[67] = False
    assert np.abs(z[exact] - np.asarray([0, 0, 1.0])).max() < 1e-5
    assert np.abs(z[67] - np.asarray([0, 0, 1.0])).max() < 2e-3
    assert np.abs(np.linalg.det(r) - 1).max() < 1e-5


def test_edge_rotation_and_wigner_batch_over_leading_axes():
    d = _directions()[:60].reshape(3, 4, 5, 3)
    r = so3.edge_rotation(_t(d))
    flat = so3.edge_rotation(_t(d.reshape(-1, 3)))
    assert torch.equal(r.reshape(-1, 3, 3), flat)
    ds = so3.wigner_d_stack(r, 3)
    assert tuple(ds[3].shape) == (3, 4, 5, 7, 7)
    assert torch.equal(ds[3].reshape(-1, 7, 7),
                       so3.wigner_d_stack(flat, 3)[3])


def test_gradient_through_the_edge_directions_matches_jax():
    """d/d(direction) of a fixed weighting of all the Wigner blocks at
    l_max 4: autograd through the port's recursion against ``jax.grad``
    of the reference's, rel L2 1e-5 (float32 chains of ~20 products)."""
    d = _directions()[:32]
    rng = np.random.default_rng(5)
    w = [rng.normal(size=(32, 2 * l + 1, 2 * l + 1)).astype(np.float32)
         for l in range(5)]

    def jloss(x):
        ds = jso3.wigner_d_stack(jso3.edge_rotation(x), 4)
        return sum(jnp.sum(a * jnp.asarray(b)) for a, b in zip(ds, w))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(d)))
    x = _t(d).requires_grad_(True)
    ds = so3.wigner_d_stack(so3.edge_rotation(x), 4)
    sum((a * _t(b)).sum() for a, b in zip(ds, w)).backward()
    got = x.grad.numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel


def test_tables_are_made_once_per_device_and_dtype():
    """The recursion's coefficient and index tensors are cached per (l,
    device, dtype): a second call reuses the same tensors."""
    q = _t(_rand_rot(2))
    so3.wigner_d_stack(q, 4)
    first = {k: v for k, v in so3._TABLES.items()
             if k[1] == "cpu" and k[2] == torch.float32}
    assert {k[0] for k in first} >= {2, 3, 4}
    so3.wigner_d_stack(q, 4)
    for k, v in first.items():
        assert so3._TABLES[k] is v
    so3.wigner_d_stack(q.double(), 2)
    assert so3._TABLES[(2, "cpu", torch.float64)]["u"].dtype == torch.float64
