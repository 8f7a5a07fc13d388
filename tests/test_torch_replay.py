"""A draw source for the port that replays the reference's ``jax.random``
key chain, so the two packages see the same random numbers; shared by the
port's parity tests (``from test_torch_replay import JaxDraws``). The tests
here pin the replay itself against the keys the reference derives."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.graph.graph import from_edges
from repro_torch.core.draws import TorchDraws

torch.set_num_threads(1)


def pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


class JaxDraws:
    """``repro_torch.core.draws.DrawSource`` over the reference's keys:

    * matching: ``coarsen_device`` folds the level into ``PRNGKey(seed)``
      and the round into that (``coarsen.py:142,208,225``), drawing over
      the power-of-two padded arc count, of which the first ``m`` are used;
    * refinement: one ``PRNGKey(seed)`` per trajectory, split once per
      round (``refine.py:213``); a dense round splits its key into the gate
      and thinning keys (``refine.py:98``), a sparse round first splits off
      the candidate key (``refine.py:188``).
    """

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def match(self, level, rnd, m):
        key = jax.random.fold_in(jax.random.fold_in(self.key, level), rnd)
        return np.array(jax.random.uniform(key, (pow2(m),)))[:m]

    def refine(self, seed, n, dense):
        key = jax.random.PRNGKey(seed)
        while True:
            key, sub = jax.random.split(key)
            yield round_draws(sub, n, dense)

    def cut_refine(self, seed, n):
        key = jax.random.PRNGKey(seed)
        while True:
            key, k_gate, k_thin = jax.random.split(key, 3)
            yield np.array(_cut_round_draws(k_gate, k_thin, n))


def round_draws(key, n, dense):
    """The ``[3, n]`` (candidate, gate, thin) uniforms one round of the
    reference draws from its round key."""
    return np.array(_round_draws(key, n, dense))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _round_draws(key, n, dense):
    if dense:
        u_cand = jnp.zeros(n, jnp.float32)
        k_move = key
    else:
        k_cand, k_move = jax.random.split(key)
        u_cand = jax.random.uniform(k_cand, (n,))
    k_gate, k_thin = jax.random.split(k_move)
    return jnp.stack([u_cand, jax.random.uniform(k_gate, (n,)),
                      jax.random.uniform(k_thin, (n,))])


@functools.partial(jax.jit, static_argnums=(2,))
def _cut_round_draws(k_gate, k_thin, n):
    return jnp.stack([jax.random.uniform(k_gate, (n,)),
                      jax.random.uniform(k_thin, (n,))])


def float_graph(n, m, seed=0):
    """The reference tests' random multigraph with float edge and node
    weights (``tests/test_device_vcycle.py:_rmat``)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32) + 0.1
    nw = rng.random(n).astype(np.float32) + 0.5
    return from_edges(n, u, v, w, nw)


def test_match_replay_follows_the_reference_key_chain():
    d = JaxDraws(seed=3)
    u = d.match(level=2, rnd=1, m=100)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 2), 1)
    np.testing.assert_array_equal(
        u, np.asarray(jax.random.uniform(key, (128,)))[:100])


def test_refine_replay_follows_the_reference_key_chain():
    it = JaxDraws().refine(seed=5, n=10, dense=False)
    first, second = next(it), next(it)
    key = jax.random.PRNGKey(5)
    key, sub = jax.random.split(key)
    k_cand, k_move = jax.random.split(sub)
    np.testing.assert_array_equal(first[0], jax.random.uniform(k_cand, (10,)))
    k_gate, _ = jax.random.split(k_move)
    np.testing.assert_array_equal(first[1], jax.random.uniform(k_gate, (10,)))
    _, sub2 = jax.random.split(key)
    np.testing.assert_array_equal(second, round_draws(sub2, 10, False))
    assert jnp.asarray(first).shape == (3, 10)


def test_cut_refine_replay_follows_the_reference_key_chain():
    draws = JaxDraws()
    it = draws.cut_refine(seed=4, n=12)
    first, second = next(it), next(it)
    key = jax.random.PRNGKey(4)
    key, k_gate, k_thin = jax.random.split(key, 3)
    np.testing.assert_array_equal(first[0], jax.random.uniform(k_gate, (12,)))
    np.testing.assert_array_equal(first[1], jax.random.uniform(k_thin, (12,)))
    _, k_gate, _ = jax.random.split(key, 3)
    np.testing.assert_array_equal(second[0],
                                  jax.random.uniform(k_gate, (12,)))
    # every call restarts from PRNGKey(seed), as every level does
    np.testing.assert_array_equal(next(draws.cut_refine(4, 12)), first)


def test_torch_draws_are_seeded_and_uniform():
    a = TorchDraws(7, torch.device("cpu"))
    b = TorchDraws(7, torch.device("cpu"))
    np.testing.assert_array_equal(a.match(0, 0, 1000), b.match(0, 0, 1000))
    r = next(a.refine(3, 5000, dense=True))
    assert r.shape == (3, 5000) and r.dtype == torch.float32
    assert 0.0 <= float(r.min()) and float(r.max()) < 1.0
    assert abs(float(r.mean()) - 0.5) < 0.02
    assert not torch.equal(next(a.refine(3, 50, True)),
                           next(a.refine(4, 50, True)))
    c = a.cut_refine(3, 40)
    c0 = next(c)
    assert c0.shape == (2, 40) and c0.dtype == torch.float32
    assert not torch.equal(c0, next(c))
    assert torch.equal(c0, next(b.cut_refine(3, 40)))
