"""Port parity: ``repro_torch.random`` (threefry2x32) against
``jax.random`` with jax's defaults (threefry2x32, partitionable), and
the port's slot-keyed batch draws against the reference's.

Every comparison is exact: key words and float bit patterns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import device_data as ref_dd
from repro_torch import random as trandom
from repro_torch.fl import device_data

SEEDS = [0, 1, 42, 2**31 - 1, 123456789]


def key_words(k):
    return np.asarray(k).astype(np.int64)


def test_jax_defaults_are_the_ported_ones():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    k, kt = jax.random.PRNGKey(seed), trandom.prng_key(seed)
    np.testing.assert_array_equal(key_words(k), kt.numpy())
    for d in [0, 1, 7, 1000, 2**31 - 1]:
        np.testing.assert_array_equal(key_words(jax.random.fold_in(k, d)),
                                      trandom.fold_in(kt, d).numpy())
    for num in [2, 3, 5]:
        np.testing.assert_array_equal(key_words(jax.random.split(k, num)),
                                      trandom.split(kt, num).numpy())


@pytest.mark.parametrize("seed", [0, 2**31 - 1, 123456789])
@pytest.mark.parametrize("shape", [(), (7,), (2, 16), (3, 5, 4)])
def test_uniform_bits(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    a = np.asarray(jax.random.uniform(k, shape))
    b = trandom.uniform(trandom.fold_in(trandom.prng_key(seed), 3),
                        shape).numpy()
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_batched_keys_match_per_key():
    base = trandom.prng_key(5)
    ks = trandom.fold_in(base, torch.arange(4))
    for i in range(4):
        np.testing.assert_array_equal(
            ks[i].numpy(), key_words(jax.random.fold_in(
                jax.random.PRNGKey(5), i)))


@pytest.mark.parametrize("seed,rnd,K,E,b", [(0, 0, 4, 2, 16),
                                            (3, 17, 13, 2, 16),
                                            (7, 5, 1, 3, 8)])
def test_sample_positions_identical(seed, rnd, K, E, b):
    ref_m, ref_p = ref_dd.sample_positions(jax.random.PRNGKey(seed), rnd,
                                           K, E, b)
    m, p = device_data.sample_positions(trandom.prng_key(seed), rnd, K, E, b)
    assert np.asarray(ref_m).tobytes() == m.numpy().tobytes()
    assert np.asarray(ref_p).tobytes() == p.numpy().tobytes()


def test_sample_positions_chunk_equals_rounds():
    """Drawing a chunk of rounds at once equals drawing each round."""
    key = trandom.prng_key(11)
    rounds = torch.tensor([4, 5, 9])
    m, p = device_data.sample_positions(key, rounds, 6, 2, 4)
    for i, r in enumerate(rounds.tolist()):
        mr, pr = device_data.sample_positions(key, r, 6, 2, 4)
        assert torch.equal(m[i], mr) and torch.equal(p[i], pr)


def test_positions_and_gather_identical():
    rng = np.random.default_rng(0)
    parts = [rng.choice(50, size=s, replace=False) for s in (5, 9, 1, 20)]
    from repro.fl.partition import dense_index_pools
    pools, sizes = dense_index_pools(parts)
    rows = np.array([3, 0, 2, 1])
    _, pos_u = ref_dd.sample_positions(jax.random.PRNGKey(2), 1, 4, 2, 8)
    ref_idx = ref_dd.positions_to_indices(jnp.asarray(pools),
                                          jnp.asarray(sizes),
                                          jnp.asarray(rows), pos_u)
    idx = device_data.positions_to_indices(
        torch.as_tensor(pools.astype(np.int64)),
        torch.as_tensor(sizes.astype(np.int64)), torch.as_tensor(rows),
        torch.as_tensor(np.array(pos_u)))
    np.testing.assert_array_equal(np.asarray(ref_idx), idx.numpy())


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_dropout_mask_identical(rate):
    mask_u, _ = ref_dd.sample_positions(jax.random.PRNGKey(1), 2, 6, 1, 1)
    active = np.array([1, 1, 1, 1, 0, 0], np.float32)
    a = ref_dd.dropout_mask(mask_u, jnp.asarray(active), rate)
    b = device_data.dropout_mask(torch.as_tensor(np.array(mask_u)),
                                 torch.as_tensor(active), rate)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
