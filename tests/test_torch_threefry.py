"""The port's threefry PRNG against JAX's, bit for bit.

The Random eviction expert's proposal depends on every bit of its per-line
uniforms, so the port's key split and ``uniform`` must reproduce JAX's
threefry2x32 (partitionable mode) exactly.
"""
import numpy as np
import pytest

import jax
import torch

from repro.kernels.ref import cache_scan_noise as jax_noise
from repro_torch.kernels import threefry


def _words(key):
    return tuple(int(x) for x in np.asarray(key))


@pytest.mark.parametrize("seed", [0, 5, 9, 123456, 2**31 - 1])
def test_prng_key_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == _words(key)
    new, draw = jax.random.split(key)
    assert threefry.split(threefry.prng_key(seed)) == (_words(new),
                                                       _words(draw))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 513])
def test_uniform_f32_bit_equal(n):
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = threefry.uniform_f32(*_words(key), n).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,length,n_lines",
                         [(0, 16, 1), (3, 40, 37), (9, 64, 513),
                          (123, 5, 2048)])
def test_cache_scan_noise_bit_equal(seed, length, n_lines):
    want = np.asarray(jax_noise(jax.random.PRNGKey(seed), length, n_lines))
    got = threefry.cache_scan_noise(threefry.prng_key(seed), length,
                                    n_lines).numpy()
    assert got.shape == (length, n_lines)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_key_chain_follows_iterated_split():
    key = jax.random.PRNGKey(11)
    want = []
    for _ in range(6):
        key, draw = jax.random.split(key)
        want.append(_words(draw))
    assert threefry.key_chain(threefry.prng_key(11), 6) == want


def test_uniform_rows_of_tensor_keys():
    """Per-row draw keys as int64 tensors give one row of draws each."""
    keys = [jax.random.split(jax.random.PRNGKey(s))[1] for s in (1, 2, 3)]
    k = torch.tensor([_words(x) for x in keys], dtype=torch.int64)
    got = threefry.uniform_f32(k[:, 0], k[:, 1], 33).numpy()
    for r, key in enumerate(keys):
        want = np.asarray(jax.random.uniform(key, (33,)))
        np.testing.assert_array_equal(got[r].view(np.uint32),
                                      want.view(np.uint32))


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        threefry.prng_key(2**31)
