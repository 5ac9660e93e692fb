"""Multi-word key sorting and dedup of the PyTorch port against the JAX
package (``ops/keys.py`` ``sort_words``, ``unique_mask``): exact equality,
on rows with duplicates, words at and above 2^31 and all-ones sentinels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.ops import keys as jkeys
from anqs_quantum_chemistry_torch.ops import keys


def _rows(w, n=200, seed=0):
    """(n, w) words: few distinct values per word (so rows tie on their
    high words and repeat whole), random full-range values, and all-ones
    sentinel rows."""
    rng = np.random.default_rng(seed + w)
    pool = np.array([0, 1, 5, (1 << 31) - 1, 1 << 31, 0xFFFFFFFE],
                    np.int64)
    words = pool[rng.integers(0, len(pool), (n, w))]
    words[::7] = rng.integers(0, 1 << 32, (len(words[::7]), w))
    words[::11] = 0xFFFFFFFF
    return words


@pytest.mark.parametrize("w", [1, 2, 3])
def test_sort_words_matches_jax(w):
    words = _rows(w)
    extra_f = np.arange(len(words), dtype=np.float32) * 0.5
    extra_b = (np.arange(len(words)) % 3 == 0)
    want = jkeys.sort_words(jnp.asarray(words, jnp.uint32),
                            jnp.asarray(extra_f), jnp.asarray(extra_b))
    got = keys.sort_words(torch.from_numpy(words), torch.from_numpy(extra_f),
                          torch.from_numpy(extra_b))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want[0]).astype(np.int64))
    # Stable: the same permutation, so the extras follow it identically.
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("w", [1, 2, 3])
def test_unique_mask_matches_jax(w):
    words = _rows(w, seed=5)
    valid = np.ones(len(words), bool)
    valid[-9:] = False
    jsorted = jkeys.sort_words(jnp.asarray(words, jnp.uint32))[0]
    tsorted = keys.sort_words(torch.from_numpy(words))[0]
    for v in (None, valid):
        want = jkeys.unique_mask(jsorted, None if v is None
                                 else jnp.asarray(v))
        got = keys.unique_mask(tsorted, None if v is None
                               else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < len(words)  # duplicates were present
