"""Bit and key ops of the PyTorch port against the JAX package on random
words, exact equality. JAX holds words as uint32, the port as int64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.ops import keys as jkeys
from anqs_quantum_chemistry_torch.ops import bits, keys


def _words(rng, rows, w):
    return rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64)


def _j(words):
    return jnp.asarray(words.astype(np.uint32))


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


@pytest.mark.parametrize("n", [12, 20, 32, 45, 84])
def test_pack_unpack(rng, n):
    b = rng.integers(0, 2, size=(64, n))
    packed = bits.pack(torch.from_numpy(b))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jbits.pack(jnp.asarray(b))).astype(np.int64)
    )
    np.testing.assert_array_equal(bits.unpack(packed, n).numpy(), b)
    assert bits.n_words(n) == jbits.n_words(n)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_popcount_parity(rng, w):
    words = _words(rng, 256, w)
    np.testing.assert_array_equal(
        bits.popcount(_t(words)).numpy(), np.asarray(jbits.popcount(_j(words)))
    )
    np.testing.assert_array_equal(
        bits.parity(_t(words)).numpy(), np.asarray(jbits.parity(_j(words)))
    )


@pytest.mark.parametrize("start,width", [(0, 10), (10, 10), (26, 10),
                                         (30, 6), (40, 12), (32, 32)])
def test_bit_ranges(rng, start, width):
    words = _words(rng, 128, 3)
    got = bits.get_bit_range(_t(words), start, width).numpy()
    want = np.asarray(jbits.get_bit_range(_j(words), start, width))
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    got_dyn = bits.get_bit_range_dyn(_t(words), torch.tensor(start), width)
    want_dyn = jbits.get_bit_range_dyn(_j(words), jnp.int32(start), width)
    np.testing.assert_array_equal(
        got_dyn.numpy(), np.asarray(want_dyn).astype(np.uint32)
    )

    # Writing into an all-zero range, static and traced start.
    base = words.copy()
    base_bits = bits.unpack(_t(base), 96)
    base_bits[:, start:start + width] = 0
    base = bits.pack(base_bits).numpy().astype(np.uint64)
    value = rng.integers(0, 2**width, size=128, dtype=np.uint64)
    jval = jnp.asarray(value.astype(np.uint32))
    want = np.asarray(jbits.set_bit_range(_j(base), start, width, jval))
    np.testing.assert_array_equal(
        bits.set_bit_range(_t(base), start, width, _t(value)).numpy(), want
    )
    want_dyn = jbits.set_bit_range_dyn(_j(base), jnp.int32(start), width,
                                       jval)
    np.testing.assert_array_equal(
        bits.set_bit_range_dyn(_t(base), torch.tensor(start), width,
                               _t(value)).numpy(),
        np.asarray(want_dyn),
    )


@pytest.mark.parametrize("w", [1, 2])
def test_keys_search(rng, w):
    table = np.unique(_words(rng, 300, w) % np.uint64(1 << 12), axis=0)
    # Canonical order: most significant word first.
    table = table[np.lexsort(table.T)]
    queries = np.concatenate([table[rng.integers(0, len(table), 100)],
                              _words(rng, 100, w) % np.uint64(1 << 12)])
    idx, found = keys.searchsorted_words(_t(table), _t(queries))
    jidx, jfound = jkeys.searchsorted_words(_j(table), _j(queries))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    a, b = _t(queries[:100]), _t(queries[100:])
    np.testing.assert_array_equal(
        keys.lex_less(a, b).numpy(),
        np.asarray(jkeys.lex_less(_j(queries[:100]), _j(queries[100:]))),
    )
    np.testing.assert_array_equal(
        keys.lex_eq(a, a).numpy(), np.ones(100, bool)
    )
