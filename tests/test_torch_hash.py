"""Hash membership of the PyTorch port against the JAX package: the bucket
hash, the planar bucket table and the lookup.

- ``PauliEngine._mix2`` / ``_bucket_hash``: bit-equal to JAX's wrapping
  uint32 arithmetic on words at and above 2^31 (the port holds words in
  int64 and splits the multiplies).
- ``PauliEngine._hash_build``: the same table, compared as int32 bits, and
  the same ``table_overflow``, on H2O/STO-3G (one word), on a 40-qubit
  two-word embedding (``tests/test_local_energy.py``), and on a bucket that
  overflows.
- ``hash_lookup_plain`` (the port's CPU path): bit-equal to the Pallas
  kernel ``hash_lookup`` run in interpret mode, as
  ``tests/test_pallas_kernels.py`` runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from anqs_quantum_chemistry_tpu.chem.jw import jordan_wigner_pauli_hamiltonian
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_tpu.ops.pallas_kernels import (
    hash_lookup as pallas_hash_lookup,
)
from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    hash_lookup,
    hash_lookup_plain,
)
from torch_port_common import molecules

U32 = np.uint32


def _port_ham(jham):
    return PauliHamiltonian(
        qubit_num=jham.qubit_num, constant=jham.constant,
        a_masks=jham.a_masks, b_words=jham.b_words, weights=jham.weights,
        group_starts=jham.group_starts,
    )


def ham40(seed=20260816):
    """The 40-qubit (two-word) embedding of a random 12-orbital problem of
    ``tests/test_local_energy.py``: (JAX Hamiltonian, port Hamiltonian)."""
    rng = np.random.default_rng(seed)
    h1 = np.zeros((40, 40))
    sub = rng.standard_normal((12, 12))
    h1[:12, :12] = sub + sub.T
    v = np.zeros((40, 40, 40, 40))
    s4 = rng.standard_normal((12,) * 4)
    v[:12, :12, :12, :12] = s4 + s4.transpose(1, 0, 3, 2)
    jham = jordan_wigner_pauli_hamiltonian(h1, v)
    return jham, _port_ham(jham)


def _words40(rng, n=64):
    """Random states over the 12 active qubits plus a few high bits (so
    word 1 takes part in the hash), deduplicated like a sample set:
    (words (n, 2) int64, valid)."""
    bits = np.zeros((n, 40), np.int64)
    bits[:, :12] = rng.integers(0, 2, (n, 12))
    bits[:, 35:38] = rng.integers(0, 2, (n, 3))
    words = np.stack([
        (bits[:, :32] << np.arange(32)).sum(1),
        (bits[:, 32:] << np.arange(8)).sum(1),
    ], axis=1)
    words = np.unique(words, axis=0)
    valid = np.ones(len(words), bool)
    return words, valid


def _words_h2o(rng, n=128):
    words = np.unique(rng.integers(0, 1 << 14, n))[:, None]
    valid = np.ones(len(words), bool)
    valid[-5:] = False
    words[-5:] = 0xFFFFFFFF  # sentinel rows, invalid
    return words.astype(np.int64), valid


def _amps(rng, n):
    return (rng.standard_normal(n).astype(np.float32),
            rng.uniform(-3, 3, n).astype(np.float32))


def _builds(jeng, eng, words, la, ph, valid):
    jtab, jnb, jover = jeng._hash_build(
        jnp.asarray(words, jnp.uint32), jnp.asarray(la), jnp.asarray(ph),
        jnp.asarray(valid),
    )
    tab, nb, over = eng._hash_build(
        torch.from_numpy(words), torch.from_numpy(la), torch.from_numpy(ph),
        torch.from_numpy(valid),
    )
    return (np.asarray(jtab), jnb, int(jover)), (tab, nb, int(over))


@pytest.mark.parametrize("w", [1, 2, 3])
def test_bucket_hash_matches_jax(w):
    rng = np.random.default_rng(w)
    cols = rng.integers(0, 1 << 32, (w, 4096), dtype=np.int64)
    cols[:, :3] = [0xFFFFFFFF, 1 << 31, 0]  # edges
    assert (cols >= 1 << 31).mean() > 0.4
    jcols = tuple(jnp.asarray(c.astype(U32)) for c in cols)
    tcols = tuple(torch.from_numpy(c) for c in cols)
    want = np.asarray(JaxPauliEngine._bucket_hash(jcols)).astype(np.int64)
    np.testing.assert_array_equal(PauliEngine._bucket_hash(tcols).numpy(),
                                  want)
    if w == 2:
        np.testing.assert_array_equal(
            PauliEngine._mix2(*tcols).numpy(),
            np.asarray(JaxPauliEngine._mix2(*jcols)).astype(np.int64),
        )


@pytest.mark.parametrize("case", ["H2O", "ham40"])
@pytest.mark.parametrize("extra_bits", [0, 1])
def test_hash_build_matches_jax(case, extra_bits):
    rng = np.random.default_rng(3)
    if case == "H2O":
        jmol, mol = molecules("H2O")
        jham, ham = jmol.qubit_ham, mol.qubit_ham
        words, valid = _words_h2o(rng)
    else:
        jham, ham = ham40()
        words, valid = _words40(rng)
    la, ph = _amps(rng, len(words))
    jeng = JaxPauliEngine(jham, membership="hash",
                          hash_extra_bits=extra_bits)
    eng = PauliEngine(ham, device="cpu", membership="hash",
                      hash_extra_bits=extra_bits)
    (jtab, jnb, jover), (tab, nb, over) = _builds(jeng, eng, words, la, ph,
                                                  valid)
    assert nb == jnb and tab.shape == jtab.shape
    np.testing.assert_array_equal(tab.view(torch.int32).numpy(),
                                  jtab.view(np.int32))
    assert over == jover == 0


def test_hash_build_overflow_matches_jax():
    """40 keys in one bucket of a 64-row set: 8 overflow, in both."""
    rng = np.random.default_rng(11)
    cand = rng.integers(0, 1 << 32, 200_000, dtype=np.int64)
    bucket = PauliEngine._bucket_hash(
        (torch.from_numpy(cand),)).numpy() & 255  # nb = 256 at 64 rows
    same = np.unique(cand[bucket == np.bincount(bucket).argmax()])[:40]
    others = np.unique(cand[bucket != bucket[0]])[:24]
    words = np.concatenate([same, others])[:, None]
    valid = np.ones(64, bool)
    la, ph = _amps(rng, 64)
    jmol, mol = molecules("H2O")
    jeng = JaxPauliEngine(jmol.qubit_ham, membership="hash")
    eng = PauliEngine(mol.qubit_ham, device="cpu", membership="hash")
    (jtab, _, jover), (tab, _, over) = _builds(jeng, eng, words, la, ph,
                                               valid)
    np.testing.assert_array_equal(tab.view(torch.int32).numpy(),
                                  jtab.view(np.int32))
    assert over == jover >= 8


@pytest.mark.parametrize("case", ["H2O", "ham40"])
def test_hash_lookup_plain_matches_pallas(case):
    """Hits, misses that share key_lo with an entry, random misses, keys
    whose bits read as a float NaN, and sentinels."""
    rng = np.random.default_rng(5)
    if case == "H2O":
        jmol, mol = molecules("H2O")
        jham, ham = jmol.qubit_ham, mol.qubit_ham
        words, valid = _words_h2o(rng)
        words[0, 0] = 0x7FC00001  # NaN bits, a valid entry
    else:
        jham, ham = ham40()
        words, valid = _words40(rng)
        words[0] = [0x7FC00001, 0xFFC00000]
    la, ph = _amps(rng, len(words))
    jeng = JaxPauliEngine(jham, membership="hash")
    eng = PauliEngine(ham, device="cpu", membership="hash")
    (jtab, _, _), (tab, _, _) = _builds(jeng, eng, words, la, ph, valid)
    q = np.concatenate([
        words,
        words ^ rng.integers(1, 1 << 32, words.shape),
        rng.integers(0, 1 << 32, (300, words.shape[1])),
    ])
    if words.shape[1] == 2:  # key_lo of an entry, another key_hi
        q[len(words):2 * len(words), 0] = words[:, 0]
    q_lo = q[:, 0]
    q_hi = q[:, 1] if q.shape[1] > 1 else np.zeros_like(q_lo)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_hash_lookup(jnp.asarray(jtab), jnp.asarray(
            q_lo.astype(U32)), jnp.asarray(q_hi.astype(U32)))
    launches = hash_lookup.launches
    # The port's queries are the keys' 32-bit words as int32 bits, with no
    # high words at all for one-word keys.
    got = hash_lookup(
        tab, torch.from_numpy(q_lo.astype(U32).view(np.int32)),
        (torch.from_numpy(q_hi.astype(U32).view(np.int32))
         if q.shape[1] > 1 else None),
    )
    assert hash_lookup.launches == launches  # CPU: the plain version
    for g, w_ in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                      np.asarray(w_).view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    n_hit = int(valid.sum())
    assert int(got[2].sum()) >= n_hit and bool(got[2][0])


def test_hash_lookup_refuses_bad_tables():
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):  # bucket count not a power of two
        hash_lookup(torch.zeros((3, 128)), q, q)
    with pytest.raises(ValueError):  # not 128 lanes
        hash_lookup(torch.zeros((4, 64)), q, q)
    with pytest.raises(ValueError):  # query shapes differ
        hash_lookup(torch.zeros((4, 128)), q, q[:3])
    with pytest.raises(ValueError):  # int64 queries
        hash_lookup(torch.zeros((4, 128)), q.long(), None)
    with pytest.raises(ValueError):  # no kernel for this device
        hash_lookup(torch.zeros((4, 128), device="meta"), q, q)
    for q_hi in (q[:0], None):
        out = hash_lookup_plain(torch.zeros((4, 128)), q[:0], q_hi)
        assert [t.shape[0] for t in out] == [0, 0, 0]
