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
- ``hash_tags_plain``: the slot tags that the CUDA kernel filters with,
  against a numpy uint32 transcription of the tag of each slot's key; and a
  torch transcription of the kernel's tag filter, which must select what
  ``hash_lookup_plain`` selects.
- ``fp_filter`` (kernel #3's wrapper) refuses operands that no layout
  takes, and picks its table's tier from the table's shape.
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
from anqs_quantum_chemistry_torch.chem.fci import random_sector_dets
from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
from anqs_quantum_chemistry_torch.chem.molecule import load_li2o, load_n2
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.bits import MASK32
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    ENTRIES,
    NEG,
    fp_filter,
    fp_in_shared_memory,
    hash_lookup,
    hash_lookup_plain,
    hash_tags,
    hash_tags_plain,
    mix2,
    tag_of,
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


def _np_tag(lo, hi):
    """Tag of uint32 key words, in numpy's wrapping uint32 arithmetic."""
    with np.errstate(over="ignore"):
        acc = lo.astype(U32) * U32(2654435761)
        acc ^= acc >> U32(15)
        acc = (acc ^ hi.astype(U32)) * U32(2654435761)
        acc ^= acc >> U32(15)
        acc *= U32(2246822519)
        acc ^= acc >> U32(13)
    t = acc >> U32(24)
    return np.where(t == 0, 1, t).astype(np.uint8)


def _tag_table(case):
    """A ``_hash_build`` table: (table, valid key words (n, 2) uint32)."""
    rng = np.random.default_rng(21)
    if case == "li2o":  # 8192 sampled rows of Li2O's sector, one word
        mol = load_li2o()
        dets = np.unique(random_sector_dets(mol.n_orbitals, mol.n_alpha,
                                            mol.n_beta, 8400, rng))[:8192]
        words = dets.astype(np.int64)[:, None]
    else:  # two words of random bits, some of them invalid
        words = rng.integers(0, 1 << 32, (4096, 2), dtype=np.int64)
        words[0] = [0x7FC00001, 0xF149F2CA]  # NaN and NEG bits
    valid = np.ones(len(words), bool)
    valid[-7:] = False
    la, ph = _amps(rng, len(words))
    eng = PauliEngine(load_n2().qubit_ham, device="cpu", membership="hash")
    tab, _, overflow = eng._hash_build(
        *(torch.from_numpy(a) for a in (words, la, ph, valid)))
    assert int(overflow) == 0
    keys = np.zeros((int(valid.sum()), 2), U32)
    keys[:, :words.shape[1]] = words[valid]
    return tab, keys

def test_fp_filter_refuses_bad_operands():
    fp = torch.zeros((4, 32), dtype=torch.int32)
    rows = torch.zeros((3, 2), dtype=torch.int64)
    a = torch.zeros((2, 5), dtype=torch.int32)
    assert fp_filter(fp, rows, a).shape == (3, 5)
    assert fp_filter(fp, rows[:0], a).shape == (0, 5)
    w3 = (torch.zeros((3, 3), dtype=torch.int64),
          torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):  # bucket count not a power of two
        fp_filter(fp[:3], rows, a)
    with pytest.raises(ValueError):  # E 32 at W 3: no layout
        fp_filter(fp, *w3)
    with pytest.raises(ValueError):  # masks of another word count
        fp_filter(fp, rows, a[:1])
    with pytest.raises(ValueError):  # int32 rows
        fp_filter(fp, rows.int(), a)
    with pytest.raises(ValueError):  # no kernel for this device
        fp_filter(fp.to("meta"), rows.to("meta"), a.to("meta"))
    # The tier follows nb x E x 4 bytes: Cr2's 32 KB table is staged in
    # shared memory, C2H4's escalated 256 KB one is probed in L2.
    assert fp_in_shared_memory(512, 16) and fp_in_shared_memory(512, 32)
    assert not fp_in_shared_memory(1024, 32)
    assert not fp_in_shared_memory(2048, 32)


@pytest.mark.parametrize("case", ["li2o", "w2"])
def test_hash_tags_plain(case):
    """Every live slot carries its key's tag, never the empty tag 0, and
    every empty slot carries 0."""
    tab, keys = _tag_table(case)
    launches = hash_tags.launches
    tags = hash_tags(tab)
    assert hash_tags.launches == launches  # CPU: the plain version
    assert tags.dtype == torch.uint8 and tags.shape == (tab.shape[0], 32)
    assert torch.equal(tags, hash_tags_plain(tab))
    tags = tags.numpy()
    bits = tab.view(torch.int32).numpy().view(U32)
    live = tab[:, 2 * ENTRIES:3 * ENTRIES].numpy() > 0.5 * NEG
    assert live.sum() == len(keys)
    slot_keys = np.stack([bits[:, :ENTRIES][live],
                          bits[:, ENTRIES:2 * ENTRIES][live]], axis=1)
    np.testing.assert_array_equal(np.unique(slot_keys, axis=0),
                                  np.unique(keys, axis=0))
    np.testing.assert_array_equal(tags[live],
                                  _np_tag(slot_keys[:, 0], slot_keys[:, 1]))
    assert np.all(tags[live] != 0) and np.all(tags[~live] == 0)


def _lookup_via_tags(tab, q_lo, q_hi):
    """The kernel's selection, transcribed: only the slots whose tag
    equals the query's are compared, in ascending order."""
    if q_hi is None:
        q_hi = torch.zeros_like(q_lo)
    tags = hash_tags_plain(tab)
    h = mix2(q_lo.to(torch.int64) & MASK32, q_hi.to(torch.int64) & MASK32)
    bucket = h & (tab.shape[0] - 1)
    rows = tab.view(torch.int32)[bucket]
    la_e = rows[:, 2 * ENTRIES:3 * ENTRIES].view(torch.float32)
    match = (
        (tags[bucket] == tag_of(h)[:, None])
        & (rows[:, :ENTRIES] == q_lo[:, None])
        & (rows[:, ENTRIES:2 * ENTRIES] == q_hi[:, None])
        & (la_e > 0.5 * NEG)
    )
    found = match.any(1)
    first = torch.argmax(match.to(torch.uint8), dim=1, keepdim=True)
    ph_e = rows[:, 3 * ENTRIES:].view(torch.float32)
    return (torch.where(found, la_e.gather(1, first)[:, 0], NEG),
            torch.where(found, ph_e.gather(1, first)[:, 0], 0.0), found)


@pytest.mark.parametrize("case", ["li2o", "w2"])
def test_tag_filter_selects_what_plain_selects(case):
    """Hits, misses that share key_lo with an entry, and random misses,
    through the tag filter: bit-equal to ``hash_lookup_plain``."""
    tab, keys = _tag_table(case)
    rng = np.random.default_rng(8)
    q = keys[rng.integers(0, len(keys), 20000)].copy()
    kind = rng.integers(0, 3, len(q))
    q[kind == 1, 1] ^= U32(1 << 9)
    q[kind == 2] = rng.integers(0, 1 << 32, (int((kind == 2).sum()), 2))
    q = torch.from_numpy(q.view(np.int32))
    q_lo = q[:, 0].contiguous()
    q_hi = q[:, 1].contiguous() if case == "w2" else None
    if q_hi is None:
        q_lo = q_lo[kind != 1]
    got = _lookup_via_tags(tab, q_lo, q_hi)
    want = hash_lookup_plain(tab, q_lo, q_hi)
    for g, w_ in zip(got[:2], want[:2]):
        assert torch.equal(g.view(torch.int32), w_.view(torch.int32))
    assert torch.equal(got[2], want[2])
    assert 0 < int(got[2].sum()) < len(q_lo)
