"""Parity of the port's Jordan-Wigner transform (``chem/jw.py``) with the JAX
package's, on random real symmetric integrals at 12 qubits (one word) and
40 qubits (two words), made from a numpy seed; the symmetry generators; the
word codecs; and the odd-Y guard."""

import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.chem import jw as jax_jw
from anqs_quantum_chemistry_torch.chem import jw


def symmetric_integrals(n_so, active, seed):
    """Random h1 and v = <pq|rs> with every symmetry of real orbitals
    (h1 symmetric; v[p,q,r,s] = v[q,p,s,r] = v[r,s,p,q] = v[r,q,p,s]),
    supported on the ``active`` spin orbitals and conserving spin."""
    rng = np.random.default_rng(seed)
    act = np.asarray(active)
    n = len(act)
    sub = rng.standard_normal((n, n))
    h1 = np.zeros((n_so, n_so))
    h1[np.ix_(act, act)] = sub + sub.T
    # Chemist (pr|qs) with its 8-fold symmetry, then <pq|rs> = (pr|qs).
    g = rng.standard_normal((n,) * 4)
    g = g + g.transpose(1, 0, 2, 3)
    g = g + g.transpose(0, 1, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    v_act = g.transpose(0, 2, 1, 3)
    spin = act % 2
    same = spin[:, None] == spin[None, :]
    v_act = v_act * same[:, None, :, None] * same[None, :, None, :]
    h1[np.ix_(act, act)] *= same
    v = np.zeros((n_so,) * 4)
    v[np.ix_(act, act, act, act)] = v_act
    return h1, v


CASES = {
    "12q": (12, list(range(12))),
    # Active orbitals on both sides of the word boundary at 32.
    "40q": (40, [0, 1, 2, 3, 30, 31, 32, 33, 36, 37, 38, 39]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def hams(request):
    n_so, active = CASES[request.param]
    h1, v = symmetric_integrals(n_so, active, seed=7)
    return (jax_jw.jordan_wigner_pauli_hamiltonian(h1, v, constant=0.25),
            jw.jordan_wigner_pauli_hamiltonian(h1, v, constant=0.25), h1, v)


def test_jw_matches_jax(hams):
    """The same grouped Pauli form: masks, sign words and CSR offsets
    equal, weights and the constant to 1e-12."""
    ref, got, _, _ = hams
    assert got.a_masks.shape[1] == ref.a_masks.shape[1]
    assert got.a_masks.dtype == np.uint32 and got.b_words.dtype == np.uint32
    np.testing.assert_array_equal(got.a_masks, ref.a_masks)
    np.testing.assert_array_equal(got.b_words, ref.b_words)
    np.testing.assert_array_equal(got.group_starts, ref.group_starts)
    np.testing.assert_allclose(got.weights, ref.weights, rtol=0, atol=1e-12)
    assert abs(got.constant - ref.constant) <= 1e-12
    assert ref.phase_offsets is None


def test_symmetries_match_jax(hams):
    ref, got, _, _ = hams
    np.testing.assert_array_equal(jw.z_string_symmetries(got),
                                  jax_jw.z_string_symmetries(ref))
    for a, b in zip(jw.symplectic_symmetries(got),
                    jax_jw.symplectic_symmetries(ref)):
        np.testing.assert_array_equal(a, b)


def test_dense_matrix_element_matches_jax(hams):
    """The tests' oracle <y|H|x> on random determinant pairs that differ
    in 0, 2 or 4 spin orbitals, against JAX's oracle on JAX's form."""
    ref, got, _, _ = hams
    rng = np.random.default_rng(3)
    n = got.qubit_num
    for _ in range(30):
        occ = rng.choice(n, size=6, replace=False)
        x = sum(1 << int(o) for o in occ)
        flips = rng.choice(n, size=int(rng.integers(0, 3)) * 2,
                           replace=False)
        y = x ^ sum(1 << int(o) for o in flips)
        assert abs(got.dense_matrix_element(x, y)
                   - ref.dense_matrix_element(x, y)) <= 1e-12


def test_word_codecs_match_jax():
    rng = np.random.default_rng(5)
    values = [int(v) for v in rng.integers(0, 2 ** 62, size=20)]
    values += [(1 << 69) | 5, 0]
    for n in (20, 64, 70):
        vals = [v % (1 << n) for v in values]
        words = jw.ints_to_words(vals, n)
        np.testing.assert_array_equal(words,
                                      jax_jw.ints_to_words(vals, n))
        assert jw.words_to_pyints(words) == jax_jw.words_to_pyints(words)
        if n <= 64:
            np.testing.assert_array_equal(jw.words_to_ints(words),
                                          jax_jw.words_to_ints(words))
        else:
            with pytest.raises(ValueError):
                jw.words_to_ints(words)


def test_odd_y_terms_raise():
    """Integrals without the symmetry v[p,q,r,s] = v[r,s,p,q] make a
    non-Hermitian H whose XZ form keeps terms with an odd number of Y
    factors. The container carries an odd-Y channel (``phase_offsets``),
    but the molecular transform builds none, as the JAX package's does
    not: it raises rather than return such terms as real weights."""
    h1, v = symmetric_integrals(12, list(range(12)), seed=11)
    v = v.copy()
    v[0, 2, 4, 6] += 0.3
    with pytest.raises(ValueError, match="odd number of Y"):
        jw.jordan_wigner_pauli_hamiltonian(h1, v)
