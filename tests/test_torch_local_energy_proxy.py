"""Dynamic-membership local energies of the PyTorch port against the JAX
package (``PauliEngine.local_energy_proxy``, membership 'hash' and 'table';
the JAX table engine in its (2^n, 2) layout, ``table_pairs_per_row=1``).

``found_pairs`` must be equal; ``e_re``/``e_im`` agree to atol 1e-5 Ha and
``t_re``/``t_im`` to atol 1e-6, each plus 4e-7 relative (3 float32 ulps:
|E_loc| reaches 75-110 Ha, |t| 20): the same float32 terms summed over the
same groups, with exp/cos/sin of two libraries. With a wide log|psi|
spread, where amplitude ratios leave e^(+-60) and are clipped pair by pair,
``e_re``/``e_im`` agree to 1e-6 of the batch's largest |e|, and each row
to 1e-5 of its own |E_loc| (complex modulus, at least 1 Ha): the float32
sums cancel, so a row's error follows its terms, not its result (1.2e-6
measured for H2O).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem.jw import (
    PauliHamiltonian as JaxPauliHamiltonian,
)
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.chem.jw import (
    PauliHamiltonian,
    words_to_ints,
)
from anqs_quantum_chemistry_torch.chem.molecule import load_li2o
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.hash_lookup import hash_lookup
from torch_port_common import molecules

JAX_ENGINE = {"table": dict(membership="table", table_pairs_per_row=1),
              "hash": dict(membership="hash")}


def _batch(rng, dets, rows, spread=0.3):
    """``rows`` sector determinants (all if None) in canonical order,
    ~10% of them invalid (all-ones sentinels, sorted to the end), and
    amplitudes of a roughly uniform normalised state whose log|psi| has
    standard deviation ``spread`` (clipped at 0)."""
    if rows is not None:
        dets = np.sort(rng.choice(dets, rows, replace=False))
    valid = rng.random(len(dets)) < 0.9
    words = np.concatenate([dets[valid], np.full((~valid).sum(),
                                                 0xFFFFFFFF, np.uint64)])
    valid = np.sort(valid)[::-1].copy()
    la = np.minimum(-0.5 * np.log(len(dets))
                    + spread * rng.standard_normal(len(dets)), 0.0)
    ph = rng.uniform(-3, 3, len(dets))
    return (words.astype(np.int64)[:, None], la.astype(np.float32),
            ph.astype(np.float32), valid)


def _energies(jeng, eng, words, la, ph, valid):
    """(port LocalEnergies, JAX LocalEnergies) of one batch."""
    je = jeng.local_energy_proxy(
        jnp.asarray(words, jnp.uint32), jnp.asarray(la), jnp.asarray(ph),
        jnp.asarray(valid),
    )
    e = eng.local_energy_proxy(
        torch.from_numpy(words), torch.from_numpy(la), torch.from_numpy(ph),
        torch.from_numpy(valid),
    )
    assert int(e.found_pairs) == int(je.found_pairs)
    return e, je


def _compare(jeng, eng, words, la, ph, valid):
    e, je = _energies(jeng, eng, words, la, ph, valid)
    assert int(e.table_overflow) == int(je.table_overflow) == 0
    for field, atol in (("e_re", 1e-5), ("e_im", 1e-5), ("t_re", 1e-6),
                        ("t_im", 1e-6)):
        np.testing.assert_allclose(
            getattr(e, field).numpy(), np.asarray(getattr(je, field)),
            rtol=4e-7, atol=atol, err_msg=field,
        )
    return int(e.found_pairs)


@pytest.mark.parametrize("membership", ["hash", "table"])
@pytest.mark.parametrize("name,rows", [("H2O", None), ("N2", 2048)])
def test_local_energy_proxy_matches_jax(name, rows, membership):
    jmol, mol = molecules(name)
    rng = np.random.default_rng(9)
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words, la, ph, valid = _batch(rng, dets, rows)
    jeng = JaxPauliEngine(jmol.qubit_ham, **JAX_ENGINE[membership])
    eng = PauliEngine(mol.qubit_ham, device="cpu", membership=membership)
    launches = hash_lookup.launches
    found = _compare(jeng, eng, words, la, ph, valid)
    assert hash_lookup.launches == launches  # CPU: the plain version
    assert found > 2 * valid.sum()  # pairs beyond the diagonal


@pytest.mark.parametrize("membership", ["hash", "table"])
def test_local_energy_proxy_wide_spread_matches_jax(membership):
    """H2O's full sector with log|psi| spread 30: many amplitude ratios
    leave e^(+-60), where JAX's dynamic paths clip each pair's ratio."""
    jmol, mol = molecules("H2O")
    rng = np.random.default_rng(9)
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words, la, ph, valid = _batch(rng, dets, None, spread=30.0)
    jeng = JaxPauliEngine(jmol.qubit_ham, **JAX_ENGINE[membership])
    eng = PauliEngine(mol.qubit_ham, device="cpu", membership=membership)
    e, je = _energies(jeng, eng, words, la, ph, valid)
    modulus = np.hypot(np.asarray(je.e_re, np.float64),
                       np.asarray(je.e_im, np.float64))
    for field in ("e_re", "e_im"):
        want = np.asarray(getattr(je, field))
        got = getattr(e, field).numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-6 * np.max(np.abs(want)),
            err_msg=field,
        )
        # Row by row, against that row's own |E_loc| (at least 1 Ha).
        row_err = (np.abs(got.astype(np.float64) - want)
                   / np.maximum(modulus, 1.0))
        assert row_err.max() <= 1e-5, (field, row_err.max())
    for field in ("t_re", "t_im"):
        np.testing.assert_allclose(
            getattr(e, field).numpy(), np.asarray(getattr(je, field)),
            rtol=4e-7, atol=1e-6, err_msg=field,
        )
    assert np.max(np.abs(np.asarray(je.e_re))) > 1e20  # ratios clipped


def test_li2o_proxy_matches_jax():
    """Li2O (30 qubits, 3072 groups) at 32 rows: the HF determinant and 31
    of its sector partners. The JAX engine gets its Hamiltonian from the
    port's packaged arrays (a fresh checkout has no ``mols/Li2O``)."""
    mol = load_li2o()
    h = mol.qubit_ham
    jham = JaxPauliHamiltonian(
        qubit_num=h.qubit_num, constant=h.constant, a_masks=h.a_masks,
        b_words=h.b_words, weights=h.weights, group_starts=h.group_starts,
    )
    partners = np.uint64(mol.hf_det) ^ words_to_ints(h.a_masks)
    even = np.uint64(0x5555_5555_5555_5555)
    in_sector = [bin(int(p) & int(even)).count("1") == mol.n_alpha
                 and bin(int(p) & ~int(even)).count("1") == mol.n_beta
                 for p in partners]
    rng = np.random.default_rng(4)
    pool = np.unique(partners[in_sector])
    dets = np.sort(np.concatenate([
        [np.uint64(mol.hf_det)],
        rng.choice(pool[pool != mol.hf_det], 31, replace=False),
    ]))
    words, la, ph, valid = _batch(rng, dets, None)
    jeng = JaxPauliEngine(jham, membership="hash")
    eng = PauliEngine(h, device="cpu", membership="hash")
    found = _compare(jeng, eng, words, la, ph, valid)
    assert found > valid.sum()


def _one_term_ham(qubit_num):
    """A one-term diagonal Hamiltonian on ``qubit_num`` qubits."""
    w = -(-qubit_num // 32)
    return PauliHamiltonian(
        qubit_num=qubit_num, constant=0.0,
        a_masks=np.zeros((1, w), np.uint32),
        b_words=np.zeros((1, w), np.uint32), weights=np.ones(1),
        group_starts=np.array([0, 1]),
    )


def test_unported_memberships_raise():
    """Every membership of the JAX engine is ported: 'hash_dist' builds
    (one shard without a mesh); 'hash', 'prefilter' and 'hash_dist' above
    128 qubits (JAX's assertion) and names of neither package raise
    ``ValueError``. 'auto' resolves as JAX's does: Li2O (30 qubits) and W
    3-4 to 'prefilter', W > 4 to 'search', and each of those runs
    ``local_energy_proxy``."""
    mol = load_li2o()  # 30 qubits: the JAX engine's 'auto' -> 'prefilter'
    assert PauliEngine(mol.qubit_ham, device="cpu").membership == "prefilter"
    eng = PauliEngine(mol.qubit_ham, device="cpu", membership="hash_dist")
    assert eng.membership == "hash_dist" and eng.mesh is None
    with pytest.raises(ValueError):
        PauliEngine(mol.qubit_ham, device="cpu", membership="table")
    with pytest.raises(ValueError):
        PauliEngine(mol.qubit_ham, device="cpu", membership="bloom")
    for n, resolved in ((70, "prefilter"), (130, "search")):
        ham = _one_term_ham(n)
        if n > 128:
            for membership in ("hash", "prefilter", "hash_dist"):
                with pytest.raises(ValueError, match="128 qubits"):
                    PauliEngine(ham, device="cpu", membership=membership)
        eng = PauliEngine(ham, device="cpu")
        assert eng.membership == resolved
        words = torch.zeros((2, -(-n // 32)), dtype=torch.int64)
        words[1, -1] = 1
        zeros = torch.zeros(2)
        out = eng.local_energy_proxy(words, zeros, zeros,
                                     torch.ones(2, dtype=torch.bool))
        assert int(out.found_pairs) == 2  # the diagonal term of each row
