"""Qubit permutation of the PyTorch port against the JAX package
(reference HilbertSpace perm/inv_perm, hilbert_space.py:97-104; JAX
``tests/test_qubit_perm.py``): ``bits.permute_qubits``,
``jw.permute_qubits_hamiltonian`` and ``permute_det`` (exactly), the
permuted masker's tables (exactly), and ``VMCConfig.qubit_perm`` through
the trainer: an exact-summation step on H2 and a sampled step on LiH
(sector membership over the permuted sector) against JAX's from the same
weights and uniforms (gradients rtol 1e-4, energies 1e-6 Ha, the same
pairs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem import jw as jjw
from anqs_quantum_chemistry_tpu.experiments.preparation import (
    create_masker as jax_create_masker,
)
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_torch.chem import jw
from anqs_quantum_chemistry_torch.experiments.preparation import create_masker
from anqs_quantum_chemistry_torch.ops import bits
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping
from torch_port_common import molecules
from torch_step_common import assert_step_matches, step_pair

NAMES = ("energy", "energy_var", "hf_proj_energy")


@pytest.mark.parametrize("n", [12, 40])
def test_permute_qubits_matches_jax(rng, n):
    words = rng.integers(0, 2**32, (64, -(-n // 32)), dtype=np.uint64)
    if n % 32:
        words[:, -1] &= (1 << (n % 32)) - 1
    perm = rng.permutation(n)
    want = np.asarray(jbits.permute_qubits(jnp.asarray(words, jnp.uint32),
                                           perm, n))
    got = bits.permute_qubits(torch.from_numpy(words.astype(np.int64)),
                              perm, n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_permute_hamiltonian_and_det_match_jax(rng):
    jmol, mol = molecules("LiH")
    perm = rng.permutation(mol.qubit_num)
    want = jjw.permute_qubits_hamiltonian(jmol.qubit_ham, perm)
    got = jw.permute_qubits_hamiltonian(mol.qubit_ham, perm)
    for field in ("a_masks", "b_words", "weights", "group_starts"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.constant == want.constant
    for det in (mol.hf_det, 0b101101, (1 << mol.qubit_num) - 1):
        assert jw.permute_det(det, perm) == jjw.permute_det(det, perm)
    with pytest.raises(ValueError):
        jw.permute_qubits_hamiltonian(mol.qubit_ham, [0] * mol.qubit_num)


@pytest.mark.parametrize("level", ["e_num_spin", "z2"])
def test_permuted_masker_matches_jax(rng, level):
    jmol, mol = molecules("LiH")
    perm = rng.permutation(mol.qubit_num)
    jg = JaxGrouping.create(jax_create_masker(jmol, level, perm=perm), 3)
    g = QubitGrouping.create(create_masker(mol, level, perm=perm), 3)
    np.testing.assert_array_equal(g.trans_tables, jg.trans_tables)
    np.testing.assert_array_equal(g.mask_tables, jg.mask_tables)
    assert g.start_memo_idx == jg.start_memo_idx


def test_permuted_exact_step_matches_jax():
    """H2, exact summation, qubit_perm (2, 0, 3, 1): the permuted sector,
    static membership and HF row; SGD at lr 1 (the update is minus the
    gradient)."""
    jv, v, jm, metrics, grads, want = step_pair(
        "H2", dict(sampling_mode="exact", qubit_per_qudit=2, seed=1,
                   qubit_perm=(2, 0, 3, 1)),
        dict(hidden_widths=(16,)))
    assert v.exact_partner_idx is not None
    np.testing.assert_array_equal(v.exact_words.numpy(),
                                  np.asarray(jv.exact_words))
    assert_step_matches(jm, metrics, grads, want, NAMES)


def test_permuted_sampled_step_matches_jax():
    """LiH, 128 Gumbel samples of its 225-determinant sector under a
    random permutation, sector membership over the permuted sector: the
    JAX step and the port's from the same weights and uniforms."""
    perm = tuple(int(p) for p in np.random.default_rng(5).permutation(12))
    jv, v, jm, metrics, grads, want = step_pair(
        "LiH", dict(sample_num=128, sampling_mode="gumbel",
                    qubit_per_qudit=4, seed=2, qubit_perm=perm),
        dict(hidden_widths=(16,), aux_hidden_widths=(16,)))
    assert v.sector_words is not None and jv.sector_words is not None
    assert_step_matches(jm, metrics, grads, want, NAMES)
