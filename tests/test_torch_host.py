"""Host layer of the PyTorch port against the JAX package, exact equality:
Hamiltonian fields, masker and grouping tables, the sector tables of the
VMC trainer, and the N2 and Li2O molecule files shipped inside the port."""

import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.chem import fci as jax_fci
from anqs_quantum_chemistry_tpu.experiments.preparation import (
    create_masker as jax_create_masker,
)
from anqs_quantum_chemistry_tpu.experiments.vmc import VMC as JaxVMC
from anqs_quantum_chemistry_tpu.experiments.vmc import VMCConfig as JaxVMCConfig
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_torch.chem.fci import (
    sector_determinants,
    sector_ground_energy,
    sector_matrix_elements,
)
from anqs_quantum_chemistry_torch.chem.molecule import (
    LI2O_STO3G,
    N2_STO3G,
    PACKAGED_KEYS,
    load_li2o,
    load_n2,
    write_packaged,
)
from anqs_quantum_chemistry_torch.experiments.preparation import create_masker
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping
from torch_port_common import mol_path, molecules

MOLECULES = ["H2", "LiH", "N2"]


@pytest.mark.parametrize("name", MOLECULES)
def test_pauli_hamiltonian_fields(name):
    jmol, mol = molecules(name)
    jh, h = jmol.qubit_ham, mol.qubit_ham
    assert h.qubit_num == jh.qubit_num
    assert h.constant == jh.constant
    assert (h.n_groups, h.n_terms) == (jh.n_groups, jh.n_terms)
    for field in ("a_masks", "b_words", "weights", "group_starts"):
        a, b = getattr(h, field), getattr(jh, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (mol.n_alpha, mol.n_beta, mol.hf_det) == (
        jmol.n_alpha, jmol.n_beta, jmol.hf_det
    )
    assert mol.fci_ndet == jmol.fci_ndet


@pytest.mark.parametrize("name", MOLECULES)
@pytest.mark.parametrize("level", ["no_sym", "e_num", "e_num_spin", "z2"])
def test_masker_tables(name, level):
    jmol, mol = molecules(name)
    jm, m = jax_create_masker(jmol, level), create_masker(mol, level)
    assert m.memo_size == jm.memo_size
    assert m.start_memo_idx == jm.start_memo_idx
    for field in ("next_idx", "next_valid", "memo"):
        np.testing.assert_array_equal(getattr(m, field), getattr(jm, field))


@pytest.mark.parametrize("name,qpq", [("H2", 2), ("LiH", 6), ("N2", 10),
                                      ("N2", 6)])
def test_grouping_tables(name, qpq):
    jmol, mol = molecules(name)
    jg = JaxGrouping.create(jax_create_masker(jmol, "e_num_spin"), qpq)
    g = QubitGrouping.create(create_masker(mol, "e_num_spin"), qpq)
    assert (g.qudit_starts, g.qudit_ends, g.start_memo_idx) == (
        jg.qudit_starts, jg.qudit_ends, jg.start_memo_idx
    )
    np.testing.assert_array_equal(g.trans_tables, jg.trans_tables)
    np.testing.assert_array_equal(g.mask_tables, jg.mask_tables)


@pytest.mark.parametrize("name", MOLECULES)
def test_sector_tables(name):
    """sector_words, partner idx/found and sector_pos of the two drivers."""
    jmol, mol = molecules(name)
    kw = dict(sample_num=64, sampling_mode="gumbel", qubit_per_qudit=4)
    jv = JaxVMC(
        jmol,
        JaxVMCConfig(**kw, engine_overrides={"table_pairs_per_row": 1}),
        JaxAnqsConfig(hidden_widths=(8,)),
    )
    v = VMC(mol, VMCConfig(**kw), AnqsConfig(hidden_widths=(8,)),
            device="cpu")
    np.testing.assert_array_equal(
        v.sector_words.numpy(), np.asarray(jv.sector_words).astype(np.int64)
    )
    np.testing.assert_array_equal(
        v.sector_partner_idx.numpy(), np.asarray(jv.sector_partner_idx)
    )
    np.testing.assert_array_equal(
        v.sector_partner_found.numpy(), np.asarray(jv.sector_partner_found)
    )
    np.testing.assert_array_equal(
        v.sector_pos.numpy(), np.asarray(jv.sector_pos)
    )
    np.testing.assert_array_equal(
        v.hf_words.numpy(), np.asarray(jv.hf_words).astype(np.int64)
    )
    dets = np.asarray(jax_fci.sector_determinants(
        mol.qubit_num, mol.n_alpha, mol.n_beta), dtype=np.uint64)
    np.testing.assert_array_equal(
        sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta), dets
    )


def test_packaged_n2_matches_mols_file():
    """The port's N2 file holds the JAX cache's arrays bit for bit; its FCI
    energy (absent from the cache) is the exact sector ground state."""
    with np.load(N2_STO3G) as pkg, np.load(mol_path("N2")) as src:
        assert sorted(pkg.files) == sorted(PACKAGED_KEYS)
        for key in PACKAGED_KEYS:
            if key == "fci_energy":
                continue
            assert pkg[key].dtype == src[key].dtype, key
            np.testing.assert_array_equal(pkg[key], src[key], err_msg=key)
        h1, v, e_nuc = src["h1"], src["v"], float(src["e_nuc"])
    e_ref = jax_fci.fci_ground_state(h1, v, 7, 7, e_nuc)[0]
    n2 = load_n2()
    assert abs(n2.fci_energy - e_ref) < 1e-8
    assert n2.qubit_ham.n_terms == 2958 and n2.qubit_ham.n_groups == 536
    assert n2.fci_ndet == 14400


def test_sector_ground_energy_matches_fci():
    """The port's Pauli-form sector diagonalisation reproduces the JAX
    package's integral-based FCI on LiH."""
    jmol, mol = molecules("LiH")
    e = sector_ground_energy(mol.qubit_ham, mol.n_alpha, mol.n_beta)
    assert abs(e - jmol.fci_energy) < 1e-8


def test_packaged_li2o():
    """The port's Li2O file: the toy model's sizes, and a Pauli form whose
    HF diagonal element reproduces the JAX package's SCF energy (both
    written into the file by the JAX molecule build)."""
    mol = load_li2o()
    h = mol.qubit_ham
    assert (mol.qubit_num, mol.n_alpha, mol.n_beta) == (30, 7, 7)
    assert (h.n_terms, h.n_groups) == (16169, 3072)
    assert mol.fci_ndet == 41_409_225 and mol.fci_energy is None
    hf = np.array([mol.hf_det], np.uint64)
    diag = int(np.flatnonzero(~h.a_masks.any(axis=1))[0])  # A = 0
    e_hf = h.constant + sector_matrix_elements(h, hf)[0, diag]
    assert abs(e_hf - mol.hf_energy) < 1e-8
    assert abs(mol.hf_energy - -88.581529) < 1e-6


def test_write_packaged_keeps_nan_above_sector_limit(tmp_path):
    """A sector too large to diagonalise (Li2O: 41.4M determinants) keeps
    fci_energy = NaN instead of starting an eigensolver that would not
    finish; the arrays are copied as they are."""
    dst = str(tmp_path / "li2o.npz")
    assert np.isnan(write_packaged(LI2O_STO3G, dst))
    with np.load(LI2O_STO3G) as src, np.load(dst) as out:
        assert sorted(out.files) == sorted(PACKAGED_KEYS)
        for key in PACKAGED_KEYS:
            np.testing.assert_array_equal(out[key], src[key], err_msg=key)
