"""The host chemistry of the C2H4/6-31G chain in the PyTorch port against the
JAX package and its molecule files, on the CPU.

- The packaged spatial integrals rebuild C2H4's spin-orbital ``h1`` and
  ``v`` (``mols/C2H4``) bit for bit; the file carries the CISD and
  CCSD(T) energies; ``write_packaged`` refuses integrals that are not one
  spatial block.
- The integral form of ``cisd_ground_state`` equals JAX's on LiH, H2O and
  Li2O: the same determinants, the energy to 1e-10 Ha, the coefficients
  to 1e-8 after the sign fix (largest coefficient positive).
- ``sparse_hamiltonian`` over the first 1500 determinants of C2H4's CISD
  vector (two words a determinant: the C++ builder's uint64 path at 52
  qubits) equals the JAX package's to 1e-12 Ha, element by element.
- Heat-bath expansion, the restricted ground state and the truncation at
  52 qubits, with small caps, equal JAX's: the same determinants, E0 to
  1e-10 Ha, the coefficients to 1e-8 after the sign fix.
"""

import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.chem import fci as jfci
from anqs_quantum_chemistry_tpu.chem import selected_ci as jsci
from anqs_quantum_chemistry_torch.chem import fci
from anqs_quantum_chemistry_torch.chem import selected_ci as sci
from anqs_quantum_chemistry_torch.chem.molecule import (
    C2H4_631G,
    INTEGRAL_KEYS,
    PACKAGED_KEYS,
    SPATIAL_KEYS,
    load_c2h4,
    write_packaged,
)
from anqs_quantum_chemistry_torch.experiments.c2h4_support_ci import (
    C2H4_CISD_VECTOR,
)
from torch_port_common import molecules, mol_path


def same_state(a, b, tol):
    """Two eigenvectors equal up to their sign, to ``tol``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a = a * np.sign(a[np.argmax(np.abs(a))])
    b = b * np.sign(b[np.argmax(np.abs(b))])
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def c2h4():
    return load_c2h4()


@pytest.fixture(scope="module")
def cisd_vector():
    with np.load(C2H4_CISD_VECTOR) as d:
        return [int(x) for x in d["dets"]], d["coef"]


def test_packaged_c2h4_integrals_match_mols_file(c2h4):
    with np.load(C2H4_631G) as pkg, np.load(mol_path("C2H4")) as src:
        assert set(INTEGRAL_KEYS).isdisjoint(pkg.files)  # no 58 MB copy
        assert pkg["v_spatial"].shape == (26,) * 4
        for key in INTEGRAL_KEYS:
            got = getattr(c2h4, key)
            assert got.dtype == src[key].dtype, key
            np.testing.assert_array_equal(got, src[key], err_msg=key)
        assert c2h4.cisd_energy == float(src["cisd_energy"][0])
        assert c2h4.ccsd_t_energy == float(src["ccsd_t_energy"][0])
        assert c2h4.e_nuc == float(src["e_nuc"])
    assert abs(c2h4.cisd_energy - -78.19799658) < 1e-8
    assert abs(c2h4.ccsd_t_energy - -78.21900711) < 1e-8
    assert c2h4.fci_energy is None


def test_write_packaged_spatial_form(tmp_path):
    """``--integrals`` writes the spatial form, whose rebuild is exact; a
    ``v`` that is not one spatial block raises."""
    src = mol_path("LiH")
    dst = str(tmp_path / "lih.npz")
    write_packaged(src, dst, integrals=True)
    with np.load(dst) as out, np.load(src) as ref:
        assert sorted(out.files) == sorted(PACKAGED_KEYS + SPATIAL_KEYS)
        np.testing.assert_array_equal(out["cisd_energy"], ref["cisd_energy"])
    jmol, _ = molecules("LiH")
    mol = type(load_c2h4()).from_npz(dst)
    np.testing.assert_array_equal(mol.v, jmol.v)
    np.testing.assert_array_equal(mol.h1, jmol.h1)
    bad = dict(np.load(src))
    bad["v"] = bad["v"].copy()
    bad["v"][1, 1, 1, 1] += 1e-9  # beta block no longer equals alpha's
    np.savez(str(tmp_path / "bad.npz"), **bad)
    with pytest.raises(ValueError, match="spatial block"):
        write_packaged(str(tmp_path / "bad.npz"), str(tmp_path / "x.npz"),
                       integrals=True)


@pytest.mark.parametrize("name", ["LiH", "H2O", "Li2O"])
def test_cisd_integral_form_matches_jax(name):
    jmol, mol = molecules(name)
    hf = int(np.asarray(jmol.hf_det).ravel()[0])
    e_j, dets_j, coef_j = jfci.cisd_ground_state(jmol.h1, jmol.v, hf,
                                                 jmol.e_nuc)
    e, dets, coef = fci.cisd_ground_state(mol.h1, mol.v, mol.hf_det,
                                          mol.e_nuc)
    assert dets.dtype == np.uint64
    np.testing.assert_array_equal(dets, np.asarray(dets_j, np.uint64))
    assert abs(e - e_j) < 1e-10
    same_state(coef, coef_j, 1e-8)
    if name == "LiH":  # the Pauli form gives the same state
        e_p, dets_p, coef_p = fci.cisd_ground_state(mol.qubit_ham,
                                                    mol.hf_det)
        np.testing.assert_array_equal(dets_p, dets)
        assert abs(e_p - e) < 1e-9
        same_state(coef_p, coef, 1e-7)


def test_sparse_hamiltonian_c2h4_matches_jax(c2h4, cisd_vector):
    dets = cisd_vector[0][:1500]
    h = fci.sparse_hamiltonian(dets, c2h4.h1, c2h4.v)
    h_j = jfci.sparse_hamiltonian(dets, c2h4.h1, c2h4.v)
    assert h.shape == h_j.shape == (1500, 1500)
    assert h.nnz > 0
    assert abs(h - h_j).max() < 1e-12
    assert abs(h - h.T).max() == 0.0


def test_heatbath_expansion_c2h4_matches_jax(c2h4, cisd_vector):
    dets, coef = cisd_vector
    seed_d, seed_c = sci.truncate_by_weight(dets, coef, 300)
    jseed_d, jseed_c = jsci.truncate_by_weight(dets, coef, 300)
    assert seed_d == list(jseed_d)
    np.testing.assert_array_equal(seed_c, jseed_c)
    bigger = sci.expand_support_heatbath(
        seed_d, seed_c, sci.HeatBathTable(c2h4.h1, c2h4.v), 2e-3, 20,
        max_new=2000)
    jbigger = jsci.expand_support_heatbath(
        seed_d, seed_c, jsci.HeatBathTable(c2h4.h1, c2h4.v), 2e-3, 20,
        max_new=2000)
    assert len(bigger) > len(seed_d)
    assert bigger == [int(x) for x in jbigger]
    e, c = sci.restricted_ground_state(bigger, c2h4.h1, c2h4.v, c2h4.e_nuc)
    e_j, c_j = jsci.restricted_ground_state(bigger, c2h4.h1, c2h4.v,
                                            c2h4.e_nuc)
    assert abs(e - e_j) < 1e-10
    same_state(c, c_j, 1e-8)
    td, tc = sci.truncate_by_weight(bigger, c, 500)
    jtd, jtc = jsci.truncate_by_weight(bigger, c_j, 500)
    assert td == [int(x) for x in jtd] and td == sorted(td)
    same_state(tc, jtc, 1e-8)
