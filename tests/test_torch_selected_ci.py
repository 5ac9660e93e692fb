"""Selected CI in the PyTorch port (``chem/selected_ci.py``) against the JAX
package's, on LiH and H2O (STO-3G) from ``mols/``: the six cases of
``tests/test_selected_ci.py``, each through both packages. Determinant
lists must be equal, energies agree to 1e-10 Ha and coefficients to 1e-8
up to one global sign (each package's Lanczos picks its own sign)."""

import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.chem import fci as jfci
from anqs_quantum_chemistry_tpu.chem import selected_ci as jsci
from anqs_quantum_chemistry_torch.chem import fci
from anqs_quantum_chemistry_torch.chem import selected_ci as sci
from torch_port_common import molecules

MOLS = ("LiH", "H2O")


@pytest.fixture(scope="module", params=MOLS)
def mols(request):
    """(JAX Molecule, port Molecule), the JAX one with its CISD and FCI
    energies from the JAX package's ``chem/fci.py`` (the H2O cache holds
    none)."""
    jmol, mol = molecules(request.param)
    jmol.cisd_energy = jfci.cisd_ground_state(jmol.h1, jmol.v, jmol.hf_det,
                                              jmol.e_nuc)[0]
    jmol.fci_energy = jfci.fci_ground_state(jmol.h1, jmol.v, jmol.n_alpha,
                                            jmol.n_beta, jmol.e_nuc)[0]
    return jmol, mol


def same_vector(c, jc, atol=1e-8):
    c, jc = np.asarray(c), np.asarray(jc)
    assert c.shape == jc.shape
    np.testing.assert_allclose(c, np.sign(c @ jc) * jc, rtol=0, atol=atol)


def test_restricted_ground_state_on_cisd_support(mols):
    """H restricted to the CISD support: the CISD energy, a unit vector,
    both packages the same."""
    jmol, mol = mols
    hf = mol.hf_det
    dets = sorted(set([hf] + [int(x) for x in
                              fci.excitations_in_sector(hf, mol.qubit_num)]))
    assert dets == sorted(set([hf] + jfci._excitations_in_sector(
        hf, mol.qubit_num)))
    e, c = sci.restricted_ground_state(dets, mol.h1, mol.v, mol.e_nuc)
    je, jc = jsci.restricted_ground_state(dets, jmol.h1, jmol.v, jmol.e_nuc)
    assert abs(e - je) < 1e-10
    assert abs(e - jmol.cisd_energy) < 1e-8
    assert abs(np.linalg.norm(c) - 1.0) < 1e-8
    same_vector(c, jc)


def test_selected_ci_from_hf_seed(mols):
    """Rounds from the HF determinant (64 parents, tol 1e-9): the same
    rounds, supports, energies and vector; the energy falls each round and
    reaches FCI."""
    jmol, mol = mols
    rows, jrows = [], []
    e, dets, coef = sci.selected_ci([mol.hf_det], mol.h1, mol.v, mol.e_nuc,
                                    n_parents=64, rounds=4, tol=1e-9,
                                    on_round=rows.append)
    je, jdets, jcoef = jsci.selected_ci([jmol.hf_det], jmol.h1, jmol.v,
                                        jmol.e_nuc, n_parents=64, rounds=4,
                                        tol=1e-9, on_round=jrows.append)
    assert dets == jdets
    assert abs(e - je) < 1e-10
    same_vector(coef, jcoef)
    assert [r["size"] for r in rows] == [r["size"] for r in jrows]
    np.testing.assert_allclose([r["energy"] for r in rows],
                               [r["energy"] for r in jrows], rtol=0,
                               atol=1e-10)
    energies = [r["energy"] for r in rows]
    assert all(b <= a + 1e-12 for a, b in zip(energies, energies[1:]))
    assert e <= jmol.cisd_energy + 1e-10
    assert abs(e - jmol.fci_energy) < 1e-7


def test_truncate_by_weight(mols):
    """The top 40 by |coef|, ascending and renormalised, as JAX cuts them;
    the cut support's own ground state stays variational."""
    jmol, mol = mols
    _, dets, coef = jsci.selected_ci([jmol.hf_det], jmol.h1, jmol.v,
                                     jmol.e_nuc, n_parents=64, rounds=3)
    td, tc = sci.truncate_by_weight(dets, coef, 40)
    jtd, jtc = jsci.truncate_by_weight(dets, coef, 40)
    assert td == jtd == sorted(td) and len(td) == 40
    np.testing.assert_allclose(tc, jtc, rtol=0, atol=1e-15)
    assert abs(np.linalg.norm(tc) - 1.0) < 1e-12
    e_t, _ = sci.restricted_ground_state(td, mol.h1, mol.v, mol.e_nuc)
    je_t, _ = jsci.restricted_ground_state(jtd, jmol.h1, jmol.v, jmol.e_nuc)
    assert abs(e_t - je_t) < 1e-10
    assert e_t >= jmol.fci_energy - 1e-9


def test_expand_support_max_new(mols):
    """``max_new`` stops the expansion after that many additions, in the
    same order: the HF determinant and its first 7 excitations."""
    jmol, mol = mols
    out = sci.expand_support([mol.hf_det], np.ones(1), mol.qubit_num, 1,
                             max_new=7)
    jout = jsci.expand_support([jmol.hf_det], np.ones(1), jmol.qubit_num, 1,
                               max_new=7)
    assert out == jout and len(out) == 8 and mol.hf_det in out
    full = sci.expand_support([mol.hf_det], np.ones(1), mol.qubit_num, 1)
    assert full == jsci.expand_support([jmol.hf_det], np.ones(1),
                                       jmol.qubit_num, 1)


def test_heatbath_eps0(mols):
    """The heat-bath table equals JAX's, pair by pair; at eps 0 its
    expansion equals JAX's, is a subset of the unscreened one and keeps its
    restricted energy to 5e-7 Ha."""
    jmol, mol = mols
    table = sci.HeatBathTable(mol.h1, mol.v)
    jtable = jsci.HeatBathTable(jmol.h1, jmol.v)
    assert table.pairs.keys() == jtable.pairs.keys()
    for key, arrays in table.pairs.items():
        for a, ja in zip(arrays, jtable.pairs[key]):
            np.testing.assert_array_equal(a, ja, err_msg=str(key))
    hb = sci.expand_support_heatbath([mol.hf_det], np.ones(1), table,
                                     eps=0.0, n_parents=1)
    assert hb == jsci.expand_support_heatbath([jmol.hf_det], np.ones(1),
                                              jtable, eps=0.0, n_parents=1)
    ref = sci.expand_support([mol.hf_det], np.ones(1), mol.qubit_num, 1)
    assert set(hb) <= set(ref)
    e_hb, _ = sci.restricted_ground_state(hb, mol.h1, mol.v, mol.e_nuc)
    e_ref, _ = sci.restricted_ground_state(ref, mol.h1, mol.v, mol.e_nuc)
    assert abs(e_hb - e_ref) < 5e-7


def test_heatbath_screening(mols):
    """Thresholds 3e-2, 3e-3, 0: the same supports as JAX's, growing, with
    falling restricted energies; at 0 the CISD energy to 5e-7 Ha."""
    jmol, mol = mols
    table = sci.HeatBathTable(mol.h1, mol.v)
    jtable = jsci.HeatBathTable(jmol.h1, jmol.v)
    sizes, energies = [], []
    for eps in (3e-2, 3e-3, 0.0):
        s = sci.expand_support_heatbath([mol.hf_det], np.ones(1), table,
                                        eps=eps, n_parents=1)
        assert s == jsci.expand_support_heatbath(
            [jmol.hf_det], np.ones(1), jtable, eps=eps, n_parents=1)
        e, _ = sci.restricted_ground_state(s, mol.h1, mol.v, mol.e_nuc)
        je, _ = jsci.restricted_ground_state(s, jmol.h1, jmol.v, jmol.e_nuc)
        assert abs(e - je) < 1e-10
        sizes.append(len(s))
        energies.append(e)
    assert sizes[0] < sizes[1] <= sizes[2]
    assert energies[0] >= energies[1] >= energies[2] - 1e-12
    assert abs(energies[2] - jmol.cisd_energy) < 5e-7
