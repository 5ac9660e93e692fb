"""The port's Slater-Condon builder (``chem/native.py``,
``csrc/slater_condon.cpp``) and the integral form of ``chem/fci.py``
against the port's Python loop and the JAX package's
``sparse_hamiltonian``, to 1e-12 Ha on every element: whole sectors of LiH
and H2O, and random sorted subsets of N2's sector. A missing ``g++``
raises. The top 8192 determinants of Li2O's selected-CI target give the
JAX package's restricted energy to 1e-10 Ha."""

import os

import numpy as np
import pytest
import scipy.sparse

from anqs_quantum_chemistry_tpu.chem import fci as jfci
from anqs_quantum_chemistry_tpu.chem import selected_ci as jsci
from anqs_quantum_chemistry_torch.chem import fci, native
from anqs_quantum_chemistry_torch.chem import selected_ci as sci
from anqs_quantum_chemistry_torch.chem.molecule import load_li2o
from anqs_quantum_chemistry_torch.experiments.li2o_support_ci import (
    load_target,
)
from torch_port_common import molecules

LI2O_TOP8192_E0 = -88.7053389233  # the JAX package's builder, eigsh


def native_csr(dets, h1, v):
    rows, cols, vals = native.sparse_hamiltonian_native(
        np.asarray(dets, np.uint64), h1, v)
    return scipy.sparse.csr_matrix((vals, (rows, cols)),
                                   shape=(len(dets), len(dets)))


def max_diff(a, b):
    d = abs(a - b)
    return d.max() if d.nnz else 0.0


def subsets():
    """(name, sorted determinant list): whole sectors of LiH and H2O, and
    two random sorted subsets of N2's 14400-determinant sector."""
    rng = np.random.default_rng(0)
    out = []
    for name in ("LiH", "H2O", "N2", "N2"):
        jmol, _ = molecules(name)
        dets = jfci.sector_determinants(jmol.qubit_num, jmol.n_alpha,
                                        jmol.n_beta)
        if name == "N2":
            dets = sorted(rng.choice(dets, 700, replace=False).tolist())
        out.append((name, dets))
    return out


@pytest.mark.parametrize("case", range(4))
def test_builder_matches_plain_and_jax(case):
    name, dets = subsets()[case]
    jmol, mol = molecules(name)
    h_nat = native_csr(dets, mol.h1, mol.v)
    h_plain = fci.sparse_hamiltonian_plain(dets, mol.h1, mol.v)
    h_jax = jfci.sparse_hamiltonian(dets, jmol.h1, jmol.v, use_native=False)
    # The builder drops |H_ij| <= 1e-14, the loops only exact zeros.
    assert h_plain.nnz == h_jax.nnz >= h_nat.nnz
    assert max_diff(h_nat, h_plain) < 1e-12
    assert max_diff(h_plain, h_jax) < 1e-12
    h = fci.sparse_hamiltonian(dets, mol.h1, mol.v)
    assert max_diff(h, h_jax) < 1e-12


def test_matrix_element_matches_jax():
    """Single elements, diagonal, single and double excitations (and a
    triple, zero) of LiH's sector, element by element."""
    jmol, mol = molecules("LiH")
    dets = jfci.sector_determinants(jmol.qubit_num, jmol.n_alpha,
                                    jmol.n_beta)
    rng = np.random.default_rng(1)
    for a, b in rng.integers(0, len(dets), (300, 2)):
        x, y = dets[a], dets[b]
        assert (fci.matrix_element(x, y, mol.h1, mol.v)
                == jfci.matrix_element(x, y, jmol.h1, jmol.v))
    assert fci.diagonal_energy(dets[3], mol.h1, mol.v) == (
        jfci.diagonal_energy(dets[3], jmol.h1, jmol.v))


def test_sparse_hamiltonian_routes(monkeypatch):
    """A sorted list above 512 determinants goes through the builder; a
    shorter or unsorted one through the Python loop (JAX's rule), which
    keeps the list's order."""
    jmol, mol = molecules("N2")
    dets = subsets()[2][1]
    calls = []
    real = native.sparse_hamiltonian_native
    monkeypatch.setattr(native, "sparse_hamiltonian_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fci.sparse_hamiltonian(dets, mol.h1, mol.v)
    assert calls == [1]
    fci.sparse_hamiltonian(dets[:512], mol.h1, mol.v)
    shuffled = dets[::-1]
    h = fci.sparse_hamiltonian(shuffled, mol.h1, mol.v)
    assert calls == [1]
    h_jax = jfci.sparse_hamiltonian(shuffled, jmol.h1, jmol.v,
                                    use_native=False)
    assert max_diff(h, h_jax) < 1e-12


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """With no library built and no ``g++`` on PATH the builder raises; it
    does not fall back to the Python loop."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load()
    dets = subsets()[2][1]
    _, mol = molecules("N2")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        fci.sparse_hamiltonian(dets, mol.h1, mol.v)
    assert not os.listdir(tmp_path)


def test_li2o_top8192_energy():
    """H over the top 8192 of the packaged Li2O target by |coef| (the
    packaged integrals): the same nonzeros as the JAX package's builder
    and its lowest eigenvalue, -88.7053389233 Ha, to 1e-10."""
    mol = load_li2o()
    td, tc, _ = load_target()
    d8, _ = sci.truncate_by_weight(td, tc, 8192)
    h = fci.sparse_hamiltonian(d8, mol.h1, mol.v)
    assert h.nnz == 848_626
    e, _ = sci.restricted_ground_state(d8, mol.h1, mol.v, mol.e_nuc)
    jd8, _ = jsci.truncate_by_weight(td, tc, 8192)
    je, _ = jsci.restricted_ground_state(jd8, mol.h1, mol.v, mol.e_nuc)
    assert d8 == jd8
    assert abs(e - je) < 1e-10
    assert abs(e - LI2O_TOP8192_E0) < 1e-10
