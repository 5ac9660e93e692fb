"""Parity of the port's direct CI (``chem/direct_ci.py``) with the JAX
package's on the CPU: the string tables, the sigma in float32 (against JAX's
``make_sigma``) and float64 (against ``host_sigma_f64``), the Davidson
solve, and ``Molecule``'s automatic direct-CI branch. LiH/STO-3G has equal
alpha and beta string sets, OH/STO-3G (5 alpha, 4 beta electrons) unequal
ones; both are read from the JAX package's molecule caches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem import direct_ci as jax_dci
from anqs_quantum_chemistry_torch.chem import direct_ci as dci
from anqs_quantum_chemistry_torch.chem import fci
from anqs_quantum_chemistry_torch.chem import molecule as molecule_mod
from anqs_quantum_chemistry_torch.chem.molecule import Molecule, MolConfig
from torch_port_common import molecules

NAMES = ("LiH", "OH")


@pytest.fixture(scope="module", params=NAMES)
def mol(request):
    return molecules(request.param)[1]


def test_tables_match_jax(mol):
    n_orb = mol.n_orbitals
    for n_elec in (mol.n_alpha, mol.n_beta):
        strs = dci.ci_strings(n_orb, n_elec)
        np.testing.assert_array_equal(strs, jax_dci.ci_strings(n_orb, n_elec))
        for got, ref in zip(dci.excitation_tables(strs, n_orb),
                            jax_dci.excitation_tables(strs, n_orb)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
        # The port keeps the float64 table JAX rounds to float32.
        h_ss = dci.same_spin_dense(strs, mol.h1, mol.v)
        assert h_ss.dtype == np.float64
        np.testing.assert_array_equal(
            h_ss.astype(np.float32),
            jax_dci.same_spin_dense(strs, mol.h1, mol.v))
    str_a = dci.ci_strings(n_orb, mol.n_alpha)
    str_b = dci.ci_strings(n_orb, mol.n_beta)
    np.testing.assert_array_equal(
        dci.interleave_parity(str_a, str_b, n_orb),
        jax_dci.interleave_parity(str_a, str_b, n_orb))
    for got, ref in zip(dci.spatial_from_spin_orbital(mol.h1, mol.v),
                        jax_dci.spatial_from_spin_orbital(mol.h1, mol.v)):
        np.testing.assert_array_equal(got, ref)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("block", [128, 256])
def test_sigma_matches_jax_and_host(mol, block):
    """At a random padded vector (numpy seed 0): the float32 torch sigma
    against JAX's float32 ``make_sigma`` to 1e-5 relative, the float64
    torch sigma against ``host_sigma_f64`` to 1e-10 relative; the shift
    enters as (H - shift) c."""
    ops = dci.sigma_operands(mol.h1, mol.v, mol.n_alpha, mol.n_beta,
                             block=block, device="cpu")
    sig32, sa, sb = dci.make_sigma(mol.n_orbitals, ops.s_alpha, ops.s_beta,
                                   block, torch.float32, "cpu")
    sig64, _, _ = dci.make_sigma(mol.n_orbitals, ops.s_alpha, ops.s_beta,
                                 block, torch.float64, "cpu")
    jax_sig, jsa, jsb = jax_dci.make_sigma(mol.n_orbitals, ops.s_alpha,
                                           ops.s_beta, block=block)
    assert (sa, sb) == (jsa, jsb)
    c = np.zeros((sa, sb))
    c[:ops.s_alpha, :ops.s_beta] = np.random.default_rng(0).standard_normal(
        (ops.s_alpha, ops.s_beta))
    tabs = [t.numpy() for t in ops.tables(torch.float64)]
    shift = ops.shift
    want32 = np.asarray(jax_sig(
        jnp.asarray(c, jnp.float32),
        *(jnp.asarray(t.astype(np.int32) if t.dtype == np.int64
                      else t.astype(np.float32)) for t in tabs),
        np.float32(shift)))
    got32 = sig32(torch.from_numpy(c).float(), *ops.tables(torch.float32),
                  shift).numpy()
    assert got32.dtype == np.float32
    assert rel(got32, want32) <= 1e-5
    got64 = sig64(torch.from_numpy(c), *ops.tables(torch.float64),
                  0.0).numpy()
    assert got64.dtype == np.float64
    assert rel(got64, dci.host_sigma_f64(c, *tabs, block=13)) <= 1e-10
    np.testing.assert_array_equal(
        dci.host_sigma_f64(c, *tabs),
        jax_dci.host_sigma_f64(c, *tabs))


def test_sigma_refuses_another_device(mol):
    """The sigma runs where its operands are, or raises: no fallback."""
    ops = dci.sigma_operands(mol.h1, mol.v, mol.n_alpha, mol.n_beta,
                             device="cpu")
    sig, sa, sb = dci.make_sigma(mol.n_orbitals, ops.s_alpha, ops.s_beta,
                                 device="meta")
    with pytest.raises(ValueError, match="must lie on"):
        sig(torch.zeros(sa, sb), *ops.tables(), 0.0)


def test_direct_ci_matches_jax_and_fci(mol):
    """The Davidson solve against JAX's at the same tolerance (the same
    iteration count, the float32 Ritz value within 1e-6 Ha, the ipr within
    1e-6) and against the sparse FCI of ``fci_ground_state``: the reported
    energy, the float64 quotient over the float64 tables, within 1e-7 Ha,
    the ipr within 1e-5. JAX's quotient upcasts float32 tables (1.7e-6 Ha
    from FCI at OH): the port's vector over those tables gives JAX's energy
    within 1e-8 Ha."""
    args = (mol.h1, mol.v, mol.n_alpha, mol.n_beta, mol.e_nuc)
    ref = jax_dci.direct_ci_ground_state(*args, tol=1e-6)
    got = dci.direct_ci_ground_state(*args, tol=1e-6, device="cpu",
                                     return_coeffs=True)
    assert got.iterations == ref.iterations
    assert abs(got.energy_f32 - ref.energy_f32) <= 1e-6
    assert abs(got.ipr - ref.ipr) <= 1e-6
    e_fci, _, coef, ipr = fci.fci_ground_state(*args)
    assert abs(got.energy - e_fci) <= 1e-7
    assert abs(got.ipr - ipr) <= 1e-5

    # The same vector over the tables rounded to float32, as JAX's.
    ops = dci.sigma_operands(mol.h1, mol.v, mol.n_alpha, mol.n_beta,
                             device="cpu")
    tabs = [t.numpy() for t in ops.tables(torch.float32)]
    c = np.zeros((tabs[0].shape[0], tabs[1].shape[0]))
    c[:ops.s_alpha, :ops.s_beta] = got.coeffs
    hc = dci.host_sigma_f64(c, *tabs)
    e_jax_tables = float(np.vdot(c, hc) / np.vdot(c, c)) + mol.e_nuc
    assert abs(e_jax_tables - ref.energy) <= 1e-8


def test_auto_direct_ci_beyond_lowered_cap(monkeypatch, tmp_path):
    """``Molecule.create`` takes the direct-CI branch above
    ``MAX_BF_FCI_QUBITS`` (lowered below LiH's 12 qubits, as JAX's test
    reaches it with LiH/6-31G's 22), on the device it is given: the energy
    within 1e-7 Ha of ``fci_ground_state``, the ipr within 1e-6 of JAX's
    ``direct_ci_ground_state``, both surviving the cache round trip. With the sector above ``MAX_DIRECT_CI_NDET`` there is no
    FCI."""
    monkeypatch.setattr(molecule_mod, "MAX_BF_FCI_QUBITS", 10)
    cfg = MolConfig(name="LiH")
    mol = Molecule.create(cfg, mols_dir=str(tmp_path), device="cpu")
    assert mol.qubit_num == 12
    ref = jax_dci.direct_ci_ground_state(mol.h1, mol.v, mol.n_alpha,
                                         mol.n_beta, mol.e_nuc, tol=1e-4)
    e_fci = fci.fci_ground_state(mol.h1, mol.v, mol.n_alpha, mol.n_beta,
                                 mol.e_nuc)[0]
    assert abs(mol.fci_energy - e_fci) <= 1e-7
    assert abs(mol.fci_ipr - ref.ipr) <= 1e-6
    assert mol.fci_energy < mol.cisd_energy < mol.hf_energy
    assert "fci" in mol.build_seconds
    again = Molecule.create(cfg, mols_dir=str(tmp_path), device="cpu")
    assert again.fci_energy == mol.fci_energy
    assert again.fci_ipr == mol.fci_ipr

    monkeypatch.setattr(molecule_mod, "MAX_DIRECT_CI_NDET", 100)
    small = Molecule.build(cfg, run_cisd=False, device="cpu")
    assert small.fci_energy is None and small.fci_ipr is None
