"""Parity of the port's molecule build from atoms with the JAX package's, on
the CPU: the basis and integrals (``chem/basis.py``, ``chem/integrals.py``),
RHF and ROHF (``chem/scf.py``), MP2, CISD, CCSD(T) and FCI, the whole
``Molecule`` of H2, LiH, H2O, OH and N2 at 2.0 angstrom, and the molecule
caches that the two packages write and read for each other."""

import os

import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.chem import molecule as jax_molecule
from anqs_quantum_chemistry_tpu.chem.basis import (
    basis_for_atoms as jax_basis_for_atoms,
)
from anqs_quantum_chemistry_tpu.chem.cc import ccsd as jax_ccsd
from anqs_quantum_chemistry_tpu.chem.cc import (
    ccsd_t_correction as jax_ccsd_t,
)
from anqs_quantum_chemistry_tpu.chem.fci import mp2_energy as jax_mp2_energy
from anqs_quantum_chemistry_tpu.chem.integrals import (
    compute_integrals_ao as jax_integrals,
)
from anqs_quantum_chemistry_tpu.chem.scf import rhf as jax_rhf
from anqs_quantum_chemistry_tpu.chem.scf import rohf as jax_rohf
from anqs_quantum_chemistry_torch.chem import geometry_repo
from anqs_quantum_chemistry_torch.chem.basis import (
    Shell,
    basis_for_atoms,
    nuclear_repulsion,
)
from anqs_quantum_chemistry_torch.chem.cc import ccsd, ccsd_t_correction
from anqs_quantum_chemistry_torch.chem.fci import mp2_energy
from anqs_quantum_chemistry_torch.chem.integrals import compute_integrals_ao
from anqs_quantum_chemistry_torch.chem.molecule import (
    GeometryConfig,
    Molecule,
    MolConfig,
    cache_name,
    spatial_integrals,
    spin_orbital_from_alpha_block,
)
from anqs_quantum_chemistry_torch.chem.scf import (
    mo_integrals,
    rhf,
    rohf,
    spin_orbital_integrals,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# runs/n2_dissociation.csv (the JAX package's TPU-era record; HF, CISD and
# FCI are host float64), row 2.0.
N2_R2_RECORD = (-107.06729389526026, -107.31528185085801, -107.45515453326401)


def configs(name, r=None):
    """(port MolConfig, JAX MolConfig) of ``name``, stretched to ``r``."""
    if r is None:
        return MolConfig(name=name), jax_molecule.MolConfig(name=name)
    return (MolConfig(name=name, geometry=GeometryConfig(
        type="linear", bond_length=r)),
        jax_molecule.MolConfig(name=name, geometry=jax_molecule.GeometryConfig(
            type="linear", bond_length=r)))


def atoms_of(name):
    return geometry_repo.geometry_bohr(geometry_repo.GEOMETRIES[name])


def assert_integrals_equal(got, ref):
    for key in ("S", "T", "V", "ERI"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-12,
                                   err_msg=key)


def test_geometry_and_basis_match_jax():
    from anqs_quantum_chemistry_tpu.chem import geometry_repo as jax_geo

    assert geometry_repo.GEOMETRIES == jax_geo.GEOMETRIES
    assert geometry_repo.MULTIPLICITIES == jax_geo.MULTIPLICITIES
    assert (geometry_repo.linear_geometry("N2", 1.45)
            == jax_geo.linear_geometry("N2", 1.45))
    for name, basis in (("H2O", "6-31g*"), ("Li2O", "sto-3g"),
                        ("Cr2", "sv")):
        atoms = atoms_of(name)
        got = [vars(s) for s in basis_for_atoms(atoms, basis)]
        ref = [vars(s) for s in jax_basis_for_atoms(atoms, basis)]
        assert got == ref
        from anqs_quantum_chemistry_tpu.chem.basis import (
            nuclear_repulsion as jax_nuc,
        )
        assert nuclear_repulsion(atoms) == jax_nuc(atoms)


def test_integrals_h2o_631g_match_jax():
    atoms = atoms_of("H2O")
    shells = basis_for_atoms(atoms, "6-31g")
    assert_integrals_equal(compute_integrals_ao(atoms, shells),
                           jax_integrals(atoms, shells))


def test_integrals_d_shells_match_jax():
    """The 6-31G* d polarisation shell of O, once Cartesian (6d) and once
    spherical (5d, ``_pure_transform``), beside O's and H's 6-31G shells
    at OH's geometry."""
    atoms = atoms_of("OH")
    d_shell = basis_for_atoms(atoms[:1], "6-31g*")[-1]
    assert d_shell.angmom == 2 and not d_shell.pure
    pure = Shell(d_shell.center, 2, d_shell.exps, d_shell.coefs, 0,
                 pure=True)
    shells = [basis_for_atoms(atoms, "6-31g")[-1], d_shell, pure]
    got = compute_integrals_ao(atoms, shells)
    assert got["S"].shape == (1 + 6 + 5,) * 2
    assert_integrals_equal(got, jax_integrals(atoms, shells))


def test_scf_matches_jax():
    """RHF (H2O) and ROHF (OH) on the same AO integrals: energies to
    1e-10, orbital energies to 1e-8; and the two routes to the
    spin-orbital integrals give the same ``v``."""
    for name, open_shell in (("H2O", False), ("OH", True)):
        atoms = atoms_of(name)
        ints = compute_integrals_ao(atoms, basis_for_atoms(atoms, "sto-3g"))
        h_core = ints["T"] + ints["V"]
        e_nuc = nuclear_repulsion(atoms)
        if open_shell:
            got = rohf(ints["S"], h_core, ints["ERI"], 5, 4, e_nuc)
            ref = jax_rohf(ints["S"], h_core, ints["ERI"], 5, 4, e_nuc)
        else:
            got = rhf(ints["S"], h_core, ints["ERI"], 10, e_nuc)
            ref = jax_rhf(ints["S"], h_core, ints["ERI"], 10, e_nuc)
        assert got["converged"] and ref["converged"]
        assert abs(got["hf_energy"] - ref["hf_energy"]) <= 1e-10
        np.testing.assert_allclose(got["mo_energy"], ref["mo_energy"],
                                   rtol=0, atol=1e-8)
    h_mo, eri_mo = mo_integrals(h_core, ints["ERI"], got["mo_coeff"])
    h1, v = spin_orbital_integrals(h_mo, eri_mo)
    h1b, vb = spin_orbital_from_alpha_block(*spatial_integrals(h1, v))
    np.testing.assert_array_equal(h1b, h1)
    np.testing.assert_array_equal(vb, v)


BUILDS = {"H2": None, "LiH": None, "H2O": None, "OH": None, "N2": 2.0}


@pytest.fixture(scope="module")
def builds():
    """name -> (port Molecule, JAX Molecule, port config, JAX config), each
    built from atoms by its own package (no cache), once a module."""
    done = {}

    def get(name):
        if name not in done:
            cfg, jcfg = configs(name, BUILDS[name])
            done[name] = (Molecule.build(cfg, device="cpu"),
                          jax_molecule.Molecule(jcfg), cfg, jcfg)
        return done[name]

    return get


@pytest.fixture(params=sorted(BUILDS))
def built(request, builds):
    return builds(request.param)


ENERGIES = ("hf_energy", "mp2_energy", "cisd_energy", "ccsd_energy",
            "ccsd_t_energy", "fci_energy")


def test_molecule_matches_jax(built):
    """Energies to 1e-9 Ha, integrals to 1e-10, the Pauli form and the
    Z-string generators equal, the same cache file name."""
    mol, ref, cfg, jcfg = built
    for key in ("qubit_num", "n_alpha", "n_beta", "n_electrons",
                "multiplicity", "hf_det"):
        assert getattr(mol, key) == getattr(ref, key), key
    assert mol.e_nuc == ref.e_nuc
    for key in ENERGIES:
        a, b = getattr(mol, key), getattr(ref, key)
        assert (a is None) == (b is None), key
        if a is not None:
            assert abs(a - b) <= 1e-9, (key, a, b)
    assert abs(mol.fci_ipr - ref.fci_ipr) <= 1e-8
    np.testing.assert_allclose(mol.mo_energy, ref.mo_energy, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(mol.h1, ref.h1, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mol.v, ref.v, rtol=0, atol=1e-10)
    ham, jham = mol.qubit_ham, ref.qubit_ham
    np.testing.assert_array_equal(ham.a_masks, jham.a_masks)
    np.testing.assert_array_equal(ham.b_words, jham.b_words)
    np.testing.assert_array_equal(ham.group_starts, jham.group_starts)
    np.testing.assert_allclose(ham.weights, jham.weights, rtol=0,
                               atol=1e-12)
    assert abs(ham.constant - jham.constant) <= 1e-10
    np.testing.assert_array_equal(mol.z2_generators, ref.z2_generators)
    assert cache_name(cfg) == jcfg.to_sha256_str()[:16] + ".npz"
    assert set(mol.build_seconds) == {"integrals", "scf", "jw", "z2",
                                      "mp2", "cisd", "ccsd_t", "fci"}


def test_correlated_methods_match_jax(built):
    """MP2 (closed shells; none for an open shell, as in JAX) and CCSD(T)
    called directly on the same integrals: 1e-12 and 1e-9 Ha."""
    mol, ref = built[:2]
    if mol.n_alpha == mol.n_beta:
        mo_so = np.repeat(mol.mo_energy, 2)
        assert abs(mp2_energy(mol.h1, mol.v, mo_so, mol.hf_det)
                   - jax_mp2_energy(mol.h1, mol.v, mo_so, mol.hf_det)
                   ) <= 1e-12
    else:
        assert mol.mp2_energy is None and ref.mp2_energy is None
    e, t1, t2, info = ccsd(mol.h1, mol.v, mol.hf_det, mol.e_nuc)
    je, jt1, jt2, jinfo = jax_ccsd(mol.h1, mol.v, mol.hf_det, mol.e_nuc)
    assert info["converged"] and jinfo["converged"]
    assert abs(e - je) <= 1e-9
    assert abs(ccsd_t_correction(mol.h1, mol.v, mol.hf_det, t1, t2)
               - jax_ccsd_t(mol.h1, mol.v, mol.hf_det, jt1, jt2)) <= 1e-9


def test_n2_stretched_matches_record(builds):
    """N2 at 2.0 angstrom against runs/n2_dissociation.csv to 1e-8 Ha."""
    mol = builds("N2")[0]
    with open(os.path.join(ROOT, "runs", "n2_dissociation.csv")) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    record = [float(x) for x in next(r for r in rows
                                     if float(r[0]) == 2.0)[1:4]]
    assert tuple(record) == N2_R2_RECORD
    got = (mol.hf_energy, mol.cisd_energy, mol.fci_energy)
    for a, b in zip(got, record):
        assert abs(a - b) <= 1e-8


def fields(mol):
    out = {k: getattr(mol, k) for k in ENERGIES + (
        "fci_ipr", "qubit_num", "n_alpha", "n_beta", "hf_det", "e_nuc",
        "multiplicity", "n_electrons")}
    out.update(mo_energy=mol.mo_energy, h1=mol.h1, v=mol.v,
               z2=mol.z2_generators, a=mol.qubit_ham.a_masks,
               b=mol.qubit_ham.b_words, w=mol.qubit_ham.weights,
               gs=mol.qubit_ham.group_starts, c=mol.qubit_ham.constant)
    return out


def assert_same_fields(a, b):
    fa, fb = fields(a), fields(b)
    for key, val in fa.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, fb[key], err_msg=key)
        else:
            assert val == fb[key], key


def test_caches_cross_read(built, tmp_path):
    """A cache the port writes is read by JAX's ``Molecule.create`` without
    a rebuild, and the reverse; each reads back what the other wrote."""
    mol, ref, cfg, jcfg = built
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    path = port_dir / cfg.name / cache_name(cfg)
    os.makedirs(path.parent)
    mol._save_cache(str(path))
    read_by_jax = jax_molecule.Molecule.create(jcfg, mols_dir=str(port_dir))
    assert_same_fields(read_by_jax, mol)
    jpath = jax_dir / cfg.name / cache_name(cfg)
    os.makedirs(jpath.parent)
    ref._save_cache(str(jpath))
    read_by_port = Molecule.create(cfg, mols_dir=str(jax_dir), device="cpu")
    assert read_by_port.build_seconds is None  # read, not built
    assert read_by_port.config == cfg
    assert_same_fields(read_by_port, ref)


def test_cache_upgrade(tmp_path):
    """A cache written without the baselines gets them on a later call
    that asks (JAX ``create``'s upgrade), and JAX reads the upgrade."""
    cfg, jcfg = configs("H2")
    bare = Molecule.create(cfg, mols_dir=str(tmp_path), run_fci=False,
                           run_cisd=False, device="cpu")
    assert bare.fci_energy is None and bare.cisd_energy is None
    full = Molecule.create(cfg, mols_dir=str(tmp_path), device="cpu")
    assert full.fci_energy is not None and full.ccsd_t_energy is not None
    jmol = jax_molecule.Molecule.create(jcfg, mols_dir=str(tmp_path),
                                        run_fci=False, run_cisd=False)
    assert jmol.fci_energy == full.fci_energy
    assert jmol.ccsd_t_energy == full.ccsd_t_energy


def test_unknown_molecule_raises():
    with pytest.raises(ValueError, match="Unknown molecule"):
        Molecule.build(MolConfig(name="XeF6"), device="cpu")
