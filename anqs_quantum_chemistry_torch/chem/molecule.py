"""Prepared molecules: built from atoms, or read from a molecule file.

``Molecule.create(MolConfig(name=...), mols_dir=...)`` builds any molecule
of ``chem/geometry_repo.py`` as the JAX package's ``chem/molecule.py``
does, on the host: the integrals (``chem/integrals.py``), RHF or ROHF
(``chem/scf.py``), the spin-orbital integrals, the Jordan-Wigner form
(``chem/jw.py``), MP2, CISD, CCSD and CCSD(T) (``chem/cc.py``), and the FCI
energy: sparse eigsh up to ``MAX_BF_FCI_QUBITS`` qubits, direct CI on the
card (``chem/direct_ci.py``) up to ``MAX_DIRECT_CI_NDET`` determinants. It
caches the result as ``<mols_dir>/<name>/<sha256(config)[:16]>.npz`` with
JAX's keys and file name, so the two packages read each other's caches.

A molecule file is such an npz cache; ``Molecule.from_npz`` is the one
reader (JAX ``Molecule._from_cache``) and takes the keys a file lacks as
absent.

The molecules the port trains on ship inside this package, so a checkout
that carries no ``mols/`` directory runs them: N2/STO-3G, the main path
(``data/n2_sto3g.npz``), Li2O/STO-3G, the dynamic-membership path
(``data/li2o_sto3g.npz``), and C2H4/6-31G, the flagship
(``data/c2h4_631g.npz``). To regenerate one from a JAX-side cache:

    python -m anqs_quantum_chemistry_torch.chem.molecule SRC.npz DST.npz

which copies ``PACKAGED_KEYS`` (the Pauli form, the sizes, the HF, CISD and
CCSD(T) energies; NaN where the cache has none) and, where the source holds
no FCI energy and the sector has at most ``fci.SECTOR_MAX_DETS``
determinants, computes it by exact diagonalisation of the sector
Hamiltonian (``chem/fci.py``); a larger sector keeps NaN. With

    python -m anqs_quantum_chemistry_torch.chem.molecule --integrals SRC DST

it also writes the integrals in their spatial form (``SPATIAL_KEYS``):
the spin orbitals are interleaved (even = alpha, odd = beta), h1 is
spin-diagonal and ``v[p,q,r,s] = <pq|rs>`` is nonzero only where spin(p) =
spin(r) and spin(q) = spin(s), with the same spatial value for every such
spin assignment. So the (n/2, n/2) alpha block of h1 and the (n/2)^4 alpha
block of v determine both exactly, at a sixteenth of v's bytes (C2H4's
spin-orbital v is 52^4 float64, 58 MB); ``write_packaged`` checks that the
rebuild is exact before it writes. ``from_npz`` rebuilds the spin-orbital
``h1``/``v`` that selected CI and CISD read (``chem/fci.py``
``sparse_hamiltonian``). The JAX-side caches are built in-tree (no
download), N2 in ``mols/`` by the JAX package's tests and Li2O with

    python -c "from anqs_quantum_chemistry_tpu.chem.molecule import \
        Molecule, MolConfig; Molecule.create(MolConfig(name='Li2O'), \
        mols_dir='mols', run_fci=False, run_cisd=False)"

(SCF and Jordan-Wigner, under a minute on one CPU core); C2H4's ships in
the repository's ``mols/``. The packaged files:

    python -m anqs_quantum_chemistry_torch.chem.molecule \
        mols/N2/48b46d0296274267.npz anqs_quantum_chemistry_torch/data/n2_sto3g.npz
    python -m anqs_quantum_chemistry_torch.chem.molecule --integrals \
        mols/Li2O/2e6cfa7d2f52366c.npz anqs_quantum_chemistry_torch/data/li2o_sto3g.npz
    python -m anqs_quantum_chemistry_torch.chem.molecule --integrals \
        mols/C2H4/f20120f6863e7b16.npz anqs_quantum_chemistry_torch/data/c2h4_631g.npz
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Optional

import numpy as np

from ..utils.config import Config
from . import fci as fci_mod
from .basis import ELEMENTS, basis_for_atoms, nuclear_repulsion
from .fci import SECTOR_MAX_DETS, sector_ground_energy
from .geometry_repo import (GEOMETRIES, MULTIPLICITIES, geometry_bohr,
                            linear_geometry)
from .integrals import compute_integrals_ao
from .jw import (PauliHamiltonian, jordan_wigner_pauli_hamiltonian,
                 z_string_symmetries)
from .scf import mo_integrals, rhf, rohf, spin_orbital_integrals

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)
N2_STO3G = os.path.join(DATA_DIR, "n2_sto3g.npz")
LI2O_STO3G = os.path.join(DATA_DIR, "li2o_sto3g.npz")
C2H4_631G = os.path.join(DATA_DIR, "c2h4_631g.npz")
CR2_SV = os.path.join(DATA_DIR, "cr2_sv.npz")

PACKAGED_KEYS = (
    "ham_constant", "ham_a_masks", "ham_b_words", "ham_weights",
    "ham_group_starts", "n_alpha", "n_beta", "n_electrons", "qubit_num",
    "multiplicity", "hf_det", "e_nuc", "hf_energy", "fci_energy",
    "z2_generators", "cisd_energy", "ccsd_t_energy",
)
# The spin-orbital integrals of a JAX-side cache (physicist's <pq|rs> in
# ``v``), and their spatial form, which the packaged files hold: the alpha
# block of v, or (``PACKED_KEYS``) its 8-fold packed chemist form, with the
# molecule's orbital energies and MP2 energy beside it (``EXTRA_KEYS``).
INTEGRAL_KEYS = ("h1", "v")
SPATIAL_KEYS = ("h1_spatial", "v_spatial")
PACKED_KEYS = ("h1_spatial", "eri_packed")
EXTRA_KEYS = ("mo_energy", "mp2_energy")
# The eight copies of a molecular-orbital integral agree only to the
# roundoff of the integral transform (8.4e-15 Ha at Cr2/SV, whose largest
# is 14.7 Ha): the packed form keeps one, and is written only if every
# copy is within this many Ha of it.
PACK_TOL = 1e-12

# FCI by sparse eigsh up to this many qubits (JAX's cutoff, the reference's
# max_fci_qubits), by direct CI up to this many sector determinants; larger
# sectors (Li2O's 41.4M) go through an explicit ``run_direct_fci()``.
MAX_BF_FCI_QUBITS = 20
MAX_DIRECT_CI_NDET = 2_000_000


@dataclasses.dataclass
class GeometryConfig(Config):
    type: str = "carleo"
    idx: int = 0
    bond_length: Optional[float] = None  # angstrom, for dissociation curves


@dataclasses.dataclass
class MolConfig(Config):
    """A molecule of ``geometry_repo``; serialises as JAX's ``MolConfig``
    does, so ``to_sha256_str()[:16]`` names the same cache file."""

    name: str = "LiH"
    basis: str = "sto-3g"
    geometry: GeometryConfig = dataclasses.field(
        default_factory=GeometryConfig)
    multiplicity: Optional[int] = None
    charge: int = 0


def spatial_integrals(h1: np.ndarray, v: np.ndarray):
    """The alpha blocks (h1[0::2, 0::2], v[0::2, 0::2, 0::2, 0::2])."""
    return (np.ascontiguousarray(h1[0::2, 0::2]),
            np.ascontiguousarray(v[0::2, 0::2, 0::2, 0::2]))


def _pair_index(n: int):
    """(i, j) of the n (n + 1) / 2 spatial pairs i >= j, in the order
    i (i + 1) / 2 + j."""
    return np.tril_indices(n)


def pack_eri(vs: np.ndarray) -> np.ndarray:
    """The physicist alpha block <pq|rs> -> the chemist (pr|qs) over pair
    indices ij >= kl (i >= j, k >= l): the 8-fold packed form of real
    orbitals' integrals, n_pair (n_pair + 1) / 2 values, each the copy
    with i >= j, k >= l, ij >= kl."""
    n = vs.shape[0]
    i, j = _pair_index(n)
    chem = vs.transpose(0, 2, 1, 3)[i[:, None], j[:, None], i[None, :],
                                    j[None, :]]  # (n_pair, n_pair)
    return np.ascontiguousarray(chem[np.tril_indices(len(i))])


def unpack_eri(packed: np.ndarray, n: int) -> np.ndarray:
    """``pack_eri``'s inverse: the (n, n, n, n) physicist alpha block, each
    value copied to its eight places."""
    i, j = _pair_index(n)
    n_pair = len(i)
    sq = np.zeros((n_pair, n_pair), packed.dtype)
    sq[np.tril_indices(n_pair)] = packed
    sq = sq + np.tril(sq, -1).T
    chem = np.zeros((n,) * 4, packed.dtype)
    for a, b in ((i, j), (j, i)):
        for c, d in ((i, j), (j, i)):
            chem[a[:, None], b[:, None], c[None, :], d[None, :]] = sq
    return np.ascontiguousarray(chem.transpose(0, 2, 1, 3))


def spin_orbital_from_alpha_block(h1s: np.ndarray, vs: np.ndarray):
    """The alpha blocks of ``spatial_integrals`` -> the interleaved
    spin-orbital (h1, v). (``scf.spin_orbital_integrals`` takes the chemist
    ``eri_mo`` instead.)"""
    n = h1s.shape[0]
    h1 = np.zeros((2 * n, 2 * n), h1s.dtype)
    v = np.zeros((2 * n,) * 4, vs.dtype)
    for s1 in (0, 1):
        h1[s1::2, s1::2] = h1s
        for s2 in (0, 1):
            v[s1::2, s2::2, s1::2, s2::2] = vs
    return h1, v


def _energy(data, key: str) -> Optional[float]:
    if key not in data.files:
        return None
    e = float(np.asarray(data[key]).reshape(-1)[0])
    return None if np.isnan(e) else e


def _nan(value: Optional[float]) -> np.ndarray:
    return np.array([np.nan if value is None else value])


@dataclasses.dataclass
class Molecule:
    name: str
    qubit_num: int
    n_alpha: int
    n_beta: int
    n_electrons: int
    multiplicity: int
    hf_det: int
    e_nuc: float
    hf_energy: float
    fci_energy: Optional[float]
    z2_generators: np.ndarray
    qubit_ham: PauliHamiltonian
    # Spin-orbital integrals, where the file holds them (JAX
    # ``Molecule._from_cache`` reads them always).
    h1: Optional[np.ndarray] = None
    v: Optional[np.ndarray] = None
    # The JAX molecule build's CISD and CCSD(T) energies, where it ran them
    # (the C2H4 examples report "% of CCSD(T) correlation").
    cisd_energy: Optional[float] = None
    ccsd_t_energy: Optional[float] = None
    # The rest of a molecule cache (JAX ``_from_cache``), where present.
    mo_energy: Optional[np.ndarray] = None
    mp2_energy: Optional[float] = None
    ccsd_energy: Optional[float] = None
    fci_ipr: Optional[float] = None
    # What a build from atoms knows besides: its config and the seconds of
    # each stage ("integrals", "scf", "jw", "z2", "mp2", "cisd", "ccsd_t",
    # "fci").
    config: Optional[MolConfig] = None
    build_seconds: Optional[dict] = None

    @property
    def n_orbitals(self) -> int:
        return self.qubit_num // 2

    @property
    def fci_ndet(self) -> int:
        """Determinant count of the (N_alpha, N_beta) sector."""
        return math.comb(self.n_orbitals, self.n_alpha) * math.comb(
            self.n_orbitals, self.n_beta
        )

    @classmethod
    def build(cls, config: MolConfig, run_fci: bool = True,
              run_cisd: bool = True, device="cuda") -> "Molecule":
        """Build from atoms (JAX ``Molecule.__init__``): integrals, RHF
        (ROHF for an open shell), the JW form, MP2 (closed shell), with
        ``run_cisd`` CISD and CCSD(T), with ``run_fci`` the FCI energy
        (direct CI on ``device`` above ``MAX_BF_FCI_QUBITS``), and the
        Z-string symmetry generators. Raises ``ValueError`` on a name that
        ``geometry_repo`` lacks, ``RuntimeError`` if the SCF fails."""
        if config.name not in GEOMETRIES:
            raise ValueError(f"Unknown molecule '{config.name}'; available: "
                             f"{sorted(GEOMETRIES)}")
        seconds = {}
        t0 = time.perf_counter()
        geom = GEOMETRIES[config.name]
        if config.geometry.bond_length is not None:
            geom = linear_geometry(config.name, config.geometry.bond_length)
        atoms = geometry_bohr(geom)
        multiplicity = config.multiplicity or MULTIPLICITIES.get(
            config.name, 1)
        n_electrons = (sum(ELEMENTS[el] for el, _ in atoms)
                       - config.charge)
        ints = compute_integrals_ao(atoms, basis_for_atoms(atoms,
                                                           config.basis))
        e_nuc = nuclear_repulsion(atoms)
        h_core = ints["T"] + ints["V"]
        n_alpha = (n_electrons + (multiplicity - 1)) // 2
        n_beta = n_electrons - n_alpha
        t1 = time.perf_counter()
        seconds["integrals"] = t1 - t0
        if n_alpha == n_beta:
            scf_res = rhf(ints["S"], h_core, ints["ERI"], n_electrons, e_nuc)
        else:
            # Open shell: ROHF, one set of spatial orbitals, so the
            # interleaved spin-orbital transform applies unchanged.
            scf_res = rohf(ints["S"], h_core, ints["ERI"], n_alpha, n_beta,
                           e_nuc)
        if not scf_res["converged"]:
            raise RuntimeError(f"SCF failed to converge for {config.name}")
        h_mo, eri_mo = mo_integrals(h_core, ints["ERI"], scf_res["mo_coeff"])
        h1, v = spin_orbital_integrals(h_mo, eri_mo)
        t2 = time.perf_counter()
        seconds["scf"] = t2 - t1
        qubit_num = 2 * h_mo.shape[0]
        hf_det = (sum(1 << (2 * o) for o in range(n_alpha))
                  | sum(1 << (2 * o + 1) for o in range(n_beta)))
        ham = jordan_wigner_pauli_hamiltonian(h1, v, constant=e_nuc)
        t3 = time.perf_counter()
        seconds["jw"] = t3 - t2
        z2_generators = z_string_symmetries(ham)
        t3 = time.perf_counter()
        seconds["z2"] = t3 - t2 - seconds["jw"]
        mol = cls(
            name=config.name, qubit_num=qubit_num, n_alpha=n_alpha,
            n_beta=n_beta, n_electrons=n_electrons,
            multiplicity=multiplicity, hf_det=hf_det, e_nuc=e_nuc,
            hf_energy=scf_res["hf_energy"], fci_energy=None,
            z2_generators=z2_generators, qubit_ham=ham, h1=h1,
            v=v, mo_energy=scf_res["mo_energy"], config=config,
            build_seconds=seconds,
        )
        if n_alpha == n_beta:
            mol.mp2_energy = mol.hf_energy + fci_mod.mp2_energy(
                h1, v, np.repeat(mol.mo_energy, 2), hf_det)
        # ROHF-MP2 is not uniquely defined with Roothaan effective orbital
        # energies: an open shell gets none, as in JAX.
        seconds["mp2"] = time.perf_counter() - t3
        if run_cisd:
            mol._compute_correlated_baselines()
        if run_fci:
            mol._compute_fci(device)
        return mol

    def _compute_fci(self, device="cuda") -> bool:
        """The sector's exact ground state where tractable: sparse eigsh up
        to ``MAX_BF_FCI_QUBITS`` qubits, else direct CI on ``device`` up to
        ``MAX_DIRECT_CI_NDET`` determinants. True if it ran."""
        t0 = time.perf_counter()
        if self.qubit_num <= MAX_BF_FCI_QUBITS:
            e, _, _, ipr = fci_mod.fci_ground_state(
                self.h1, self.v, self.n_alpha, self.n_beta, self.e_nuc)
            self.fci_energy = float(e)
            self.fci_ipr = float(ipr)
        elif self.fci_ndet <= MAX_DIRECT_CI_NDET:
            self.run_direct_fci(device=device)
        else:
            return False
        self._seconds("fci", t0)
        return True

    def run_direct_fci(self, device="cuda") -> float:
        """The FCI energy by direct CI on ``device`` (beyond the eigsh cap:
        Li2O/STO-3G's 41.4M determinants), to JAX's residual of 1e-4."""
        from .direct_ci import direct_ci_ground_state

        res = direct_ci_ground_state(self.h1, self.v, self.n_alpha,
                                     self.n_beta, self.e_nuc, tol=1e-4,
                                     device=device)
        self.fci_energy = float(res.energy)
        self.fci_ipr = float(res.ipr)
        return self.fci_energy

    def _compute_correlated_baselines(self):
        """CISD, CCSD and CCSD(T) (JAX ``_compute_correlated_baselines``;
        CCSD and (T) stay None if CCSD does not converge)."""
        from .cc import ccsd, ccsd_t_correction

        t0 = time.perf_counter()
        self.cisd_energy = float(fci_mod.cisd_ground_state(
            self.h1, self.v, self.hf_det, self.e_nuc)[0])
        t0 = self._seconds("cisd", t0)
        e_cc, t1, t2, info = ccsd(self.h1, self.v, self.hf_det, self.e_nuc)
        if info["converged"]:
            self.ccsd_energy = float(e_cc)
            self.ccsd_t_energy = float(e_cc + ccsd_t_correction(
                self.h1, self.v, self.hf_det, t1, t2))
        self._seconds("ccsd_t", t0)

    def _seconds(self, stage: str, t0: float) -> float:
        now = time.perf_counter()
        if self.build_seconds is not None:
            self.build_seconds[stage] = now - t0
        return now

    @classmethod
    def create(cls, config: MolConfig, mols_dir: str = "mols",
               run_fci: bool = True, run_cisd: bool = True,
               device="cuda") -> "Molecule":
        """Read ``<mols_dir>/<name>/<sha256(config)[:16]>.npz`` or build
        and write it (JAX ``Molecule.create``). A cache written without
        the CISD/CCSD ladder or the FCI energy (NaN) gets what a caller
        asks for computed and the file rewritten. ``device``: where direct
        CI runs."""
        cache_dir = os.path.join(mols_dir, config.name)
        path = os.path.join(cache_dir, cache_name(config))
        if os.path.exists(path):
            mol = cls.from_npz(path, name=config.name, config=config)
            upgraded = False
            if run_cisd and mol.cisd_energy is None:
                mol._compute_correlated_baselines()
                upgraded = True
            if run_fci and mol.fci_energy is None:
                upgraded = mol._compute_fci(device) or upgraded
            if upgraded:
                mol._save_cache(path)
            return mol
        mol = cls.build(config, run_fci=run_fci, run_cisd=run_cisd,
                        device=device)
        os.makedirs(cache_dir, exist_ok=True)
        mol._save_cache(path)
        return mol

    def _save_cache(self, path: str):
        """Write the molecule cache with JAX's keys (``_save_cache``)."""
        ham = self.qubit_ham
        np.savez_compressed(
            path,
            e_nuc=self.e_nuc,
            hf_energy=self.hf_energy,
            mo_energy=self.mo_energy,
            h1=self.h1,
            v=self.v,
            n_alpha=self.n_alpha,
            n_beta=self.n_beta,
            hf_det=np.array([self.hf_det], dtype=np.uint64),
            qubit_num=self.qubit_num,
            mp2_energy=_nan(self.mp2_energy),
            cisd_energy=_nan(self.cisd_energy),
            ccsd_energy=_nan(self.ccsd_energy),
            ccsd_t_energy=_nan(self.ccsd_t_energy),
            fci_energy=_nan(self.fci_energy),
            fci_ipr=_nan(self.fci_ipr),
            multiplicity=self.multiplicity,
            n_electrons=self.n_electrons,
            ham_constant=ham.constant,
            ham_a_masks=ham.a_masks,
            ham_b_words=ham.b_words,
            ham_weights=ham.weights,
            ham_group_starts=ham.group_starts,
            z2_generators=self.z2_generators,
        )

    @classmethod
    def from_npz(cls, path: str, name: Optional[str] = None,
                 config: Optional[MolConfig] = None) -> "Molecule":
        with np.load(path) as data:
            qubit_num = int(data["qubit_num"])
            integrals = {}
            if set(INTEGRAL_KEYS) <= set(data.files):
                integrals = {k: data[k] for k in INTEGRAL_KEYS}
            elif set(SPATIAL_KEYS) <= set(data.files):
                integrals = dict(zip(
                    INTEGRAL_KEYS, spin_orbital_from_alpha_block(
                        *(data[k] for k in SPATIAL_KEYS))))
            elif set(PACKED_KEYS) <= set(data.files):
                h1s = data["h1_spatial"]
                integrals = dict(zip(
                    INTEGRAL_KEYS, spin_orbital_from_alpha_block(
                        h1s, unpack_eri(data["eri_packed"], h1s.shape[0]))))
            return cls(
                name=name or os.path.basename(os.path.dirname(path)),
                qubit_num=qubit_num,
                n_alpha=int(data["n_alpha"]),
                n_beta=int(data["n_beta"]),
                n_electrons=int(data["n_electrons"]),
                multiplicity=int(data["multiplicity"]),
                hf_det=int(data["hf_det"][0]),
                e_nuc=float(data["e_nuc"]),
                hf_energy=float(data["hf_energy"]),
                fci_energy=_energy(data, "fci_energy"),
                cisd_energy=_energy(data, "cisd_energy"),
                ccsd_t_energy=_energy(data, "ccsd_t_energy"),
                mo_energy=(data["mo_energy"] if "mo_energy" in data.files
                           else None),
                mp2_energy=_energy(data, "mp2_energy"),
                ccsd_energy=_energy(data, "ccsd_energy"),
                fci_ipr=_energy(data, "fci_ipr"),
                config=config,
                z2_generators=data["z2_generators"],
                qubit_ham=PauliHamiltonian(
                    qubit_num=qubit_num,
                    constant=float(data["ham_constant"]),
                    a_masks=data["ham_a_masks"],
                    b_words=data["ham_b_words"],
                    weights=data["ham_weights"],
                    group_starts=data["ham_group_starts"],
                ),
                **integrals,
            )


def cache_name(config: MolConfig) -> str:
    """The molecule cache's file name: JAX's ``<sha256(config)[:16]>.npz``."""
    return config.to_sha256_str()[:16] + ".npz"


def load_n2() -> Molecule:
    """N2/STO-3G at its equilibrium geometry: 20 qubits, 2958 Pauli terms in
    536 groups, a 14400-determinant (7, 7) sector."""
    return Molecule.from_npz(N2_STO3G, name="N2")


def load_li2o() -> Molecule:
    """Li2O/STO-3G, the reference's toy-model molecule: 30 qubits, 16169
    Pauli terms in 3072 groups, a 41,409,225-determinant (7, 7) sector (no
    FCI energy: too large to diagonalise here), with its spin-orbital
    integrals (selected CI)."""
    return Molecule.from_npz(LI2O_STO3G, name="Li2O")


def load_cr2() -> Molecule:
    """Cr2/SV (the reference's custom basis), built from atoms by this
    package: 84 qubits (three words a determinant), 2,240,694 Pauli terms
    in 471,774 groups, a (24, 24) sector (no FCI energy), with its
    integrals (packed), orbital energies and MP2 energy."""
    return Molecule.from_npz(CR2_SV, name="Cr2")


def load_c2h4() -> Molecule:
    """C2H4/6-31G: 52 qubits (two words a determinant), 104278 Pauli terms
    in 20776 groups, a ~2.4e12-determinant (8, 8) sector (no FCI energy),
    with its integrals (CISD, selected CI) and its CISD and CCSD(T)
    energies."""
    return Molecule.from_npz(C2H4_631G, name="C2H4")


def write_packaged(src: str, dst: str, integrals: bool = False,
                   packed: bool = False) -> float:
    """Copy ``PACKAGED_KEYS`` of molecule file ``src`` (NaN for an energy
    it lacks; with ``integrals``, also the spatial form of its integrals,
    ``SPATIAL_KEYS``; with ``packed``, the packed form, ``PACKED_KEYS``,
    and ``EXTRA_KEYS``) into ``dst``; returns the FCI energy written
    (computed when ``src`` has none and its sector has at most
    ``SECTOR_MAX_DETS`` determinants, else NaN). Raises ``ValueError``
    when the spatial form does not rebuild ``src``'s integrals exactly, or
    the packed form not to ``PACK_TOL``."""
    with np.load(src) as data:
        arrays = {k: data[k] if k in data.files else np.array([np.nan])
                  for k in PACKAGED_KEYS}
        if integrals or packed:
            h1, v = data["h1"], data["v"]
            h1s, vs = spatial_integrals(h1, v)
            back = spin_orbital_from_alpha_block(h1s, vs)
            if not (np.array_equal(back[0], h1)
                    and np.array_equal(back[1], v)):
                raise ValueError(f"{src}: the integrals are not the "
                                 "interleaved spin-orbital form of one "
                                 "spatial block")
            if packed:
                eri = pack_eri(vs)
                dev = np.max(np.abs(unpack_eri(eri, len(h1s)) - vs))
                if dev > PACK_TOL:
                    raise ValueError(f"{src}: the integrals are 8-fold "
                                     f"symmetric only to {dev:.2e} Ha")
                arrays.update(zip(PACKED_KEYS, (h1s, eri)))
                arrays.update({k: data[k] for k in EXTRA_KEYS})
            else:
                arrays.update(zip(SPATIAL_KEYS, (h1s, vs)))
    mol_fci = float(np.asarray(arrays["fci_energy"]).reshape(-1)[0])
    if np.isnan(mol_fci):
        mol = Molecule.from_npz(src)
        if mol.fci_ndet <= SECTOR_MAX_DETS:
            mol_fci = sector_ground_energy(mol.qubit_ham, mol.n_alpha,
                                           mol.n_beta)
            arrays["fci_energy"] = np.array([mol_fci])
    np.savez_compressed(dst, **arrays)
    return mol_fci


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a not in ("--integrals", "--packed")]
    if len(args) != 2:
        sys.exit(__doc__)
    print(write_packaged(args[0], args[1],
                         integrals="--integrals" in sys.argv,
                         packed="--packed" in sys.argv))
