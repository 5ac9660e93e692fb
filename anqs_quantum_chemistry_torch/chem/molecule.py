"""Prepared molecules, read from a molecule file (no SCF).

A molecule file is the npz cache that the JAX package's
``chem/molecule.py`` writes (``Molecule._save_cache``); ``Molecule.from_npz``
reads the fields the training path needs, as ``Molecule._from_cache`` does.
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
from typing import Optional

import numpy as np

from .fci import SECTOR_MAX_DETS, sector_ground_energy
from .jw import PauliHamiltonian

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)
N2_STO3G = os.path.join(DATA_DIR, "n2_sto3g.npz")
LI2O_STO3G = os.path.join(DATA_DIR, "li2o_sto3g.npz")
C2H4_631G = os.path.join(DATA_DIR, "c2h4_631g.npz")

PACKAGED_KEYS = (
    "ham_constant", "ham_a_masks", "ham_b_words", "ham_weights",
    "ham_group_starts", "n_alpha", "n_beta", "n_electrons", "qubit_num",
    "multiplicity", "hf_det", "e_nuc", "hf_energy", "fci_energy",
    "z2_generators", "cisd_energy", "ccsd_t_energy",
)
# The spin-orbital integrals of a JAX-side cache (physicist's <pq|rs> in
# ``v``), and their spatial form, which the packaged files hold.
INTEGRAL_KEYS = ("h1", "v")
SPATIAL_KEYS = ("h1_spatial", "v_spatial")


def spatial_integrals(h1: np.ndarray, v: np.ndarray):
    """The alpha blocks (h1[0::2, 0::2], v[0::2, 0::2, 0::2, 0::2])."""
    return (np.ascontiguousarray(h1[0::2, 0::2]),
            np.ascontiguousarray(v[0::2, 0::2, 0::2, 0::2]))


def spin_orbital_integrals(h1s: np.ndarray, vs: np.ndarray):
    """Spatial (h1, v) -> the interleaved spin-orbital (h1, v)."""
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
    def from_npz(cls, path: str, name: Optional[str] = None) -> "Molecule":
        with np.load(path) as data:
            qubit_num = int(data["qubit_num"])
            integrals = {}
            if set(INTEGRAL_KEYS) <= set(data.files):
                integrals = {k: data[k] for k in INTEGRAL_KEYS}
            elif set(SPATIAL_KEYS) <= set(data.files):
                integrals = dict(zip(INTEGRAL_KEYS, spin_orbital_integrals(
                    *(data[k] for k in SPATIAL_KEYS))))
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


def load_c2h4() -> Molecule:
    """C2H4/6-31G: 52 qubits (two words a determinant), 104278 Pauli terms
    in 20776 groups, a ~2.4e12-determinant (8, 8) sector (no FCI energy),
    with its integrals (CISD, selected CI) and its CISD and CCSD(T)
    energies."""
    return Molecule.from_npz(C2H4_631G, name="C2H4")


def write_packaged(src: str, dst: str, integrals: bool = False) -> float:
    """Copy ``PACKAGED_KEYS`` of molecule file ``src`` (NaN for an energy
    it lacks; with ``integrals``, also the spatial form of its integrals,
    ``SPATIAL_KEYS``) into ``dst``; returns the FCI energy written
    (computed when ``src`` has none and its sector has at most
    ``SECTOR_MAX_DETS`` determinants, else NaN). Raises ``ValueError``
    when the spatial form does not rebuild ``src``'s integrals exactly."""
    with np.load(src) as data:
        arrays = {k: data[k] if k in data.files else np.array([np.nan])
                  for k in PACKAGED_KEYS}
        if integrals:
            h1, v = data["h1"], data["v"]
            h1s, vs = spatial_integrals(h1, v)
            back = spin_orbital_integrals(h1s, vs)
            if not (np.array_equal(back[0], h1)
                    and np.array_equal(back[1], v)):
                raise ValueError(f"{src}: the integrals are not the "
                                 "interleaved spin-orbital form of one "
                                 "spatial block")
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
    args = [a for a in sys.argv[1:] if a != "--integrals"]
    if len(args) != 2:
        sys.exit(__doc__)
    print(write_packaged(args[0], args[1],
                         integrals="--integrals" in sys.argv))
