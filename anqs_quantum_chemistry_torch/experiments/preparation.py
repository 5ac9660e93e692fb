"""Factories wiring molecules to maskers.

Counterpart of the JAX package's ``experiments/preparation.py``
(reference: nqs/nqs/applications/quantum_chemistry/experiments/preparation/
create_masker.py:27-79).
"""

from __future__ import annotations

import numpy as np

from ..chem.jw import permute_det
from ..chem.molecule import Molecule
from ..symmetries import (
    ALLOWED_SYMMETRY_LEVELS,
    Masker,
    idle_symmetry,
    particle_number_symmetry,
    spin_projection_symmetry,
    z2_symmetry,
)


def create_masker(mol: Molecule, symmetry_level: str = "e_num_spin",
                  perm=None) -> Masker:
    """Symmetry level -> masker; Z2 reference values measured on the HF
    determinant (reference create_masker.py:36-50). ``perm`` relabels
    qubits (new qubit i = original spin-orbital perm[i]) consistently with
    ``chem.jw.permute_qubits_hamiltonian``."""
    if symmetry_level not in ALLOWED_SYMMETRY_LEVELS:
        raise ValueError(f"unknown symmetry level {symmetry_level!r}")
    n = mol.qubit_num
    if symmetry_level == "no_sym":
        return Masker([idle_symmetry(n)])
    syms = [particle_number_symmetry(n, mol.n_electrons)]
    if symmetry_level in ("e_num_spin", "z2"):
        syms.append(spin_projection_symmetry(n, mol.n_alpha - mol.n_beta,
                                             perm=perm))
    if symmetry_level == "z2":
        orig = list(range(n)) if perm is None else [int(p) for p in perm]
        hf_det = mol.hf_det if perm is None else permute_det(mol.hf_det,
                                                             perm)
        alpha_mask = sum(1 << i for i in range(n) if orig[i] % 2 == 0)
        beta_mask = sum(1 << i for i in range(n) if orig[i] % 2 == 1)
        for g_idx, g in enumerate(mol.z2_generators):
            g = np.asarray(g)[np.asarray(orig)]
            g_int = sum(1 << i for i in range(n) if g[i])
            # Generators implied by N/Sz (total and alpha parity) would be
            # redundant ordinals.
            if g_int in (alpha_mask, beta_mask, alpha_mask | beta_mask):
                continue
            ref = -1 if bin(hf_det & g_int).count("1") % 2 else 1
            syms.append(z2_symmetry(g, ref, name=f"z2_{g_idx}"))
    return Masker(syms)
