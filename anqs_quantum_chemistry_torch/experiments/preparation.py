"""Factories wiring molecules to maskers.

Counterpart of the JAX package's ``experiments/preparation.py``
(reference: nqs/nqs/applications/quantum_chemistry/experiments/preparation/
create_masker.py:27-79), without the qubit-permutation option.
"""

from __future__ import annotations

from ..chem.molecule import Molecule
from ..symmetries import (
    ALLOWED_SYMMETRY_LEVELS,
    Masker,
    idle_symmetry,
    particle_number_symmetry,
    spin_projection_symmetry,
    z2_symmetry,
)


def create_masker(mol: Molecule, symmetry_level: str = "e_num_spin") -> Masker:
    """Symmetry level -> masker; Z2 reference values measured on the HF
    determinant (reference create_masker.py:36-50)."""
    if symmetry_level not in ALLOWED_SYMMETRY_LEVELS:
        raise ValueError(f"unknown symmetry level {symmetry_level!r}")
    n = mol.qubit_num
    if symmetry_level == "no_sym":
        return Masker([idle_symmetry(n)])
    syms = [particle_number_symmetry(n, mol.n_electrons)]
    if symmetry_level in ("e_num_spin", "z2"):
        syms.append(spin_projection_symmetry(n, mol.n_alpha - mol.n_beta))
    if symmetry_level == "z2":
        alpha_mask = sum(1 << i for i in range(0, n, 2))
        beta_mask = sum(1 << i for i in range(1, n, 2))
        for g_idx, g in enumerate(mol.z2_generators):
            g_int = sum(1 << i for i in range(n) if g[i])
            # Generators implied by N/Sz (total and alpha parity) would be
            # redundant ordinals.
            if g_int in (alpha_mask, beta_mask, alpha_mask | beta_mask):
                continue
            ref = -1 if bin(mol.hf_det & g_int).count("1") % 2 else 1
            syms.append(z2_symmetry(g, ref, name=f"z2_{g_idx}"))
    return Masker(syms)
