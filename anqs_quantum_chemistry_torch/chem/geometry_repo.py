"""Hardcoded molecular geometries (angstrom) and multiplicities.

Counterpart of the reference's geometry tables
(reference: nqs/nqs/applications/quantum_chemistry/molecule_repository.py:1-57,
which stores the Carleo-paper equilibrium geometries); same physical data,
sourced from the published papers.

The port's own copy of the JAX package's ``chem/geometry_repo.py`` (numpy and scipy only,
unchanged in its arithmetic), so that the port builds molecules without
importing the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

ANGSTROM_TO_BOHR = 1.8897259886

Geometry = List[Tuple[str, Tuple[float, float, float]]]

# Equilibrium geometries (angstrom) used by the ANQS papers.
GEOMETRIES: Dict[str, Geometry] = {
    "H2": [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 0.7414))],
    "LiH": [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.5949))],
    "H2O": [
        ("O", (0.0, 0.0, 0.1173)),
        ("H", (0.0, 0.7572, -0.4692)),
        ("H", (0.0, -0.7572, -0.4692)),
    ],
    "BeH2": [
        ("Be", (0.0, 0.0, 0.0)),
        ("H", (0.0, 0.0, 1.3264)),
        ("H", (0.0, 0.0, -1.3264)),
    ],
    "N2": [("N", (0.0, 0.0, 0.0)), ("N", (0.0, 0.0, 1.0977))],
    "C2": [("C", (0.0, 0.0, 0.0)), ("C", (0.0, 0.0, 1.2425))],
    "Li2O": [
        ("O", (0.0, 0.0, 0.0)),
        ("Li", (0.0, 0.0, 1.51903)),
        ("Li", (0.0, 0.0, -1.51903)),
    ],
    "NH3": [
        ("N", (0.0, 0.0, 0.1490)),
        ("H", (0.0, 0.9471, -0.3479)),
        ("H", (0.8202, -0.4736, -0.3479)),
        ("H", (-0.8202, -0.4736, -0.3479)),
    ],
    "CH4": [
        ("C", (0.0, 0.0, 0.0)),
        ("H", (0.6276, 0.6276, 0.6276)),
        ("H", (0.6276, -0.6276, -0.6276)),
        ("H", (-0.6276, 0.6276, -0.6276)),
        ("H", (-0.6276, -0.6276, 0.6276)),
    ],
    "C2H4": [
        ("C", (0.0, 0.0, 0.6695)),
        ("C", (0.0, 0.0, -0.6695)),
        ("H", (0.0, 0.9289, 1.2321)),
        ("H", (0.0, -0.9289, 1.2321)),
        ("H", (0.0, 0.9289, -1.2321)),
        ("H", (0.0, -0.9289, -1.2321)),
    ],
    # Open-shell systems (ROHF references).
    "OH": [("O", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 0.9697))],
    "O2": [("O", (0.0, 0.0, 0.0)), ("O", (0.0, 0.0, 1.2075))],
    "NH2": [
        ("N", (0.0, 0.0, 0.0)),
        ("H", (0.0, 0.8031, 0.6349)),
        ("H", (0.0, -0.8031, 0.6349)),
    ],
    "Li": [("Li", (0.0, 0.0, 0.0))],
    "O": [("O", (0.0, 0.0, 0.0))],
    # Cr2 (the reference's custom-SV-basis application, run_pyscf.py:26-106);
    # experimental equilibrium bond length 1.6788 A.
    "Cr": [("Cr", (0.0, 0.0, 0.0))],
    "Cr2": [("Cr", (0.0, 0.0, 0.0)), ("Cr", (0.0, 0.0, 1.6788))],
}

MULTIPLICITIES: Dict[str, int] = {name: 1 for name in GEOMETRIES}
MULTIPLICITIES.update(
    {"OH": 2, "NH2": 2, "Li": 2, "O2": 3, "O": 3, "Cr": 7}
)


def linear_geometry(name: str, bond_length: float) -> Geometry:
    """Stretched diatomic geometries for dissociation curves."""
    el = {"H2": "H", "N2": "N", "Li2": "Li", "C2": "C"}[name]
    return [(el, (0.0, 0.0, 0.0)), (el, (0.0, 0.0, bond_length))]


def geometry_bohr(geom: Geometry) -> Geometry:
    return [
        (el, tuple(c * ANGSTROM_TO_BOHR for c in xyz)) for el, xyz in geom
    ]
