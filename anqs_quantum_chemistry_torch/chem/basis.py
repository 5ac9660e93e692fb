"""Gaussian basis sets (standalone; no external basis-set libraries).

The reference delegates all of this to PySCF (reference:
nqs/nqs/applications/quantum_chemistry/run_pyscf.py:108-192); here the basis
data is embedded so the framework has zero chemistry dependencies.

STO-3G is generated from the universal STO-3G least-squares expansions of
Slater orbitals with zeta = 1 (Hehre, Stewart, Pople, JCP 51, 2657 (1969)):
primitive exponents scale as ``alpha * zeta**2`` with the published per-element
zeta values. 6-31G data for H/C/N/O is embedded directly (Hehre, Ditchfield,
Pople, JCP 56, 2257 (1972) values as distributed by basis-set exchanges).

Contractions use Cartesian primitives; only s and p shells are required for
the supported first-row elements.

The port's own copy of the JAX package's ``chem/basis.py`` (numpy and scipy only,
unchanged in its arithmetic), so that the port builds molecules without
importing the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

ELEMENTS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30,
}

# Universal STO-3G expansions of zeta=1 Slater orbitals: (exponent, coef).
_STO3G_1S = (
    (2.227660584, 0.154328967),
    (0.405771156, 0.535328142),
    (0.109818000, 0.444634542),
)
_STO3G_2SP_EXP = (0.994203000, 0.231031000, 0.075138600)
_STO3G_2S_COEF = (-0.099967230, 0.399512826, 0.700115469)
_STO3G_2P_COEF = (0.155916275, 0.607683719, 0.391957393)

# Published STO-3G zeta values (1s, 2sp) per element.
_STO3G_ZETA = {
    "H": (1.24, None),
    "He": (1.69, None),
    "Li": (2.69, 0.80),
    "Be": (3.68, 1.15),
    "B": (4.68, 1.50),
    "C": (5.67, 1.72),
    "N": (6.67, 1.95),
    "O": (7.66, 2.25),
    "F": (8.65, 2.55),
    "Ne": (9.64, 2.88),
}

# Third row (Na-Ar): universal 3sp expansion + per-element
# (zeta_1s, zeta_2sp, zeta_3sp), derived in-tree by tools/fit_sto3g.py
# with the exact Hehre-Stewart-Pople prescription (the same code
# reproduces the published 1s/2sp tables above to 6-7 digits). Zetas are
# variational best-atom values (Nelder-Mead over the in-tree (RO)HF
# atomic energy; virial -V/T = 2.0000 at each optimum). Atomic energies
# at these zetas, for regression: Na -159.810319, Mg -197.193647,
# Al -239.039321, Si -285.580054, P -336.965384, S -393.203781,
# Cl -454.581965, Ar -521.264922 Ha.
_STO3G_3SP_EXP = (0.482854028, 0.134715060, 0.052726564)
_STO3G_3S_COEF = (-0.219620377, 0.225595429, 0.900398439)
_STO3G_3P_COEF = (0.010587615, 0.595166989, 0.462001016)

_STO3G_ZETA3 = {
    "Na": (10.6783, 3.5183, 1.3514),
    "Mg": (11.6717, 3.9189, 1.2786),
    "Al": (12.6627, 4.3773, 1.3578),
    "Si": (13.6521, 4.8533, 1.5308),
    "P": (14.6406, 5.3322, 1.7290),
    "S": (15.6282, 5.8122, 1.9262),
    "Cl": (16.6151, 6.2925, 2.1311),
    "Ar": (17.6013, 6.7731, 2.3402),
}

# 6-31G: element -> list of (angmom_label, [(exp, coef_s[, coef_p]), ...]).
_631G: Dict[str, list] = {
    "H": [
        ("S", [(18.7311370, 0.03349460),
               (2.8253937, 0.23472695),
               (0.6401217, 0.81375733)]),
        ("S", [(0.1612778, 1.0)]),
    ],
    "Li": [
        ("S", [(642.41892, 0.0021426), (96.798515, 0.0162089),
               (22.091121, 0.0773156), (6.2010703, 0.2457860),
               (1.9351177, 0.4701890), (0.6367358, 0.3454708)]),
        ("SP", [(2.3249184, -0.0350917, 0.0089415),
                (0.6324306, -0.1912328, 0.1410095),
                (0.0790534, 1.0839878, 0.9453637)]),
        ("SP", [(0.0359620, 1.0, 1.0)]),
    ],
    "Be": [
        ("S", [(1264.5857, 0.0019448), (189.93681, 0.0148351),
               (43.159089, 0.0720906), (12.098663, 0.2371542),
               (3.8063232, 0.4691987), (1.2728903, 0.3565202)]),
        ("SP", [(3.1964631, -0.1126487, 0.0559802),
                (0.7478133, -0.2295064, 0.2615506),
                (0.2199663, 1.1869167, 0.7939723)]),
        ("SP", [(0.0823099, 1.0, 1.0)]),
    ],
    "B": [
        ("S", [(2068.8823, 0.0018663), (310.64957, 0.0142515),
               (70.683033, 0.0695516), (19.861080, 0.2325729),
               (6.2993048, 0.4670787), (2.1270270, 0.3634314)]),
        ("SP", [(4.7279710, -0.1303938, 0.0745976),
                (1.1903377, -0.1307889, 0.3078467),
                (0.3594117, 1.1309444, 0.7434568)]),
        ("SP", [(0.1267512, 1.0, 1.0)]),
    ],
    "C": [
        ("S", [(3047.5249, 0.0018347), (457.36951, 0.0140373),
               (103.94869, 0.0688426), (29.210155, 0.2321844),
               (9.2866630, 0.4679413), (3.1639270, 0.3623120)]),
        ("SP", [(7.8682724, -0.1193324, 0.0689991),
                (1.8812885, -0.1608542, 0.3164240),
                (0.5442493, 1.1434564, 0.7443083)]),
        ("SP", [(0.1687144, 1.0, 1.0)]),
    ],
    "N": [
        ("S", [(4173.5110, 0.0018348), (627.45790, 0.0139950),
               (142.90210, 0.0685870), (40.234330, 0.2322410),
               (12.820210, 0.4690700), (4.3904370, 0.3604550)]),
        ("SP", [(11.626358, -0.1149610, 0.0675800),
                (2.7162800, -0.1691180, 0.3239070),
                (0.7722180, 1.1458520, 0.7408950)]),
        ("SP", [(0.2120313, 1.0, 1.0)]),
    ],
    "O": [
        ("S", [(5484.6717, 0.0018311), (825.23495, 0.0139501),
               (188.04696, 0.0684451), (52.964500, 0.2327143),
               (16.897570, 0.4701930), (5.7996353, 0.3585209)]),
        ("SP", [(15.539616, -0.1107775, 0.0708743),
                (3.5999336, -0.1480263, 0.3397528),
                (1.0137618, 1.1307670, 0.7271586)]),
        ("SP", [(0.2700058, 1.0, 1.0)]),
    ],
    "F": [
        ("S", [(7001.7131, 0.0018196169), (1051.3660, 0.0139160796),
               (239.28569, 0.0684053245), (67.397445, 0.2331857600),
               (21.519957, 0.4712674390), (7.4031013, 0.3566185460)]),
        ("SP", [(20.847952, -0.1085069750, 0.0716287243),
                (4.8083083, -0.1464516580, 0.3459121030),
                (1.3440699, 1.1286885800, 0.7224699570)]),
        ("SP", [(0.3581514, 1.0, 1.0)]),
    ],
    "Ne": [
        ("S", [(8425.8515, 0.0018843481), (1268.5194, 0.0143368994),
               (289.62141, 0.0701096233), (81.859004, 0.2373732660),
               (26.251979, 0.4730071261), (9.0947205, 0.3484012410)]),
        ("SP", [(26.532131, -0.1071182870, 0.0719095885),
                (5.6264575, -0.1461638210, 0.3495133720),
                (1.5954910, 1.1283873200, 0.7199405120)]),
        ("SP", [(0.4869870, 1.0, 1.0)]),
    ],
}


@dataclasses.dataclass(frozen=True)
class Shell:
    """A contracted Cartesian Gaussian shell on one center.

    ``pure=True`` marks a shell whose final AOs are real solid harmonics
    (5d instead of Cartesian 6d): integrals are still assembled over the
    Cartesian components and transformed at the end
    (integrals.compute_integrals_ao). The reference's Cr SV/vdz bases are
    spherical (reference: run_pyscf.py:26-27 'SPHERICAL' directive).
    """

    center: Tuple[float, float, float]
    angmom: int  # 0 = s, 1 = p, 2 = d
    exps: Tuple[float, ...]
    coefs: Tuple[float, ...]  # contraction coefficients (unnormalized input)
    atom_index: int
    pure: bool = False

    @property
    def n_functions(self) -> int:
        """Cartesian component count (the integral-assembly width)."""
        l = self.angmom
        return (l + 1) * (l + 2) // 2

    @property
    def n_final(self) -> int:
        """AO count after the optional spherical transform."""
        return 2 * self.angmom + 1 if self.pure else self.n_functions

    def cartesian_powers(self) -> List[Tuple[int, int, int]]:
        l = self.angmom
        out = []
        for i in range(l, -1, -1):
            for j in range(l - i, -1, -1):
                out.append((i, j, l - i - j))
        return out


def _sto3g_shells(element: str) -> List[Tuple[str, list]]:
    if element in _STO3G_ZETA3:
        z1, z2, z3 = _STO3G_ZETA3[element]
    elif element in _STO3G_ZETA:
        z1, z2 = _STO3G_ZETA[element]
        z3 = None
    else:
        raise NotImplementedError(
            f"STO-3G data for {element} not embedded yet"
        )
    shells = [
        ("S", [(a * z1**2, c) for a, c in _STO3G_1S]),
    ]
    if z2 is not None:
        shells.append((
            "SP",
            [
                (a * z2**2, cs, cp)
                for a, cs, cp in zip(
                    _STO3G_2SP_EXP, _STO3G_2S_COEF, _STO3G_2P_COEF
                )
            ],
        ))
    if z3 is not None:
        shells.append((
            "SP",
            [
                (a * z3**2, cs, cp)
                for a, cs, cp in zip(
                    _STO3G_3SP_EXP, _STO3G_3S_COEF, _STO3G_3P_COEF
                )
            ],
        ))
    return shells


# 6-31G* polarization d exponents (Hariharan & Pople 1973 standard values);
# single uncontracted Cartesian 6d shell on non-hydrogen atoms.
_631G_STAR_D = {
    "Li": 0.2, "Be": 0.4, "B": 0.6, "C": 0.8, "N": 0.8, "O": 0.8,
    "F": 0.8, "Ne": 0.8,
}

# The reference's custom Cr split-valence basis for the Cr2 application
# ((14s,8p,5d) -> [5s,2p,2d], SPHERICAL): identical primitive data to its
# 'cr_vdz_basis_string'/'sv_basis' tables (reference:
# nqs/nqs/applications/quantum_chemistry/run_pyscf.py:26-106). 'D5' marks
# spherical (5-component) d shells.
_CR_SV = [
    ("S", [(51528.086349, 0.14405823106e-02),
           (7737.2103487, 0.11036202287e-01),
           (1760.3748470, 0.54676651806e-01),
           (496.87706544, 0.18965038103),
           (161.46520598, 0.38295412850),
           (55.466352268, 0.29090050668)]),
    ("S", [(107.54732999, -0.10932281100),
           (12.408671897, 0.64472599471),
           (5.0423628826, 0.46262712560)]),
    ("S", [(8.5461640165, -0.22711013286),
           (1.3900441221, 0.73301527591),
           (0.56066602876, 0.44225565433)]),
    ("S", [(0.71483705972e-01, 1.0)]),
    ("S", [(0.28250687604e-01, 1.0)]),
    ("P", [(640.48536096, 0.96126715203e-02),
           (150.69711194, 0.70889834655e-01),
           (47.503755296, 0.27065258990),
           (16.934120165, 0.52437343414),
           (6.2409680590, 0.34107994714)]),
    ("P", [(3.0885463206, 0.33973986903),
           (1.1791047769, 0.57272062927),
           (0.43369774432, 0.24582728206)]),
    ("D5", [(27.559479426, 0.30612488044e-01),
            (7.4687020327, 0.15593270944),
            (2.4345903574, 0.36984421276),
            (0.78244754808, 0.47071118077)]),
    ("D5", [(0.21995774311, 0.33941649889)]),
]


def _element_shell_data(element: str, basis: str):
    basis = basis.lower().replace("-", "")
    if basis == "sto3g":
        return _sto3g_shells(element)
    if basis in ("631g", "631g*", "631gs"):
        if element not in _631G:
            raise NotImplementedError(
                f"6-31G data for {element} not embedded yet"
            )
        shells = list(_631G[element])
        if basis != "631g" and element in _631G_STAR_D:
            shells.append(("D", [(_631G_STAR_D[element], 1.0)]))
        return shells
    if basis in ("sv", "vdz", "cr_sv"):
        # The reference's custom split-valence set for the Cr2 system
        # (identical primitives under both of its names, run_pyscf.py:26-106).
        if element != "Cr":
            raise NotImplementedError(
                f"sv/vdz basis only embedded for Cr (got {element})"
            )
        return _CR_SV
    raise ValueError(f"Unknown basis: {basis}")


def basis_for_atoms(
    atoms: Sequence[Tuple[str, Tuple[float, float, float]]],
    basis: str = "sto-3g",
) -> List[Shell]:
    """Build the shell list for atoms [(element, xyz_bohr), ...]."""
    shells: List[Shell] = []
    for atom_idx, (element, xyz) in enumerate(atoms):
        for label, rows in _element_shell_data(element, basis):
            exps = tuple(r[0] for r in rows)
            if label == "S":
                shells.append(Shell(tuple(xyz), 0, exps,
                                    tuple(r[1] for r in rows), atom_idx))
            elif label == "SP":
                shells.append(Shell(tuple(xyz), 0, exps,
                                    tuple(r[1] for r in rows), atom_idx))
                shells.append(Shell(tuple(xyz), 1, exps,
                                    tuple(r[2] for r in rows), atom_idx))
            elif label == "P":
                shells.append(Shell(tuple(xyz), 1, exps,
                                    tuple(r[1] for r in rows), atom_idx))
            elif label == "D":
                # Cartesian 6d (Pople convention); the MD integral
                # recursion is general in l, and RHF energies are invariant
                # to per-function scaling (absorbed by the generalized
                # eigenproblem), so the shared shell norm suffices.
                shells.append(Shell(tuple(xyz), 2, exps,
                                    tuple(r[1] for r in rows), atom_idx))
            elif label == "D5":
                # Spherical (real solid harmonic) 5d: assembled Cartesian,
                # transformed in compute_integrals_ao.
                shells.append(Shell(tuple(xyz), 2, exps,
                                    tuple(r[1] for r in rows), atom_idx,
                                    pure=True))
            else:
                raise ValueError(label)
    return shells


def nuclear_repulsion(
    atoms: Sequence[Tuple[str, Tuple[float, float, float]]]
) -> float:
    e = 0.0
    for i in range(len(atoms)):
        zi = ELEMENTS[atoms[i][0]]
        ri = np.asarray(atoms[i][1], dtype=float)
        for j in range(i + 1, len(atoms)):
            zj = ELEMENTS[atoms[j][0]]
            rj = np.asarray(atoms[j][1], dtype=float)
            e += zi * zj / np.linalg.norm(ri - rj)
    return float(e)
