"""Seconds of the stages of the port's Cr2/SV molecule build on this host
(CPU only, one thread).

    OMP_NUM_THREADS=1 python tools/time_cr2_build.py [quartets] [seed]

What ``Molecule.create(MolConfig(name="Cr2", basis="sv"))`` runs, stage by
stage, without the hour the whole build takes on one core:

- integrals: the one-electron integrals in full, and ``quartets``
  (default 24) shell quartets of the two-electron loop (``chem/
  integrals.py`` ``_shell_quartet_eri``), drawn with numpy ``seed``
  (default 0) from the loop's unique quartets and scaled to their count;
- from the packaged ``data/cr2_sv.npz`` integrals (``load_cr2``): the
  Jordan-Wigner transform, which must give the file's Pauli form again
  (the same T, M and arrays), the Z-string symmetry generators and MP2.

The SCF is not timed: it needs the whole AO ERI tensor. Prints one JSON
line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from anqs_quantum_chemistry_torch.chem import fci, integrals  # noqa: E402
from anqs_quantum_chemistry_torch.chem.basis import (  # noqa: E402
    basis_for_atoms,
)
from anqs_quantum_chemistry_torch.chem.geometry_repo import (  # noqa: E402
    GEOMETRIES,
    geometry_bohr,
)
from anqs_quantum_chemistry_torch.chem.jw import (  # noqa: E402
    jordan_wigner_pauli_hamiltonian,
    z_string_symmetries,
)
from anqs_quantum_chemistry_torch.chem.molecule import load_cr2  # noqa: E402


def unique_quartets(n_shell: int):
    """The (i, j, k, l) that ``compute_integrals_ao``'s loop visits."""
    return [(i, j, k, l) for i in range(n_shell) for j in range(i + 1)
            for k in range(i + 1) for l in range((j if k == i else k) + 1)]


def main(argv=None):
    argv = sys.argv if argv is None else argv
    n_sample = int(argv[1]) if len(argv) > 1 else 24
    seed = int(argv[2]) if len(argv) > 2 else 0
    out = {"host_threads": os.environ.get("OMP_NUM_THREADS")}

    atoms = geometry_bohr(GEOMETRIES["Cr2"])
    shells = basis_for_atoms(atoms, "sv")
    data = integrals._BasisData(shells)
    t = time.perf_counter()
    for i, sh_i in enumerate(data.shells):
        for j in range(i, len(data.shells)):
            integrals._shell_pair_1e(sh_i, data.norm_coefs[i],
                                     data.shells[j], data.norm_coefs[j],
                                     atoms)
    out["one_electron_s"] = time.perf_counter() - t
    quartets = unique_quartets(len(data.shells))
    pick = np.random.default_rng(seed).choice(len(quartets), n_sample,
                                              replace=False)
    t = time.perf_counter()
    for q in pick:
        integrals._shell_quartet_eri(data.shells, data.norm_coefs,
                                     quartets[q])
    per = (time.perf_counter() - t) / n_sample
    out.update(shells=len(data.shells), ao=data.n_ao,
               eri_quartets=len(quartets), eri_sampled=n_sample,
               eri_s_per_quartet=per, eri_loop_s_est=per * len(quartets))

    mol = load_cr2()
    want = mol.qubit_ham
    t = time.perf_counter()
    ham = jordan_wigner_pauli_hamiltonian(mol.h1, mol.v,
                                          constant=mol.e_nuc)
    out["jw_s"] = time.perf_counter() - t
    same = (ham.n_terms == want.n_terms and ham.n_groups == want.n_groups
            and all(np.array_equal(getattr(ham, k), getattr(want, k))
                    for k in ("a_masks", "b_words", "group_starts"))
            and np.allclose(ham.weights, want.weights, rtol=0, atol=1e-12))
    out["jw_equals_packaged"] = bool(same)
    t = time.perf_counter()
    z_string_symmetries(ham)
    out["z2_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fci.mp2_energy(mol.h1, mol.v, np.repeat(mol.mo_energy, 2), mol.hf_det)
    out["mp2_s"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
