"""Toy-model walkthrough: every layer of the stack on LiH, step by step --
the port's counterpart of the JAX package's
``examples/toy_model_walkthrough.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.toy_model_walkthrough \
        [iters] [mols_dir] [run_dir]

Builds LiH/STO-3G from atoms with the port's own chemistry (integrals, RHF,
MP2/CISD/CCSD(T)/FCI, the Jordan-Wigner form; cached under ``mols_dir``,
default ``mols``), then walks the masker, the qudit grouping, a MADE 64
ansatz, a 64-sample Gumbel draw, the sample-aware local energies and their
Monte-Carlo estimate, and trains with ``VMC.run`` (256 samples,
qubit_per_qudit 3, lr 1e-2, MinSR top 20; 1000 iterations by default) into
``run_dir`` (default ``runs/toy_lih_torch``), printing the JAX example's
lines.
"""

from __future__ import annotations

import sys

import torch

from ..chem.molecule import Molecule, MolConfig
from ..models.anqs import ANQS, AnqsConfig
from ..observables.pauli import PauliEngine, mc_estimate
from ..ops import keys
from ..optim.sr import SRConfig
from ..sampling.sampler import gumbel_top_k_sample
from ..symmetries import QubitGrouping
from .preparation import create_masker
from .vmc import VMC, VMCConfig

CHEMICAL_ACCURACY = 1.6e-3  # Ha


def main(argv=None, device="cuda"):
    argv = sys.argv if argv is None else argv
    iters = int(argv[1]) if len(argv) > 1 else 1000
    mols_dir = argv[2] if len(argv) > 2 else "mols"
    run_dir = argv[3] if len(argv) > 3 else "runs/toy_lih_torch"

    # Molecule: Gaussian integrals -> RHF -> MP2/CISD/CCSD(T)/FCI
    # baselines -> Jordan-Wigner bit-mask Hamiltonian.
    mol = Molecule.create(MolConfig(name="LiH", basis="sto-3g"),
                          mols_dir=mols_dir, device=device)
    print(f"LiH: {mol.qubit_num} qubits, {mol.n_electrons} electrons, "
          f"{mol.fci_ndet} determinants in the (N, Sz) sector")
    print(f"  HF      {mol.hf_energy:.6f} Ha")
    print(f"  MP2     {mol.mp2_energy:.6f}")
    print(f"  CISD    {mol.cisd_energy:.6f}")
    print(f"  CCSD(T) {mol.ccsd_t_energy:.6f}")
    print(f"  FCI     {mol.fci_energy:.6f}   (target)")

    # Symmetries: particle number and spin projection enforced during
    # sampling through the masker's table over accumulated quantum numbers.
    masker = create_masker(mol, "e_num_spin")
    grouping = QubitGrouping.create(masker, qubit_per_qudit=3)
    print(f"masker memo: {masker.memo.shape}, "
          f"{grouping.qudit_num} qudits of dims {grouping.qudit_dims}")

    # Ansatz.
    anqs = ANQS(grouping, AnqsConfig(hidden_widths=(64,)),
                torch.Generator().manual_seed(0)).to(device)

    # Sampling.
    generator = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        sample = gumbel_top_k_sample(anqs, 64, generator)
    print(f"sampled {int(sample.valid.sum())} distinct physical "
          f"determinants (Gumbel top-k)")

    # Energy: sample-aware local energies over the sorted set.
    engine = PauliEngine(mol.qubit_ham, device=device)
    words = torch.where(sample.valid[:, None], sample.words, 0xFFFFFFFF)
    sorted_words, _, valid = keys.sort_words(words, sample.valid)
    with torch.no_grad():
        la, ph = anqs.log_psi(sorted_words)
        e = engine.local_energy_proxy(sorted_words, la, ph, valid)
    theor = torch.where(valid, torch.exp(2.0 * la), 0.0)
    freqs = theor / torch.sum(theor)
    mean_re, _, _ = mc_estimate(e.e_re, e.e_im, freqs)
    print(f"initial variational energy: {float(mean_re):.6f} Ha "
          f"(HF is {mol.hf_energy:.6f})")

    # Training.
    vmc = VMC(mol,
              VMCConfig(sample_num=256, sampling_mode="gumbel",
                        qubit_per_qudit=3, lr=1e-2,
                        sr=SRConfig(max_indices_num=20)),
              AnqsConfig(hidden_widths=(64,)), device=device,
              run_dir=run_dir)
    _, _, best = vmc.run(iter_num=iters)
    gap = best["energy"] - mol.fci_energy
    verdict = ("chemical accuracy!" if gap < CHEMICAL_ACCURACY
               else "keep training")
    print(f"after {iters} iters: best {best['energy']:.6f} Ha, "
          f"gap to FCI {gap * 1000:.2f} mHa ({verdict})")
    return mol, best


if __name__ == "__main__":
    main()
