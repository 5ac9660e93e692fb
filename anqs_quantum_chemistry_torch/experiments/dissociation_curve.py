"""N2/STO-3G dissociation curve on one card: VMC against HF, CISD and FCI at
stretched geometries. The port's counterpart of the JAX package's
``examples/dissociation_curve.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.dissociation_curve \
        [n_points] [iters] [r ...]

The bond lengths are ``np.linspace(0.9, 2.0, n_points)`` angstrom (default
5 points); with ``r`` arguments, only those of them that are closest to
each ``r``. Each molecule is built from atoms by ``Molecule.create`` (cached
in ``mols/``, FCI by sparse eigsh at 20 qubits). The example's recipe:
exact summation over the sector, MinSR top 50, Adam 1e-3, gradient clip
1.0, qubit_per_qudit 10, MADE 512, seed 0, windows of 25 steps, no
checkpoints. Each point trains in ``runs/n2_r<r>`` (``iters`` iterations,
default 4000) and appends ``r,hf,cisd,fci,vmc`` to
``runs/n2_dissociation.csv`` when it finishes; a point whose ``FINISHED``
marker exists is skipped, so an interrupted sweep resumes where it stopped.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..chem.molecule import GeometryConfig, Molecule, MolConfig
from ..models.anqs import AnqsConfig
from ..optim.sr import SRConfig
from .vmc import VMC, VMCConfig

CSV_HEADER = "r_angstrom,hf,cisd,fci,vmc\n"
CHEMICAL_ACCURACY = 1.6e-3  # Ha


def n2_at(r: float, mols_dir: str = "mols", device="cuda") -> Molecule:
    """N2/STO-3G at bond length ``r`` angstrom, from atoms (cached)."""
    geometry = GeometryConfig(type="linear", bond_length=float(r))
    return Molecule.create(
        MolConfig(name="N2", basis="sto-3g", geometry=geometry),
        mols_dir=mols_dir, device=device)


def dissociation_vmc(mol: Molecule, device="cuda",
                     run_dir=None) -> VMC:
    """The example's trainer for one point."""
    return VMC(
        mol,
        VMCConfig(sampling_mode="exact", sr=SRConfig(max_indices_num=50),
                  lr=1e-3, grad_clip_norm=1.0, qubit_per_qudit=10),
        AnqsConfig(hidden_widths=(512,)),
        device=device,
        run_dir=run_dir,
    )


def main(argv=None, device="cuda", mols_dir="mols", run_root="runs"):
    argv = sys.argv if argv is None else argv
    n_points = int(argv[1]) if len(argv) > 1 else 5
    iters = int(argv[2]) if len(argv) > 2 else 4000
    lengths = np.linspace(0.9, 2.0, n_points)
    if len(argv) > 3:
        lengths = sorted({float(lengths[np.argmin(np.abs(lengths - float(r)))])
                          for r in argv[3:]})

    os.makedirs(run_root, exist_ok=True)
    summary = os.path.join(run_root, "n2_dissociation.csv")
    if not os.path.exists(summary):
        with open(summary, "w") as f:
            # No '#' prefix: np.genfromtxt(names=True) reads this row.
            f.write(CSV_HEADER)

    results = {}
    for r in lengths:
        t0 = time.perf_counter()
        run_dir = os.path.join(run_root, f"n2_r{r:.3f}")
        marker = os.path.join(run_dir, "FINISHED")
        mol = n2_at(r, mols_dir, device)
        if os.path.exists(marker):
            best_e, _ = np.load(os.path.join(run_dir, "best_energy.npy"))
            print(f"r={r:.3f}  skipped (FINISHED, best {best_e:.5f})",
                  flush=True)
            continue
        vmc = dissociation_vmc(mol, device, run_dir)
        hit = {}
        t_train = time.perf_counter()

        def progress(it, row):
            if (not hit and row["energy"] - mol.fci_energy
                    < CHEMICAL_ACCURACY):
                hit.update(iter=it, seconds=time.perf_counter() - t_train)

        _, history, best = vmc.run(iter_num=iters, steps_per_call=25,
                                   checkpoint_every=None, on_iter=progress)
        train_s = time.perf_counter() - t_train
        with open(marker, "w") as f:
            f.write(f"iters={iters}\n")
        with open(summary, "a") as f:
            f.write(f"{r},{mol.hf_energy},{mol.cisd_energy},"
                    f"{mol.fci_energy},{best['energy']}\n")
        results[float(r)] = dict(
            mol=mol, best=best, first_within=hit, train_s=train_s,
            s_per_step=train_s / max(len(history), 1),
            energies=[row["energy"] for row in history])
        print(f"r={r:.3f}  HF {mol.hf_energy:.5f}  FCI {mol.fci_energy:.5f}"
              f"  VMC {best['energy']:.5f} (iter {best['iter']})"
              f"  gap {(best['energy'] - mol.fci_energy) * 1000:+.2f} mHa"
              f"  within 1.6 mHa at {hit.get('iter')}"
              f"  {train_s / max(len(history), 1):.4f} s/step"
              f"  [{time.perf_counter() - t0:.0f}s]", flush=True)
    return results


if __name__ == "__main__":
    main()
