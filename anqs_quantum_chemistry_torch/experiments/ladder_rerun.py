"""Re-run a ladder molecule with checkpoints and the inline unbiased full
energy, on one card: the port's counterpart of the JAX package's
``examples/ladder_rerun.py`` (its records: ``runs/beh2``, ``runs/h2o``).

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.ladder_rerun \
        <molecule> [iters] [run_dir] [sample_num] [lr]

``molecule`` is any name of ``chem/geometry_repo.py`` (H2O, BeH2, ...),
built from atoms by ``Molecule.create`` (cached in ``mols/``). The
example's recipe: Gumbel top-k of ``sample_num`` (default 2048) unique
determinants, qubit_per_qudit 6, Adam ``lr`` (default 5e-4), MinSR top 50,
the full energy every 250 iterations, seed 0, MADE 512, windows of 25
steps, a checkpoint every 1000 iterations. It resumes from the newest
``ckpt_*`` of ``run_dir`` (default ``runs/<name>_r3``) and writes
``result.csv`` there.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..chem.molecule import Molecule, MolConfig
from ..models.anqs import AnqsConfig
from ..optim.sr import SRConfig
from .vmc import VMC, VMCConfig, latest_checkpoint


def main(argv=None, device="cuda", mols_dir="mols"):
    argv = sys.argv if argv is None else argv
    name = argv[1]
    iters = int(argv[2]) if len(argv) > 2 else 16000
    run_dir = argv[3] if len(argv) > 3 else f"runs/{name.lower()}_r3"
    sample_num = int(argv[4]) if len(argv) > 4 else 2048
    lr = float(argv[5]) if len(argv) > 5 else 5e-4

    mol = Molecule.create(MolConfig(name=name), mols_dir=mols_dir,
                          device=device)
    fci = mol.fci_energy
    print(f"{name}: {mol.qubit_num}q HF {mol.hf_energy:.6f} FCI {fci}",
          flush=True)
    vmc = VMC(
        mol,
        VMCConfig(sample_num=sample_num, sampling_mode="gumbel",
                  qubit_per_qudit=6, lr=lr, sr=SRConfig(max_indices_num=50),
                  full_energy_period=250, seed=0, iter_num=iters),
        AnqsConfig(hidden_widths=(512,)),
        device=device,
        run_dir=run_dir,
    )
    resume = latest_checkpoint(run_dir)
    if resume:
        print(f"resuming from {resume}", flush=True)
    t0 = time.perf_counter()

    def progress(it, row):
        if it % 250 == 0 or np.isfinite(row.get("full_energy", np.nan)):
            gap = (row["energy"] - fci) * 1e3 if fci else float("nan")
            print(f"iter {it:6d} E {row['energy']:+.6f} "
                  f"gap {gap:+.3f} mHa "
                  f"full {row.get('full_energy', float('nan')):+.6f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, _, best = vmc.run(iter_num=iters, on_iter=progress,
                         checkpoint_every=1000, steps_per_call=25,
                         resume_from=resume)
    print(f"best {best['energy']:.6f} at {best['iter']}")
    if fci:
        print(f"gap to FCI {(best['energy'] - fci) * 1e3:+.3f} mHa")
    return best


if __name__ == "__main__":
    main()
