"""Run VMC ground-state optimization for one molecule on one card: the
port's counterpart of the JAX package's ``examples/run_molecule.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.run_molecule \
        [molecule] [iters] [sample_num]

``molecule`` is ``n2`` (default), ``li2o`` or ``c2h4``, the molecule files
packaged with the port, the path of a molecule ``.npz`` (the JAX
package's ``mols/`` cache format, ``chem/molecule.py``), or any other name
of ``chem/geometry_repo.py`` (H2O, LiH, ...), built from atoms at STO-3G
by ``Molecule.create`` and cached in ``mols/``, as JAX's example does. The
example's config: Gumbel sampling of ``sample_num`` (default 2000) unique
determinants, MADE 512, MinSR top 50, Adam 2e-3, seed 0, and the JAX
engine's 'auto' membership (prefilter above 22 qubits). C2H4 trains only
with its HF neighbourhood pinned: use ``experiments.c2h4_transformer``.
Writes ``runs/<name>_torch/result.csv``.
"""

from __future__ import annotations

import os
import sys

from ..chem.molecule import (Molecule, MolConfig, load_c2h4, load_li2o,
                             load_n2)
from ..models.anqs import AnqsConfig
from ..optim.sr import SRConfig
from .vmc import VMC, VMCConfig

PACKAGED = {"n2": load_n2, "li2o": load_li2o, "c2h4": load_c2h4}


def load(name: str, mols_dir: str = "mols", device="cuda") -> Molecule:
    """A packaged molecule by name, a molecule file by path, else the
    molecule of ``geometry_repo`` by name (``Molecule.create``; direct CI
    on ``device``)."""
    if name.lower() in PACKAGED:
        return PACKAGED[name.lower()]()
    if os.path.isfile(name):
        return Molecule.from_npz(name)
    return Molecule.create(MolConfig(name=name, basis="sto-3g"),
                           mols_dir=mols_dir, device=device)


def main(argv=None, device="cuda", run_root="runs", mols_dir="mols"):
    argv = sys.argv if argv is None else argv
    name = argv[1] if len(argv) > 1 else "n2"
    iters = int(argv[2]) if len(argv) > 2 else 500
    sample_num = int(argv[3]) if len(argv) > 3 else 2000

    mol = load(name, mols_dir, device)
    print(f"{mol.name}: HF {mol.hf_energy:.6f}  FCI {mol.fci_energy}  "
          f"qubits {mol.qubit_num}")
    vmc = VMC(
        mol,
        VMCConfig(sample_num=sample_num, sampling_mode="gumbel",
                  sr=SRConfig(max_indices_num=50), lr=2e-3),
        AnqsConfig(hidden_widths=(512,), aux_hidden_widths=(512,)),
        device=device,
        run_dir=os.path.join(run_root, f"{mol.name.lower()}_torch"),
    )
    ref = mol.fci_energy

    def progress(it, row):
        if it % 25 == 0:
            gap = f"  gap {row['energy'] - ref:+.2e}" if ref else ""
            print(f"iter {it:5d}  E {row['energy']:+.6f}{gap}  "
                  f"unique {int(row['unique_num'])}  "
                  f"var {row['energy_var']:.2e}", flush=True)

    _, _, best = vmc.run(iter_num=iters, on_iter=progress)
    print(f"best energy {best['energy']:.6f} at iter {best['iter']}")
    if ref:
        gap = best["energy"] - ref
        print(f"gap to reference {gap * 1000:.3f} mHa "
              f"({'CHEMICAL ACCURACY' if gap < 1.6e-3 else 'not yet'})")
    return best


if __name__ == "__main__":
    main()
