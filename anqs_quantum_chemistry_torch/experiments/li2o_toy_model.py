"""Li2O/STO-3G, the reference's documented toy model at 30 qubits: the
port's counterpart of the JAX package's ``examples/li2o_toy_model.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.li2o_toy_model \
        [iters] [sample_num] [run_dir]

The JAX example's configuration: Li2O from the packaged
``data/li2o_sto3g.npz``, 8192 Gumbel samples, qubit_per_qudit 6, MADE 512,
Adam 3e-3 with the schedule ((0, 3e-3), (1200, 1e-3), (2400, 3e-4)), clip
1.0, MinSR top 50, seed 0, windows of 25 steps, and the engine's 'auto'
membership, which is prefilter at 30 qubits (the 41.4M-determinant sector
is far beyond sector membership). Writes ``run_dir/result.csv`` (default
``runs/li2o_torch``; 500 iterations by default), prints a progress line
every 50 iterations, then the best energy and the steady-state seconds per
iteration from the end of the first window on (the kernel builds and
warm-up excluded), as the JAX example does.
"""

from __future__ import annotations

import sys
import time

from ..chem.molecule import load_li2o
from ..models.anqs import AnqsConfig
from ..optim.sr import SRConfig
from .vmc import VMC, VMCConfig

LR_SCHEDULE = ((0, 3e-3), (1200, 1e-3), (2400, 3e-4))
STEPS_PER_CALL = 25


def li2o_toy_config(sample_num: int = 8192) -> VMCConfig:
    """The JAX example's ``VMCConfig``."""
    return VMCConfig(sample_num=sample_num, sampling_mode="gumbel",
                     qubit_per_qudit=6, lr=3e-3, lr_schedule=LR_SCHEDULE,
                     grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
                     seed=0)


def main(argv=None, device="cuda"):
    argv = sys.argv if argv is None else argv
    iters = int(argv[1]) if len(argv) > 1 else 500
    sample_num = int(argv[2]) if len(argv) > 2 else 8192
    run_dir = argv[3] if len(argv) > 3 else "runs/li2o_torch"

    mol = load_li2o()
    ref = mol.ccsd_t_energy or mol.cisd_energy or mol.hf_energy
    print(f"Li2O: {mol.qubit_num} qubits, ndet {mol.fci_ndet:,}; "
          f"HF {mol.hf_energy:.6f} CISD {mol.cisd_energy} "
          f"CCSD(T) {mol.ccsd_t_energy}", flush=True)
    vmc = VMC(mol, li2o_toy_config(sample_num),
              AnqsConfig(hidden_widths=(512,)), device=device,
              run_dir=run_dir)
    print(f"membership: {vmc.engine.membership}", flush=True)

    t0 = time.perf_counter()
    steady = {}  # the end of the first window: build and warm-up excluded

    def progress(it, row):
        if it >= STEPS_PER_CALL and not steady:
            steady.update(t=time.perf_counter(), it=it)
        if it % 50 == 0:
            print(f"iter {it:5d} E {row['energy']:+.6f} "
                  f"gap-to-ref {row['energy'] - ref:+.3e} "
                  f"unique {int(row['unique_num'])} "
                  f"found {int(row['found_pairs'])} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=None,
                               steps_per_call=STEPS_PER_CALL)
    per_iter = ((time.perf_counter() - steady["t"])
                / max(1, len(history) - steady["it"] - 1)
                if steady else float("nan"))
    print(f"best {best['energy']:.6f} at iter {best['iter']} "
          f"({per_iter:.3f} s/iter steady-state, build/warm-up excluded)")
    return best, per_iter


if __name__ == "__main__":
    main()
