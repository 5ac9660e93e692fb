"""N2/STO-3G to chemical accuracy on one card: the port's counterpart of the
JAX package's ``examples/n2_convergence.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.n2_convergence \
        [iters] [run_dir]

The main path (``vmc.main_path_vmc``: 14464 Gumbel samples covering the
whole 14400-determinant sector every iteration, so the reported energy is
the Rayleigh quotient of the ansatz; MADE 512, qubit_per_qudit 10, MinSR
top 50, clip 1.0, Adam 1e-3, seed 0), with the unbiased full energy every
500 iterations, a checkpoint every 2500 and windows of 25 steps. Writes
``run_dir/result.csv`` (default ``runs/n2_torch``), prints the example's
progress lines and its verdict against E_FCI (-107.652827 Ha, from the
packaged molecule file), and the median seconds per step.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from .vmc import main_path_vmc

CHEMICAL_ACCURACY = 1.6e-3  # Ha


def main(argv=None, device="cuda"):
    argv = sys.argv if argv is None else argv
    iters = int(argv[1]) if len(argv) > 1 else 20000
    run_dir = argv[2] if len(argv) > 2 else "runs/n2_torch"

    vmc = main_path_vmc(device=device, run_dir=run_dir,
                        full_energy_period=500)
    mol = vmc.mol
    print(f"N2: HF {mol.hf_energy:.6f} FCI {mol.fci_energy:.6f} "
          f"ndet {mol.fci_ndet}", flush=True)

    t0 = time.perf_counter()
    state = {"best": 1e9, "hit": None}

    def progress(it, row):
        gap = row["energy"] - mol.fci_energy
        fe = row.get("full_energy", float("nan"))
        if np.isfinite(fe):
            print(f"iter {it:6d} FULL {fe:+.6f} "
                  f"(gap {1e3 * (fe - mol.fci_energy):+.3f} mHa)",
                  flush=True)
        if row["energy"] < state["best"]:
            state["best"] = row["energy"]
            if gap < CHEMICAL_ACCURACY and state["hit"] is None:
                state["hit"] = (it, time.perf_counter() - t0)
                print(f"*** chemical accuracy at iter {it} "
                      f"({state['hit'][1]:.0f}s) ***", flush=True)
        if it % 200 == 0:
            print(f"iter {it:6d} E {row['energy']:+.6f} "
                  f"best-gap {state['best'] - mol.fci_energy:+.2e} "
                  f"unique {int(row['unique_num'])} "
                  f"var {row['energy_var']:.2e} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=2500, steps_per_call=25)
    gap = best["energy"] - mol.fci_energy
    steps = [b["wall_time"] - a["wall_time"]
             for a, b in zip(history, history[1:])
             if not np.isfinite(b["full_energy"])]
    print(f"median step {statistics.median(steps):.4f} s over "
          f"{len(steps)} steps (host clock; full-energy steps excluded)")
    print(f"best {best['energy']:.6f} at iter {best['iter']}; "
          f"gap {gap * 1000:.3f} mHa; "
          f"chemical accuracy: {state['hit']}")
    return best, state["hit"]


if __name__ == "__main__":
    main()
