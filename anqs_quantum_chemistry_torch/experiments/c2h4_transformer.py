"""C2H4/6-31G (52 qubits): the transformer ANQS trainer on one card, the
port's counterpart of the JAX package's ``examples/c2h4_transformer.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.c2h4_transformer \
        [iters] [sample_num] [net]

``iters`` (default 3000), ``sample_num`` Gumbel samples (default 4096) and
``net`` 'transformer' (default) or 'made', each with the example's
learning-rate schedule and gradient clip (``experiments.vmc.c2h4_vmc``):
13 qudit tokens, the 2048 pinned HF neighbours, prefilter membership,
MinSR top 50. Runs ``VMC.run`` in windows of 25 steps with checkpoints
every 1000, writes ``runs/c2h4_<net>_torch/`` (``result.csv`` under the
JAX package's header) and prints the example's progress line every 50
iterations. The molecule file has no FCI energy; the reference is the
example's CCSD(T).
"""

from __future__ import annotations

import os
import sys
import time

from .vmc import c2h4_vmc

# The JAX example's CCSD(T) energy of C2H4/6-31G (this repo's chemistry
# stack), the reference of the progress line.
CCSD_T_ENERGY = -78.219007


def main(argv=None, device="cuda", run_root="runs"):
    argv = sys.argv if argv is None else argv
    iters = int(argv[1]) if len(argv) > 1 else 3000
    sample_num = int(argv[2]) if len(argv) > 2 else 4096
    net = argv[3] if len(argv) > 3 else "transformer"

    vmc = c2h4_vmc(device=device, net=net, sample_num=sample_num,
                   run_dir=os.path.join(run_root, f"c2h4_{net}_torch"))
    mol = vmc.mol
    hf, ref = mol.hf_energy, CCSD_T_ENERGY
    print(f"C2H4/6-31G: {mol.qubit_num} qubits, M={vmc.ham.n_groups}; "
          f"HF {hf:.6f} CCSD(T) {ref:.6f}; net {net}, membership "
          f"{vmc.engine.membership}", flush=True)
    t0 = time.perf_counter()

    def progress(it, row):
        if it % 50 == 0:
            print(f"iter {it:5d} E {row['energy']:+.6f} "
                  f"corr {(row['energy'] - hf) * 1e3:+.1f} mHa "
                  f"gap-to-CCSD(T) {(row['energy'] - ref) * 1e3:+.1f} mHa "
                  f"found {int(row['found_pairs'])} ipr {row['ipr']:.3f} "
                  f"pf_dropped {int(row['pf_dropped_rows'])} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=1000, steps_per_call=25)
    print(f"best {best['energy']:.6f} at iter {best['iter']} (corr "
          f"{(best['energy'] - hf) * 1e3:+.1f} mHa of CCSD(T) "
          f"{(ref - hf) * 1e3:+.1f} mHa); overflow escalations "
          f"{vmc._overflow_escalations}, capacities (row "
          f"{vmc.engine.prefilter_row_capacity}, dense "
          f"{vmc.engine.prefilter_dense_rows})", flush=True)
    return history, best


if __name__ == "__main__":
    main()
