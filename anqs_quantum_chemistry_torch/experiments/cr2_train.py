"""Cr2/SV (84 qubits): the training leg of the JAX package's
``examples/cr2_train.py`` on one card.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.cr2_train \
        [sample_num] [steps]

The example's trainer (``experiments.vmc.cr2_vmc``: MADE 1024 with
logit_cap 8, qubit_per_qudit 6, ``sample_num`` Gumbel samples (default
1024) and the 64 pinned HF neighbours, prefilter membership, MinSR top 50,
clip 1.0, Adam 1e-3) from random weights (seed 0), through ``VMC.run`` for
``steps`` iterations (default 1000) with a checkpoint every 100, into
``runs/cr2_train_torch/`` (``result.csv`` under the JAX package's header);
it resumes from the newest ``ckpt_*`` there. Prints a progress line every
25 iterations and on every energy below HF, and writes the example's
summary (``best_energy``, ``best_iter``, ``tail50_mean_energy``,
``below_hf``, ``corr_captured_mha_vs_hf``) to ``summary.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from .vmc import cr2_vmc, latest_checkpoint

RUN_DIR = "runs/cr2_train_torch"


def main(argv=None, device="cuda", run_dir=RUN_DIR):
    argv = sys.argv if argv is None else argv
    sample_num = int(argv[1]) if len(argv) > 1 else 1024
    steps = int(argv[2]) if len(argv) > 2 else 1000

    t0 = time.perf_counter()
    vmc = cr2_vmc(device=device, sample_num=sample_num, iter_num=steps,
                  run_dir=run_dir)
    mol = vmc.mol
    hf = mol.hf_energy
    print(f"Cr2/SV: {mol.qubit_num}q T={vmc.ham.n_terms} "
          f"M={vmc.ham.n_groups} HF {hf:.6f}; membership "
          f"{vmc.engine.membership} [{time.perf_counter() - t0:.1f}s]",
          flush=True)
    resume = latest_checkpoint(run_dir)
    if resume:
        print(f"resuming from {resume}", flush=True)
    last = {"it": -1, "t": time.perf_counter()}

    def on_iter(it, row):
        if it % 25 == 0 or row["energy"] < hf:
            now = time.perf_counter()
            rate = (now - last["t"]) / max(1, it - last["it"])
            last.update({"it": it, "t": now})
            print(f"iter {it}: E={row['energy']:.6f} "
                  f"unique={int(row['unique_num'])} "
                  f"found_pairs={int(row['found_pairs'])} "
                  f"pf_dropped_rows={int(row['pf_dropped_rows'])} "
                  f"[{rate:.3f} s/iter]", flush=True)

    _, history, best = vmc.run(iter_num=steps, checkpoint_every=100,
                               resume_from=resume, on_iter=on_iter)
    energies = np.array([r["energy"] for r in history])
    summary = {
        "molecule": "Cr2/SV",
        "qubits": mol.qubit_num,
        "sample_num": sample_num,
        "steps_run": len(history),
        "hf_energy": hf,
        "best_energy": float(best["energy"]),
        "best_iter": int(best["iter"]),
        "tail50_mean_energy": (float(np.mean(energies[-50:]))
                               if len(energies) >= 50 else None),
        "below_hf": bool(best["energy"] < hf),
        "corr_captured_mha_vs_hf": float((hf - best["energy"]) * 1e3),
        "overflow_escalations": vmc._overflow_escalations,
    }
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
