"""Cr2/SV (84 qubits): the step timing of the JAX package's
``examples/cr2_step.py`` on one card.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.cr2_step \
        [sample_num] [steps]

Loads the packaged Cr2/SV molecule (``data/cr2_sv.npz``: 2,240,694 terms
in 471,774 groups), builds the example's trainer (``experiments.vmc.
cr2_vmc``: MADE 1024 with logit_cap 8, qubit_per_qudit 6, ``sample_num``
Gumbel samples (default 1024) plus the 64 pinned HF neighbours, prefilter
membership in 128-row blocks, MinSR top 50) from random weights (seed 0),
takes a first step and then ``steps`` (default 5) timed ones, and writes
the example's JSON keys to ``runs/cr2_step_torch.json`` (with the card's
name): the median seconds a step, ``found_pairs`` and the energy of the
last step.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..chem.molecule import load_cr2
from .vmc import cr2_vmc


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None, device="cuda", out="runs/cr2_step_torch.json"):
    argv = sys.argv if argv is None else argv
    sample_num = int(argv[1]) if len(argv) > 1 else 1024
    steps = int(argv[2]) if len(argv) > 2 else 5

    t0 = time.perf_counter()
    mol = load_cr2()
    print(f"Cr2/SV loaded: {mol.qubit_num}q T={mol.qubit_ham.n_terms} "
          f"M={mol.qubit_ham.n_groups} HF {mol.hf_energy:.6f} "
          f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    t0 = time.perf_counter()
    vmc = cr2_vmc(device=device, sample_num=sample_num)
    t_build = time.perf_counter() - t0
    print(f"engine built: membership={vmc.engine.membership} "
          f"weights_matmul={vmc.engine.weights_matmul} [{t_build:.1f}s]",
          flush=True)

    state = vmc.init_state()
    t0 = time.perf_counter()
    row = vmc.step(state)
    _sync(device)
    t_first = time.perf_counter() - t0
    print(f"first step: {t_first:.2f}s E={row['energy']:.6f}", flush=True)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        row = vmc.step(state)
        _sync(device)
        times.append(time.perf_counter() - t0)
        print(f"step {i}: {times[-1]:.3f}s E={row['energy']:.6f} "
              f"unique={int(row['unique_num'])} "
              f"found_pairs={int(row['found_pairs'])} "
              f"pf_dropped_rows={int(row['pf_dropped_rows'])}", flush=True)

    result = {
        "molecule": "Cr2/SV",
        "qubits": mol.qubit_num,
        "n_terms": int(mol.qubit_ham.n_terms),
        "n_groups": int(mol.qubit_ham.n_groups),
        "sample_num": sample_num,
        "membership": vmc.engine.membership,
        "weights_matmul": vmc.engine.weights_matmul,
        "sec_per_iter": float(np.median(times)) if times else None,
        "first_step_incl_compile_s": t_first,
        "engine_build_s": t_build,
        "found_pairs_per_iter": int(row["found_pairs"]),
        "energy_last": float(row["energy"]),
        "hf_energy": mol.hf_energy,
        "device": (torch.cuda.get_device_name(0)
                   if torch.device(device).type == "cuda" else "cpu"),
    }
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1), flush=True)
    return result


if __name__ == "__main__":
    main()
