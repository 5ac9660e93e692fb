"""CISD-pretrained ANQS VMC on one card, the port's counterpart of the JAX
package's ``examples/cisd_pretrain_vmc.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.cisd_pretrain_vmc \
        [molecule] [iters] [sample_num] [net] [qpq] [theor] [grad_temp]

``molecule`` 'li2o' (default) or 'n2', the port's packaged files;
``iters`` VMC iterations (default 4000), ``sample_num`` Gumbel samples
(8192), ``net`` 'nade' (default; hidden widths (128, 128)) or 'made'
(2048 hidden, a 512-wide phase net) -- 'transformer' raises until its
``matmul_precision`` is ported --, ``qpq`` qubits a qudit (6), ``theor``
1 for Born weights or 0 for the sampler's own (1), ``grad_temp`` the
gradient weights' temperature (2). The defaults are the Li2O NADE
campaign's first leg (JAX run ``runs/li2o_cisd_nade_t2``).

Builds the CISD vector from the HF determinant (``chem.fci.
cisd_ground_state``), pretrains the ansatz on it in the example's three
stages ((2500, 1e-3), (2500, 3e-4), (2000, 1e-4); batch min(8192, N),
``optim.pretrain``), saves it as ``ckpt_0`` of the run directory
``runs/<molecule>_cisd_<net>[_emp][_t<grad_temp>]_torch``, then runs
``VMC.run`` at the example's settings: Adam 3e-4 (1e-4 from 1500, 3e-5 from
3000), clip 0.5, MinSR top 50, prefilter capacities (768, 4096), the full
energy every 500 iterations (when sample_num x groups < 2^27), windows of
25, checkpoints every 250. A run directory that holds checkpoints resumes
from the newest and skips the pretraining.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..chem.fci import cisd_ground_state
from ..chem.molecule import load_li2o, load_n2
from ..models.anqs import AnqsConfig
from ..optim.pretrain import amplitude_targets_from_coefs, pack_dets, pretrain
from .vmc import (
    CISD_VMC_CONFIG,
    LI2O_FCI_ENERGY,
    LI2O_NADE,
    VMC,
    VMCConfig,
    latest_checkpoint,
)

MOLECULES = {"li2o": load_li2o, "n2": load_n2}
# JAX's example passes only ``hidden_widths`` for MADE, so its phase net
# keeps the (512,) default.
NETS = {"nade": LI2O_NADE, "made": AnqsConfig(hidden_widths=(2048,))}
# The example's pretraining stages: (steps, learning rate).
PRETRAIN_STAGES = ((2500, 1e-3), (2500, 3e-4), (2000, 1e-4))


def main(argv=None, device="cuda", run_root="runs",
         stages=PRETRAIN_STAGES):
    argv = sys.argv if argv is None else argv
    name = argv[1].lower() if len(argv) > 1 else "li2o"
    iters = int(argv[2]) if len(argv) > 2 else 4000
    sample_num = int(argv[3]) if len(argv) > 3 else 8192
    net = argv[4] if len(argv) > 4 else "nade"
    qpq = int(argv[5]) if len(argv) > 5 else 6
    theor = bool(int(argv[6])) if len(argv) > 6 else True
    grad_temp = float(argv[7]) if len(argv) > 7 else 2.0
    if net == "transformer":
        raise NotImplementedError(
            "net='transformer' needs AnqsConfig.matmul_precision, which is "
            "not ported (ROADMAP §1 'Next slices' item 1)")

    mol = MOLECULES[name]()
    hf = mol.hf_energy
    ref = mol.fci_energy if mol.fci_energy is not None else LI2O_FCI_ENERGY
    print(f"{mol.name}: {mol.qubit_num} qubits, HF {hf:.6f}, reference "
          f"{ref:.6f}", flush=True)

    t0 = time.perf_counter()
    e_cisd, dets, coef = cisd_ground_state(mol.qubit_ham, mol.hf_det)
    print(f"CISD: {len(dets)} dets, E {e_cisd:.6f} "
          f"({100 * (e_cisd - hf) / (ref - hf):.1f}% of corr) "
          f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    probs, phases = amplitude_targets_from_coefs(coef)
    words = pack_dets(dets, mol.qubit_num)

    run_dir = os.path.join(run_root, f"{name}_cisd_{net}" + (
        "" if theor else "_emp") + (
        "" if grad_temp == 1.0 else f"_t{grad_temp:g}") + "_torch")
    vmc = VMC(
        mol,
        VMCConfig(**{
            **CISD_VMC_CONFIG, "sample_num": sample_num,
            "qubit_per_qudit": qpq, "iter_num": iters,
            "full_energy_period": (
                500 if sample_num * mol.qubit_ham.n_groups < (1 << 27)
                else None),
            "use_theor_freqs": theor, "grad_weight_temperature": grad_temp,
        }),
        NETS[net], device=device, run_dir=run_dir,
    )

    resume = latest_checkpoint(run_dir)
    if resume:
        print(f"resuming from {resume} (skipping pretrain)", flush=True)
    else:
        state = vmc.init_state()
        t0 = time.perf_counter()

        def plog(row):
            print(f"  pretrain {row['iter']:5d} loss {row['loss']:.5f} "
                  f"ce {row['cross_entropy']:.5f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

        batch = min(8192, words.shape[0])
        for stage_iters, lr in stages:
            pretrain(vmc.anqs, words, probs, phases,
                     torch.Generator(device=vmc.device).manual_seed(0),
                     iters=stage_iters, lr=lr, batch=batch, on_log=plog)
        resume = os.path.join(run_dir, "ckpt_0")
        vmc.save_checkpoint(resume, state, 0)

    t0 = time.perf_counter()

    def progress(it, row):
        if it % 50 == 0 or np.isfinite(row["full_energy"]):
            corr = (row["energy"] - hf) / (ref - hf)
            print(f"iter {it:6d} E {row['energy']:+.6f} "
                  f"corr {100 * corr:5.1f}% "
                  f"full {row['full_energy']:+.6f} "
                  f"unique {int(row['unique_num'])} "
                  f"found {int(row['found_pairs'])} "
                  f"pf_dropped {int(row['pf_dropped_rows'])} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=250, steps_per_call=25,
                               resume_from=resume)
    corr = (best["energy"] - hf) / (ref - hf)
    print(f"best {best['energy']:.6f} at {best['iter']} "
          f"({100 * corr:.1f}% of the reference's correlation; CISD "
          f"{100 * (e_cisd - hf) / (ref - hf):.1f}%)", flush=True)
    return history, best


if __name__ == "__main__":
    main()
