"""CISD-pretrained ANQS VMC on one card, the port's counterpart of the JAX
package's ``examples/cisd_pretrain_vmc.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.cisd_pretrain_vmc \
        [molecule] [iters] [sample_num] [net] [qpq] [theor] [grad_temp] \
        [lr] [steps_per_call]

``molecule`` 'li2o' (default), 'c2h4' or 'n2', the port's packaged files;
``iters`` VMC iterations (default 4000), ``sample_num`` Gumbel samples
(8192), ``net`` 'nade' (default; hidden widths (128, 128)), 'made' (2048
hidden, a 512-wide phase net) or 'transformer' (d_model 128, 8 heads, 3
layers, d_ff 512, ``logit_cap`` 4, matmuls at 'highest'), ``qpq`` qubits a
qudit (6), ``theor`` 1 for Born weights or 0 for the sampler's own (1),
``grad_temp`` the gradient weights' temperature (2), ``lr`` a flat learning
rate in place of the schedule (JAX's ``lr_override``; the run directory
gains ``_lr<lr>``), ``steps_per_call`` the window of steps between host
reads (25). The defaults are the Li2O NADE campaign's first leg (JAX run
``runs/li2o_cisd_nade_t2``); JAX's C2H4 runs are ``c2h4 4000 8192 made 4 1
1`` (``runs/c2h4_cisd_made``) and ``c2h4 3000 8192 transformer 4 0 1 1e-4``
(``runs/c2h4_cisd_transformer_emp_lr0.0001``).

Builds the CISD vector from the HF determinant, from the integrals where
the molecule carries them (Li2O, C2H4) and from the Pauli form otherwise
(N2) (``chem.fci.cisd_ground_state``), and caches it as
``<run_root>/<molecule>_cisd_vector.npz`` (JAX's file and layout), which a
later run reads; pretrains the ansatz on it in the example's three stages
((2500, 1e-3), (2500, 3e-4), (2000, 1e-4); batch min(8192, N),
``optim.pretrain``), saves it as ``ckpt_0`` of the run directory
``runs/<molecule>_cisd_<net>[_emp][_t<grad_temp>][_lr<lr>]_torch``, then
runs ``VMC.run`` at the example's settings: clip 0.5, prefilter capacities
(768, 4096), the full energy every 500 iterations (when sample_num x groups
< 2^27; never at C2H4), windows of ``steps_per_call``, checkpoints every
250; MADE and NADE: MinSR top 50, Adam 3e-4 (1e-4 from 1500, 3e-5 from
3000); the transformer: no SR, Adam 1e-4 (3e-5 from 3000). A run
directory that holds checkpoints resumes from the newest and skips the
pretraining; a run with ``lr`` whose base directory (the same name without
``_t``/``_lr``) has a ``ckpt_0`` starts from a copy of it (JAX's LR-probe
variant) instead of pretraining again.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..chem.fci import cisd_ground_state
from ..chem.molecule import load_c2h4, load_li2o, load_n2
from ..models.anqs import AnqsConfig
from ..optim.pretrain import amplitude_targets_from_coefs, pack_dets, pretrain
from .vmc import (
    CISD_VMC_CONFIG,
    LI2O_FCI_ENERGY,
    LI2O_NADE,
    VMC,
    TrainState,
    VMCConfig,
    latest_checkpoint,
)

MOLECULES = {"li2o": load_li2o, "n2": load_n2, "c2h4": load_c2h4}
# JAX's example passes only ``hidden_widths`` for MADE, so its phase net
# keeps the (512,) default. Its transformer caps the logits (uncapped, it
# collapses onto the HF peak) and pins its matmuls to true float32 (the
# TPU's default bf16 multiply stalls the CISD distillation).
NETS = {
    "nade": LI2O_NADE,
    "made": AnqsConfig(hidden_widths=(2048,)),
    "transformer": AnqsConfig(net_type="transformer", d_model=128,
                              n_heads=8, n_layers=3, d_ff=512, logit_cap=4.0,
                              matmul_precision="highest"),
}
# The example's pretraining stages: (steps, learning rate).
PRETRAIN_STAGES = ((2500, 1e-3), (2500, 3e-4), (2000, 1e-4))
# Learning-rate schedules and SR by net (the transformer: lr 3e-4 or MinSR
# destroy its warm start, JAX's measured H2O A/B).
TRANSFORMER_VMC = dict(lr=1e-4, lr_schedule=((0, 1e-4), (3000, 3e-5)),
                       sr=None)


def cisd_vector(mol, cache: str):
    """(energy, sorted uint64 dets, coef) of ``mol``'s CISD: read from
    ``cache`` when it exists, else solved (from the integrals where ``mol``
    has them) and written there."""
    if os.path.exists(cache):
        with np.load(cache) as d:
            return float(d["e_cisd"]), d["dets"], d["coef"]
    t0 = time.perf_counter()
    if mol.h1 is not None:
        e, dets, coef = cisd_ground_state(mol.h1, mol.v, mol.hf_det,
                                          mol.e_nuc)
    else:
        e, dets, coef = cisd_ground_state(mol.qubit_ham, mol.hf_det)
    print(f"CISD solved in {time.perf_counter() - t0:.1f}s", flush=True)
    os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
    np.savez(cache, dets=dets, coef=coef, e_cisd=e)
    return e, dets, coef


def vmc_config(mol, net: str, sample_num: int, qpq: int, iters: int,
               theor: bool, grad_temp: float, lr=None) -> VMCConfig:
    """The example's ``VMCConfig`` for ``net`` (``lr``: its
    ``lr_override``, a flat rate)."""
    cfg = {**CISD_VMC_CONFIG, "sample_num": sample_num,
           "qubit_per_qudit": qpq, "iter_num": iters,
           "full_energy_period": (
               500 if sample_num * mol.qubit_ham.n_groups < (1 << 27)
               else None),
           "use_theor_freqs": theor, "grad_weight_temperature": grad_temp}
    if net == "transformer":
        cfg.update(TRANSFORMER_VMC)
    if lr is not None:
        cfg.update(lr=lr, lr_schedule=None)
    return VMCConfig(**cfg)


def run_name(name: str, net: str, theor: bool, grad_temp: float,
             lr=None) -> str:
    """The run directory's name (JAX's, with ``_torch``)."""
    return (f"{name}_cisd_{net}" + ("" if theor else "_emp")
            + ("" if grad_temp == 1.0 else f"_t{grad_temp:g}")
            + ("" if lr is None else f"_lr{lr:g}") + "_torch")


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
    lr = float(argv[8]) if len(argv) > 8 else None
    steps_per_call = int(argv[9]) if len(argv) > 9 else 25

    mol = MOLECULES[name]()
    hf = mol.hf_energy
    ref = (mol.fci_energy or mol.ccsd_t_energy
           or (LI2O_FCI_ENERGY if name == "li2o" else None))
    print(f"{mol.name}: {mol.qubit_num} qubits, HF {hf:.6f}, reference "
          f"{ref:.6f}", flush=True)

    e_cisd, dets, coef = cisd_vector(
        mol, os.path.join(run_root, f"{name}_cisd_vector.npz"))
    print(f"CISD: {len(dets)} dets, E {e_cisd:.6f} "
          f"({100 * (e_cisd - hf) / (ref - hf):.1f}% of corr)", flush=True)
    probs, phases = amplitude_targets_from_coefs(coef)
    words = pack_dets(dets, mol.qubit_num)

    run_dir = os.path.join(run_root,
                           run_name(name, net, theor, grad_temp, lr))
    base_dir = os.path.join(run_root, run_name(name, net, theor, 1.0))
    vmc = VMC(mol, vmc_config(mol, net, sample_num, qpq, iters, theor,
                              grad_temp, lr),
              NETS[net], device=device, run_dir=run_dir)

    resume = latest_checkpoint(run_dir)
    if resume:
        print(f"resuming from {resume} (skipping pretrain)", flush=True)
    elif run_dir != base_dir and os.path.isdir(
            os.path.join(base_dir, "ckpt_0")):
        state, _ = vmc.load_checkpoint(os.path.join(base_dir, "ckpt_0"))
        resume = os.path.join(run_dir, "ckpt_0")
        vmc.save_checkpoint(resume, TrainState(opt=vmc._make_opt(),
                                               generator=state.generator), 0)
        print(f"warm start copied from {base_dir}/ckpt_0", flush=True)
    else:
        state = vmc.init_state()
        t0 = time.perf_counter()

        def plog(row):
            print(f"  pretrain {row['iter']:5d} loss {row['loss']:.5f} "
                  f"ce {row['cross_entropy']:.5f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

        batch = min(8192, words.shape[0])
        for stage_iters, stage_lr in stages:
            pretrain(vmc.anqs, words, probs, phases,
                     torch.Generator(device=vmc.device).manual_seed(0),
                     iters=stage_iters, lr=stage_lr, batch=batch,
                     on_log=plog)
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
                               checkpoint_every=250,
                               steps_per_call=steps_per_call,
                               resume_from=resume)
    corr = (best["energy"] - hf) / (ref - hf)
    print(f"best {best['energy']:.6f} at {best['iter']} "
          f"({100 * corr:.1f}% of the reference's correlation; CISD "
          f"{100 * (e_cisd - hf) / (ref - hf):.1f}%)", flush=True)
    return history, best


if __name__ == "__main__":
    main()
