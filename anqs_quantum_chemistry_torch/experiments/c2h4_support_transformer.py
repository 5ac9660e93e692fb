"""The C2H4/6-31G transformer on the support-restricted recipe, on one card:
the port's counterpart of the JAX package's
``examples/c2h4_support_transformer.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.c2h4_support_transformer \
        [cmd] [arg]

The CISD-pretrained transformer (d_model 128, 8 heads, 3 layers, d_ff 512,
``logit_cap`` 4, matmuls at 'highest') reached 75.3% of the CCSD(T)
correlation energy in plain VMC (JAX ``runs/c2h4_cisd_transformer_emp_
lr0.0001``). This gives it the recipe that took the MADE-2048 to 85.9%
(``c2h4_support_ci``), on the same 262,144-determinant target and its
cached restricted H (``runs/c2h4_sci_torch/h_support.npz``, written by
``c2h4_support_ci build_h``). Commands:

- ``measure`` (default): the sampled full energy of the start state.
- ``refit [steps]``: ``rq_refit`` (clip 3, beta 1, Adam 1e-4 and 3e-5, 300
  steps each, mass lam 30), stages 60+.
- ``rq [steps]``: ``support_vmc`` (Adam 1e-3, 5e-4, 3e-4, 600 steps each,
  mass lam 3), stages 20+.
- ``rql [maxiter]``: ``support_vmc_lbfgs`` with the sharp hinge (1200
  evaluations), stages 40+.
- ``confirm``: 5 sampled full energies, ``confirm_energies.npy``.

Each stage is accepted on the sampled full energy of 8192 unique
determinants; ``summary.json`` and ``ckpt_<stage>`` go to
``runs/c2h4_sci_tr_torch``. The start state is the run's best measured
stage whose checkpoint exists, else the packaged JAX state
``data/c2h4_cisd_transformer_ckpt3000.npz``.

Memory of the sampled full energy. ``local_energy_full`` puts every one of
the 20,776 partners of each row through both nets, 65,536 partners at a
time, whatever ``row_chunk`` is: at 13 tokens a partner that is 0.35 GB of
attention logits (8 heads x 13 x 13 float32) and 1.7 GB of d_ff
activations a chunk. ``row_chunk`` (JAX's 128; JAX's TPU put a whole chunk
of rows' partners through at once and crashed) sets only how many rows'
partner words, amplitudes and matrix elements are alive at once, about
0.7 GB a 1024 rows (by arithmetic; ``PERF.md`` has the peak measured on the
card). So JAX's 128 stays the default. The work is about 31 MFLOP a
partner (both nets), 5.3 PFLOP for 8192 rows.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..chem.molecule import DATA_DIR, load_c2h4
from ..convert import load_params_npz
from . import support_ci
from .c2h4_support_ci import (
    C2H4_SCI_TARGET,
    FULL_ENERGY_SAMPLES,
    H_FILE,
    RQL,
    RUN_NAME as SCI_RUN_NAME,
    SCI_VMC_CONFIG,
    Summary,
    correlation,
    load_h,
    peak_memory,
)
from .cisd_pretrain_vmc import NETS
from .li2o_support_ci import load_target
from .vmc import VMC, VMCConfig

RUN_NAME = "c2h4_sci_tr_torch"
# JAX ``runs/c2h4_cisd_transformer_emp_lr0.0001/ckpt_3000``.
WARM_STATE = os.path.join(DATA_DIR, "c2h4_cisd_transformer_ckpt3000.npz")
ROW_CHUNK = 128
REFIT = dict(lrs=(1e-4, 3e-5), steps_per_stage=300, chunk=8192,
             mass_lam=30.0, grad_clip=1000.0, log_every=25,
             objective="rq_refit", refit_clip=3.0, refit_beta=1.0)
RQ = dict(lrs=(1e-3, 5e-4, 3e-4), steps_per_stage=600, chunk=8192,
          mass_lam=3.0, grad_clip=1000.0, log_every=50)
TR_RQL = {**RQL, "maxiter": 1200}
COMMANDS = ("measure", "refit", "rq", "rql", "confirm")


def c2h4_sci_tr_vmc(device="cuda", run_dir=None, **overrides) -> VMC:
    """The 75.3% run's ansatz exactly (``cisd_pretrain_vmc``'s transformer)
    on the closure's trainer settings."""
    return VMC(load_c2h4(), VMCConfig(**{**SCI_VMC_CONFIG, **overrides}),
               NETS["transformer"], device=device, run_dir=run_dir)


def main(argv=None, device="cuda", run_root="runs", *, target=None,
         full_samples: int = FULL_ENERGY_SAMPLES, row_chunk=ROW_CHUNK,
         **overrides):
    """``target``: (dets, coef, e0) in place of the packaged target (the
    restricted H is read from ``c2h4_support_ci``'s run directory);
    ``full_samples``, ``row_chunk``: the full energy's sample and row
    chunk; ``overrides``: other ``VMCConfig`` fields."""
    argv = sys.argv if argv is None else argv
    cmd = argv[1] if len(argv) > 1 else "measure"
    if cmd not in COMMANDS:
        raise ValueError(f"unknown command {cmd!r}: expected one of "
                         f"{COMMANDS}")
    arg = int(argv[2]) if len(argv) > 2 else 0
    run_dir = os.path.join(run_root, RUN_NAME)
    vmc = c2h4_sci_tr_vmc(device, run_dir, **overrides)
    mol = vmc.mol
    corr = correlation(mol)
    print(f"C2H4/6-31g: {mol.qubit_num}q HF {mol.hf_energy:.6f} CISD "
          f"{mol.cisd_energy:.6f} CCSD(T) {mol.ccsd_t_energy:.6f}",
          flush=True)
    td, tc, e_k = target if target is not None else load_target(
        C2H4_SCI_TARGET)
    print(f"target: |S|={len(td)} E0={e_k:.6f} ({corr(e_k):.2f}%)",
          flush=True)
    tgt = support_ci.make_target(td, tc, mol.qubit_num, vmc.device)
    summary = Summary(run_dir, corr, None, {"warm": WARM_STATE,
                                            "stages": []})
    _, src = summary.best_measured()
    if src:
        state, _ = vmc.load_checkpoint(src)
    else:
        state, src = vmc.init_state(), WARM_STATE
        vmc.anqs.load_state_dict(load_params_npz(src))
    print(f"params from {src}", flush=True)

    def measure(tag):
        peak_memory(vmc)  # reset
        t0 = time.perf_counter()
        e, var = support_ci.sampled_full_energy(
            vmc, state.generator, full_samples, row_chunk=row_chunk)
        print(f"  [{tag}] sampled full energy {e:+.6f} ({corr(e):.2f}% "
              f"corr) var {var:.2e} [{time.perf_counter() - t0:.1f}s"
              f"{peak_memory(vmc)}]", flush=True)
        return e

    if cmd == "measure":
        return measure("warm start")
    if cmd == "confirm":
        es = np.array([measure(f"confirm {i}") for i in range(5)])
        np.save(os.path.join(run_dir, "confirm_energies.npy"), es)
        print(f"confirm: mean {es.mean():+.7f} +/- {es.std():.7f} "
              f"({corr(es.mean()):.2f}% corr)", flush=True)
        return es

    h = load_h(os.path.join(run_root, SCI_RUN_NAME, H_FILE))
    base = summary.next_stage(cmd)
    t0 = time.perf_counter()

    def on_log(row):
        extra = (f" loss {row['refit_loss']:.6f}" if "refit_loss" in row
                 else "")
        it = row.get("iter", row.get("eval", 0))
        print(f"  {cmd} stage {row.get('stage', 0)} it {it:4d} rq "
              f"{row['rq']:+.6f} ({corr(row['rq']):.2f}%) mass "
              f"{row['mass']:.6f} best {row['best_rq']:+.6f}{extra} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    def on_stage(row, _params):
        si = base + row["stage"]
        ck = None
        if row.get("accepted", True):
            ck = os.path.join(run_dir, f"ckpt_{si}")
            vmc.save_checkpoint(ck, state, si)
        summary.commit({"stage": si, "optimizer": cmd,
                        "full_e": row["energy"],
                        "corr_pct": corr(row["energy"]),
                        "best_rq": row["best_rq"],
                        "rq_corr_pct": corr(row["best_rq"]),
                        "accepted": row.get("accepted")}, ck)
        print(f"  {cmd} stage {si} accepted={row.get('accepted')} full_e "
              f"{row['energy']:+.6f}", flush=True)

    def accept(_params):
        return measure(f"{cmd} acceptance")

    if cmd == "refit":
        support_ci.support_vmc(
            vmc.anqs, tgt, h, mol.e_nuc,
            **{**REFIT, "steps_per_stage": arg or REFIT["steps_per_stage"]},
            target_coef=tc, on_log=on_log, on_stage=on_stage,
            accept_fn=accept)
    elif cmd == "rq":
        support_ci.support_vmc(
            vmc.anqs, tgt, h, mol.e_nuc,
            **{**RQ, "steps_per_stage": arg or RQ["steps_per_stage"]},
            on_log=on_log, on_stage=on_stage, accept_fn=accept)
    else:
        support_ci.support_vmc_lbfgs(
            vmc.anqs, tgt, h, mol.e_nuc,
            **{**TR_RQL, "maxiter": arg or TR_RQL["maxiter"]},
            on_log=on_log, on_stage=on_stage, accept_fn=accept)
    best = summary.data.get("best_full_e")
    if best is not None:
        print(f"BEST sampled full energy {best:.6f} = {corr(best):.2f}% of "
              f"CCSD(T) correlation", flush=True)
    return summary.data


if __name__ == "__main__":
    main()
