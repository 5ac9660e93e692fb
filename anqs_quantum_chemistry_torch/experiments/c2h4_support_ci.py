"""The C2H4/6-31G (52 qubits) support-CI closure on one card: the port's
counterpart of the JAX package's ``examples/c2h4_support_ci.py`` and
``tools/build_c2h4_support_h.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.c2h4_support_ci \
        [cmd] [args]

The CISD-pretrained MADE-2048 stops at ~74% of the CCSD(T) correlation
energy (JAX ``runs/c2h4_cisd_made``): what it misses lives in determinants
its sampler never proposes. The closure fits it to a selected-CI vector over
them (``support_ci``), then minimises the energy restricted to that support.
Commands (default ``all`` = ``distill`` then ``polish``):

- ``target``: heat-bath selected CI on the host from the CISD vector
  (``ROUNDS``: (eps, parents, size cap), stopping when a round gains less
  than 0.3 mHa), then the smallest power-of-two truncation within 0.3 mHa,
  written to the run directory's ``target.npz`` (JAX: 2926 s + 5472 s of
  diagonalisation on its host).
- ``distill``: 4 stages of 6000 minibatched cross-entropy steps (batch 8192,
  Adam 3e-4, 1e-4, 3e-5, 1e-5), checkpoints ``ckpt_1``-``ckpt_4``.
- ``polish``: ``support_ci.polish`` (linear mass penalty, temperature 4, lam
  30, Adam 1e-4 ... 3e-6, 2000 full-support steps in slices of 8192),
  stages 10-13.
- ``build_h``: H restricted to the target's determinants from the
  integrals, on the host with the C++ builder, cached as ``h_support.npz``
  (JAX's record: nnz 72,588,964, ~1058 s with its eigsh); its ground state
  is checked against the target's E0.
- ``rq [objective]``: ``support_vmc`` on the exact restricted quotient (Adam
  1e-3, 5e-4, 3e-4, 1.5e-4, 900 steps each, mass lam 3), stages 20+.
- ``rql [maxiter]``: ``support_vmc_lbfgs`` with the sharp hinge (lam 30,
  width 1e-5, slack 3e-5; 2400 evaluations), stages 40+.
- ``refit [steps]``: ``rq_refit`` (beta 0.05, clip 1.0, lr 3e-5, 600 steps,
  mass lam 30), stages 60+.
- ``repair [r_steps] [q_steps]``: an unguarded ``rq_refit`` wave selected
  by its refit loss, then an ``rq`` wave (3e-4, 1e-4) guarded against the
  incumbent's energy, stages 70+.
- ``confirm``: 5 sampled full energies of the best measured stage,
  ``confirm_energies.npy``.

Every stage ends with the sampled full energy of 8192 unique determinants
(in row chunks of 1024) and a row in ``summary.json`` (JAX's keys); the
refit knobs that JAX reads from ``ANQS_REFIT_*`` come in as ``main``'s
arguments, with JAX's defaults. The run directory is
``runs/c2h4_sci_torch``. ``distill``/``polish`` start from its newest
checkpoint, else the packaged JAX warm start (``data/
c2h4_cisd_made_ckpt4000.npz``); ``rq``/``rql``/``refit``/``repair`` and
``confirm`` from its best measured stage whose checkpoint exists (never
from the newest), else the packaged JAX state of the best stage,
``data/c2h4_sci_ckpt47.npz`` (L-BFGS; the TPU confirmed -78.1886096 Ha).
The target is the run's own ``target.npz``, else the JAX package's
(``data/c2h4_sci_target.npz``: 262,144 determinants, E0 -78.2159466927);
the CISD vector ``runs/c2h4_cisd_vector.npz`` where ``cisd_pretrain_vmc``
wrote it, else the JAX package's (``data/c2h4_cisd_vector.npz``). The
Adam-family commands and ``confirm`` run the nets at 'highest' as JAX's
do; on the port that is float32, which is also its default.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from ..chem import fci as fci_mod
from ..chem import selected_ci as sci
from ..chem.molecule import DATA_DIR, load_c2h4
from ..convert import load_params_npz
from ..models.anqs import AnqsConfig
from . import support_ci
from .li2o_support_ci import load_target
from .vmc import LI2O_PREFILTER, VMC, VMCConfig, latest_checkpoint

RUN_NAME = "c2h4_sci_torch"
C2H4_SCI_TARGET = os.path.join(DATA_DIR, "c2h4_sci_target.npz")
C2H4_CISD_VECTOR = os.path.join(DATA_DIR, "c2h4_cisd_vector.npz")
# The packaged JAX states: the CISD-pretrained MADE-2048 after 4000 VMC
# iterations (``runs/c2h4_cisd_made/ckpt_4000``) and the closure's best
# stage (``runs/c2h4_sci/ckpt_47``).
WARM_STATE = os.path.join(DATA_DIR, "c2h4_cisd_made_ckpt4000.npz")
BEST_STATE = os.path.join(DATA_DIR, "c2h4_sci_ckpt47.npz")
H_FILE = "h_support.npz"
# Heat-bath selected-CI rounds: (eps, n_parents, max_total_size).
ROUNDS = ((3e-4, 4000, 400_000), (1.5e-4, 20000, 700_000))
ROUND_TOL = 3e-4  # Ha: stop when a round gains less than this
TRUNC_SIZES = (1 << 17, 1 << 18, 1 << 19)
SCI_VMC_CONFIG = dict(sample_num=8192, sampling_mode="gumbel",
                      qubit_per_qudit=4, seed=0,
                      engine_overrides=LI2O_PREFILTER)
C2H4_MADE = AnqsConfig(hidden_widths=(2048,))
FULL_ENERGY_SAMPLES = 8192
ROW_CHUNK = 1024
DISTILL_STAGES = ((6000, 3e-4), (6000, 1e-4), (6000, 3e-5), (6000, 1e-5))
POLISH = dict(temp=4.0, lam=30.0, kind="lin", lrs=(1e-4, 3e-5, 1e-5, 3e-6),
              steps=2000, chunk=8192)
RQ = dict(lrs=(1e-3, 5e-4, 3e-4, 1.5e-4), steps_per_stage=900, chunk=8192,
          mass_lam=3.0, grad_clip=1000.0, log_every=50)
RQL = dict(maxiter=2400, segment=200, chunk=8192, mass_lam=30.0,
           mass_width=1e-5, mass_slack=3e-5, log_every=25)
REFIT = dict(steps_per_stage=600, chunk=8192, mass_lam=30.0,
             grad_clip=1000.0, log_every=25, objective="rq_refit")
REPAIR_RQ = dict(lrs=(3e-4, 1e-4), chunk=8192, mass_lam=3.0,
                 grad_clip=1000.0, log_every=25)
# First stage number of each command's rows in ``summary.json``.
STAGE_BASE = {"distill": 0, "polish": 10, "rq": 20, "rql": 40, "refit": 60,
              "repair": 70}
HIGHEST_CMDS = ("rq", "rql", "refit", "repair", "confirm")
COMMANDS = ("all", "target", "distill", "polish", "build_h", "rq", "rql",
            "refit", "repair", "confirm")


def c2h4_sci_vmc(device="cuda", run_dir=None, precision=None,
                 **overrides) -> VMC:
    """The closure's trainer (JAX ``make_vmc``): C2H4/6-31G, MADE-2048 (a
    512-wide phase net) at ``precision``, 8192 Gumbel samples, qubit_per_
    qudit 4, seed 0, prefilter capacities (768, 4096)."""
    return VMC(load_c2h4(), VMCConfig(**{**SCI_VMC_CONFIG, **overrides}),
               dataclasses.replace(C2H4_MADE, matmul_precision=precision),
               device=device, run_dir=run_dir)


def correlation(mol):
    """e -> % of the CCSD(T) correlation energy (the examples' measure)."""
    hf, ref = mol.hf_energy, mol.ccsd_t_energy
    return lambda e: 100.0 * (e - hf) / (ref - hf)


def build_target(mol, seed_dets, rounds=ROUNDS,
                 sizes=TRUNC_SIZES, out: Optional[str] = None):
    """Host phase (JAX ``build_target``): the seed's restricted ground
    state, heat-bath selected-CI ``rounds`` until one gains less than
    ``ROUND_TOL``, then the smallest of ``sizes`` whose truncation stays
    within 0.3 mHa of the expansion, written to ``out``. Returns (dets,
    coef, e0)."""
    corr = correlation(mol)
    t0 = time.perf_counter()
    table = sci.HeatBathTable(mol.h1, mol.v)
    print(f"heat-bath table [{time.perf_counter() - t0:.0f}s]", flush=True)
    dets = sorted(set(int(d) for d in seed_dets))
    t0 = time.perf_counter()
    energy, coef = sci.restricted_ground_state(dets, mol.h1, mol.v,
                                               mol.e_nuc)
    print(f"seed: |S|={len(dets)} E0={energy:.6f} ({corr(energy):.1f}% "
          f"corr) [{time.perf_counter() - t0:.0f}s]", flush=True)
    for rnd, (eps, n_par, cap) in enumerate(rounds):
        t0 = time.perf_counter()
        bigger = sci.expand_support_heatbath(dets, coef, table, eps, n_par,
                                             max_new=max(0, cap - len(dets)))
        if len(bigger) == len(dets):
            print(f"round {rnd}: no new dets", flush=True)
            break
        t1 = time.perf_counter()
        e_new, c_new = sci.restricted_ground_state(bigger, mol.h1, mol.v,
                                                   mol.e_nuc)
        print(f"round {rnd} (eps={eps:g} parents={n_par}): |S|={len(bigger)}"
              f" E0={e_new:.6f} ({corr(e_new):.1f}% corr) gain "
              f"{(energy - e_new) * 1e3:.3f} mHa [expand {t1 - t0:.0f}s "
              f"diag {time.perf_counter() - t1:.0f}s]", flush=True)
        gained = energy - e_new
        dets, coef, energy = bigger, c_new, e_new
        if gained < ROUND_TOL:
            break
    e_full, n_full = energy, len(dets)
    for k in sizes:
        if k >= len(dets):
            td, tc, e_k = dets, np.asarray(coef, np.float64), e_full
            break
        td, tc = sci.truncate_by_weight(dets, coef, k)
        t0 = time.perf_counter()
        e_k, tc = sci.restricted_ground_state(td, mol.h1, mol.v, mol.e_nuc)
        print(f"top-{k}: E0={e_k:.6f} ({corr(e_k):.1f}% corr) "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
        if e_k - e_full < 3e-4:
            break
    if out:
        np.savez_compressed(out, dets=np.array(td, np.uint64), coef=tc,
                            e0=e_k, e0_full=e_full, n_full=n_full)
    print(f"target: |S|={len(td)} E0={e_k:.6f} ({corr(e_k):.1f}% corr; "
          f"full expansion {n_full} dets at {corr(e_full):.1f}%)",
          flush=True)
    return td, tc, e_k


def build_h(mol, dets, e0: float, path: str):
    """The restricted H over ``dets`` (rows in their order; the C++ builder
    takes an ascending list) from the integrals, written
    to ``path`` unless it exists; its ground state is checked against
    ``e0`` (raises beyond 1e-6 Ha). Returns the CSR."""
    if os.path.exists(path):
        print(f"already cached: {path}", flush=True)
        return scipy.sparse.load_npz(path)
    print(f"building restricted H: |S|={len(dets)} n_so={mol.h1.shape[0]}",
          flush=True)
    t0 = time.perf_counter()
    h = fci_mod.sparse_hamiltonian(dets, mol.h1, mol.v)
    print(f"built in {time.perf_counter() - t0:.0f}s nnz={h.nnz}",
          flush=True)
    t0 = time.perf_counter()
    e = float(scipy.sparse.linalg.eigsh(h, k=1, which="SA",
                                        return_eigenvectors=False)[0])
    e += mol.e_nuc
    print(f"restricted E0 = {e:.10f} (target {e0:.10f}, "
          f"{(e - e0) * 1e3:+.2e} mHa) [{time.perf_counter() - t0:.0f}s]",
          flush=True)
    if abs(e - e0) > 1e-6:
        raise ValueError(f"restricted E0 {e} is not the target's {e0}")
    scipy.sparse.save_npz(path, h)
    print(f"saved {path}", flush=True)
    return h


def peak_memory(vmc) -> str:
    """", peak <GB>" of the card's memory since the last call (reset for
    the next), or "" on the CPU."""
    if vmc.device.type != "cuda":
        return ""
    peak = torch.cuda.max_memory_allocated(vmc.device) / 1e9
    torch.cuda.reset_peak_memory_stats(vmc.device)
    return f", peak {peak:.2f} GB"


def load_h(path: str):
    """The cached restricted H, or ``FileNotFoundError`` naming the
    command that builds it."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: build it with `python -m anqs_quantum_"
            f"chemistry_torch.experiments.c2h4_support_ci build_h` (host, "
            f"~20 min at 262,144 determinants)")
    h = scipy.sparse.load_npz(path)
    print(f"restricted H loaded: nnz={h.nnz}", flush=True)
    return h


class Summary:
    """``summary.json`` of a run directory: the stage rows (JAX's keys) and
    the best fields, rewritten after each row."""

    def __init__(self, run_dir: str, corr, cisd: float, head: dict):
        self.path = os.path.join(run_dir, "summary.json")
        self.corr, self.cisd = corr, cisd
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.data = json.load(f)
        else:
            self.data = {**head, "stages": []}

    @property
    def stages(self):
        return self.data["stages"]

    def next_stage(self, cmd: str) -> int:
        """The first free stage number of ``cmd``'s wave (a relaunch
        continues the numbering instead of overwriting earlier rows)."""
        base = STAGE_BASE[cmd]
        return base + sum(1 for s in self.stages
                          if base <= s["stage"] < base + 20)

    def best_measured(self):
        """(row, ckpt) of the lowest-energy stage whose checkpoint exists,
        or (None, None)."""
        for row in sorted(self.stages, key=lambda s: s["full_e"]):
            ck = row.get("ckpt")
            if ck and os.path.isdir(ck):
                return row, ck
        return None, None

    def commit(self, row: dict, ck: Optional[str] = None):
        if ck:
            row["ckpt"] = ck
        self.stages.append(row)
        best = min(s["full_e"] for s in self.stages)
        self.data["best_full_e"] = best
        self.data["best_corr_pct"] = self.corr(best)
        if self.cisd is not None:
            self.data["vs_cisd_mha"] = (best - self.cisd) * 1e3
        bc = self.best_measured()[1]
        if bc:
            self.data["best_ckpt"] = bc
        with open(self.path, "w") as f:
            json.dump(self.data, f, indent=1)


def main(argv=None, device="cuda", run_root="runs", *, target=None,
         seed=None, rounds=ROUNDS, sizes=TRUNC_SIZES,
         full_samples: int = FULL_ENERGY_SAMPLES, row_chunk=ROW_CHUNK,
         distill_stages=DISTILL_STAGES, polish_steps: Optional[int] = None,
         rq_steps: Optional[int] = None, refit_beta: float = 0.05,
         refit_clip: float = 1.0, refit_lrs=(3e-5,), repair_lr: float = 3e-5,
         **overrides):
    """``target``: (dets, coef, e0) in place of the run's or the packaged
    target; ``seed``: determinants in place of the CISD vector's; ``rounds``,
    ``sizes``, ``full_samples``, ``row_chunk``, ``distill_stages``,
    ``polish_steps``, ``rq_steps``: the cuts the tests make;
    ``refit_beta``, ``refit_clip``, ``refit_lrs``, ``repair_lr``: JAX's
    ``ANQS_REFIT_BETA``/``_CLIP``/``_LRS``/``_LR``; ``overrides``: other
    ``VMCConfig`` fields."""
    argv = sys.argv if argv is None else argv
    cmd = argv[1] if len(argv) > 1 else "all"
    if cmd not in COMMANDS:
        raise ValueError(f"unknown command {cmd!r}: expected one of "
                         f"{COMMANDS}")
    run_dir = os.path.join(run_root, RUN_NAME)
    os.makedirs(run_dir, exist_ok=True)
    mol = load_c2h4()
    hf, ref, cisd = mol.hf_energy, mol.ccsd_t_energy, mol.cisd_energy
    corr = correlation(mol)
    print(f"C2H4/6-31g: {mol.qubit_num}q HF {hf:.6f} CISD {cisd:.6f} "
          f"CCSD(T) {ref:.6f}", flush=True)

    own_target = os.path.join(run_dir, "target.npz")
    if cmd == "target":
        if seed is None:
            cache = os.path.join(run_root, "c2h4_cisd_vector.npz")
            with np.load(cache if os.path.exists(cache)
                         else C2H4_CISD_VECTOR) as d:
                seed = d["dets"]
        print(f"seed = CISD support ({len(seed)} dets)", flush=True)
        return build_target(mol, seed, rounds, sizes, out=own_target)
    if target is not None:
        td, tc, e_k = target
    else:
        td, tc, e_k = load_target(own_target if os.path.exists(own_target)
                                  else C2H4_SCI_TARGET)
    print(f"target: |S|={len(td)} E0={e_k:.6f} ({corr(e_k):.1f}% corr)",
          flush=True)
    h_path = os.path.join(run_dir, H_FILE)
    if cmd == "build_h":
        return build_h(mol, td, e_k, h_path)

    vmc = c2h4_sci_vmc(device, run_dir, "highest" if cmd in HIGHEST_CMDS
                       else None, **overrides)
    summary = Summary(run_dir, corr, cisd,
                      {"target_e0": e_k, "target_size": len(td),
                       "target_corr_pct": corr(e_k)})
    best_row, src = (summary.best_measured() if cmd in HIGHEST_CMDS
                     else (None, latest_checkpoint(run_dir)))
    if src:
        state, stage = vmc.load_checkpoint(src)
    else:
        state, stage = vmc.init_state(), 0
        src = BEST_STATE if cmd in HIGHEST_CMDS else WARM_STATE
        vmc.anqs.load_state_dict(load_params_npz(src))
    print(f"params from {src} (stage {stage})", flush=True)
    tgt = support_ci.make_target(td, tc, mol.qubit_num, vmc.device)

    def measure(tag):
        peak_memory(vmc)  # reset
        t0 = time.perf_counter()
        e, var = support_ci.sampled_full_energy(
            vmc, state.generator, full_samples, row_chunk=row_chunk)
        print(f"  [{tag}] sampled full energy {e:+.6f} ({corr(e):.2f}% "
              f"corr, {(e - cisd) * 1e3:+.3f} mHa vs CISD) var {var:.2e} "
              f"[{time.perf_counter() - t0:.1f}s{peak_memory(vmc)}]",
              flush=True)
        return e

    t0 = time.perf_counter()

    def on_log(row):
        extra = "".join(f" {k} {row[k]:.6f}" for k in ("refit_loss", "fid")
                        if k in row)
        it = row.get("iter", row.get("eval", 0))
        print(f"  {cmd} stage {row.get('stage', 0)} it {it:5d} "
              f"rq {row['rq']:+.6f} ({corr(row['rq']):.2f}% corr) mass "
              f"{row['mass']:.6f} best {row['best_rq']:+.6f}{extra} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    def save(si):
        ck = os.path.join(run_dir, f"ckpt_{si}")
        vmc.save_checkpoint(ck, state, si)
        return ck

    def stage_recorder(wave: str, **extra):
        """``on_stage`` of an rq-family wave: a checkpoint for an accepted
        stage, a summary row for each."""
        base = summary.next_stage(wave)

        def on_stage(row, _params):
            si = base + row["stage"]
            ck = save(si) if row.get("accepted", True) else None
            out = {"stage": si, "lr": row["lr"], "full_e": row["energy"],
                   "corr_pct": corr(row["energy"]),
                   "best_rq": row["best_rq"],
                   "rq_corr_pct": corr(row["best_rq"]),
                   "accepted": row.get("accepted"), "precision": "highest",
                   **extra}
            if "evals" in row:
                out["evals"] = row["evals"]
            summary.commit(out, ck)
            print(f"  {wave} stage {si} accepted={row.get('accepted')} "
                  f"full_e {row['energy']:+.6f}", flush=True)

        return on_stage

    if cmd in ("all", "distill"):
        if stage == 0:
            measure("warm start")
        for si, (iters, lr) in enumerate(distill_stages):
            if si < stage:
                continue

            def plog(row):
                print(f"  distill {row['iter']:5d} loss {row['loss']:.6f} "
                      f"ce {row['cross_entropy']:.6f} best "
                      f"{row['best_loss']:.6f} "
                      f"[{time.perf_counter() - t0:.0f}s]", flush=True)

            support_ci.distill(
                vmc.anqs, tgt,
                torch.Generator(device=vmc.device).manual_seed(100 + si),
                ((iters, lr),), batch=8192, on_log=plog, log_every=1000)
            e = measure(f"distill stage {si} lr={lr:g}")
            summary.commit({"stage": si, "lr": lr, "full_e": e,
                            "corr_pct": corr(e)}, save(si + 1))

    if cmd in ("all", "polish"):
        def on_polish(row, _params):
            si = STAGE_BASE["polish"] + row["stage"]
            e = measure(f"polish stage {row['stage']} lr={row['lr']:g} "
                        f"mass={row['mass']:.6f}")
            summary.commit({"stage": si, "lr": row["lr"], "full_e": e,
                            "corr_pct": corr(e)}, save(si))

        support_ci.polish(vmc.anqs, tgt, **{
            **POLISH, "steps": polish_steps or POLISH["steps"]},
            on_stage=on_polish)

    if cmd == "rq":
        objective = argv[2] if len(argv) > 2 else "rq"
        support_ci.support_vmc(
            vmc.anqs, tgt, load_h(h_path), mol.e_nuc,
            **{**RQ, "steps_per_stage": rq_steps or RQ["steps_per_stage"]},
            objective=objective, target_coef=tc, on_log=on_log,
            on_stage=stage_recorder("rq"),
            accept_fn=lambda _p: measure("rq acceptance"))

    if cmd == "rql":
        support_ci.support_vmc_lbfgs(
            vmc.anqs, tgt, load_h(h_path), mol.e_nuc,
            **{**RQL, "maxiter": int(argv[2]) if len(argv) > 2
               else RQL["maxiter"]},
            on_log=on_log, on_stage=stage_recorder("rql", optimizer="lbfgs"),
            accept_fn=lambda _p: measure("rql acceptance"))

    if cmd == "refit":
        support_ci.support_vmc(
            vmc.anqs, tgt, load_h(h_path), mol.e_nuc,
            **{**REFIT, "steps_per_stage": int(argv[2]) if len(argv) > 2
               else REFIT["steps_per_stage"]},
            lrs=tuple(refit_lrs), refit_clip=refit_clip,
            refit_beta=refit_beta, target_coef=tc, on_log=on_log,
            on_stage=stage_recorder("refit", optimizer="refit"),
            accept_fn=lambda _p: measure("refit acceptance"))

    if cmd == "repair":
        h = load_h(h_path)
        incumbent = (best_row["full_e"] if best_row is not None
                     else measure("incumbent"))
        print(f"incumbent sampled full energy {incumbent:+.6f} "
              f"({corr(incumbent):.2f}% corr)", flush=True)
        r_steps = int(argv[2]) if len(argv) > 2 else 300
        q_steps = int(argv[3]) if len(argv) > 3 else 300
        support_ci.support_vmc(
            vmc.anqs, tgt, h, mol.e_nuc,
            **{**REFIT, "steps_per_stage": r_steps}, lrs=(repair_lr,),
            refit_clip=refit_clip, refit_beta=refit_beta, target_coef=tc,
            select="loss", on_log=on_log)
        print("refit leg done; rq re-descent from the repaired state",
              flush=True)
        support_ci.support_vmc(
            vmc.anqs, tgt, h, mol.e_nuc, **REPAIR_RQ,
            steps_per_stage=q_steps, on_log=on_log,
            on_stage=stage_recorder("repair", optimizer="repair"),
            accept_baseline=incumbent,
            accept_fn=lambda _p: measure("repair acceptance"))

    if cmd == "confirm":
        print(f"confirm: {'stage %d' % best_row['stage'] if best_row else ''}"
              f" from {src}", flush=True)
        es = np.array([measure(f"confirm {i}") for i in range(5)])
        np.save(os.path.join(run_dir, "confirm_energies.npy"), es)
        print(f"confirm: mean {es.mean():+.7f} +/- {es.std():.7f} "
              f"({corr(es.mean()):.2f}% corr)", flush=True)

    best = summary.data.get("best_full_e")
    if best is not None:
        print(f"BEST sampled full energy {best:.6f} = {corr(best):.2f}% of "
              f"CCSD(T) correlation ({(best - cisd) * 1e3:+.3f} mHa vs "
              f"CISD)", flush=True)
    return summary.data


if __name__ == "__main__":
    main()
