"""The Li2O support-CI closure, distillation leg, on one card: the port's
counterpart of the JAX package's ``examples/li2o_support_ci.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.li2o_support_ci \
        [stage_iters] [build]

The trained NADE-(128, 128) of the Li2O closure leg is close to the ground
state of H restricted to what its sampler proposes; the energy it misses
lives in determinants it gives almost no weight. This leg distils the
state onto a selected-CI vector that holds them: 4 stages of
``stage_iters`` (default 6000) minibatched cross-entropy steps (batch 8192,
Adam 3e-4, 1e-4, 3e-5, 1e-5; ``support_ci.distill``), each followed by the
sampled full energy of 16,384 unique determinants and a checkpoint
``ckpt_<stage + 1>`` in ``runs/li2o_sci_torch``, with ``summary.json`` at
the end.

Warm start: the run directory's newest checkpoint, else the packaged JAX
closure state (``data/li2o_nade_closure.npz``, the JAX leg's own start).
Target: the run directory's ``target.npz`` when an earlier ``build`` wrote
one; with ``build``, ``build_target`` (a seed of 3 Gumbel samples of
16,384, one or two selected-CI rounds from its top 500, then the smallest
power-of-two truncation within 0.3 mHa of the expansion); else the JAX
package's target, which ships with the port (``data/li2o_sci_target.npz``:
131,072 determinants, restricted E0 -88.705381).

The trainer (``li2o_sci_vmc``) is the JAX example's: 16,384 Gumbel samples,
qubit_per_qudit 6, seed 0, prefilter capacities (768, 4096); it supplies
the ansatz, the sampler and the full energy.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..chem import selected_ci as sci
from ..chem.molecule import DATA_DIR, load_li2o
from ..convert import load_params_npz
from . import support_ci
from .vmc import (
    LI2O_FCI_ENERGY,
    LI2O_NADE,
    LI2O_PREFILTER,
    VMC,
    VMCConfig,
    latest_checkpoint,
    li2o_nade_closure_params,
)

RUN_NAME = "li2o_sci_torch"
LI2O_SCI_TARGET = os.path.join(DATA_DIR, "li2o_sci_target.npz")
# The JAX examples' trainer (li2o_support_ci.py, li2o_sci_polish.py).
SCI_VMC_CONFIG = dict(sample_num=16384, sampling_mode="gumbel",
                      qubit_per_qudit=6, seed=0,
                      engine_overrides=LI2O_PREFILTER)
FULL_ENERGY_SAMPLES = 16384
DISTILL_LRS = (3e-4, 1e-4, 3e-5, 1e-5)
DISTILL_BATCH = 8192


def li2o_sci_vmc(device="cuda", run_dir=None, **overrides) -> VMC:
    """The support-CI legs' trainer: Li2O/STO-3G, NADE-(128, 128) for both
    nets, ``SCI_VMC_CONFIG``; ``overrides``: other ``VMCConfig`` fields."""
    return VMC(load_li2o(), VMCConfig(**{**SCI_VMC_CONFIG, **overrides}),
               LI2O_NADE, device=device, run_dir=run_dir)


def li2o_sci_params(ckpt: int):
    """A state of the JAX package's support-CI chain
    (``runs/li2o_sci/ckpt_<ckpt>``: 4 after distillation, 13 after the
    temperature-4 polish, 26 after the linear-penalty polish), written by
    ``tools/export_jax_params.py`` into the port's data, as a state dict of
    ``li2o_sci_vmc``'s ansatz."""
    return load_params_npz(os.path.join(DATA_DIR, f"li2o_sci_ckpt{ckpt}.npz"))


def load_target(path: str = LI2O_SCI_TARGET):
    """(sorted dets as Python ints, float64 coef, restricted E0) of a
    target file."""
    with np.load(path) as d:
        return ([int(x) for x in d["dets"]],
                np.asarray(d["coef"], np.float64), float(d["e0"]))


def full_energy_fn(vmc, generator: torch.Generator,
                   samples: int = FULL_ENERGY_SAMPLES):
    """``f(tag) -> energy``: the sampled full energy of the ansatz's
    current parameters at ``samples`` unique determinants, printed."""

    def measure(tag):
        t0 = time.perf_counter()
        e, var = support_ci.sampled_full_energy(vmc, generator, samples)
        print(f"  [{tag}] sampled full energy {e:+.6f} "
              f"({(e - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa vs FCI) var "
              f"{var:.2e} [{time.perf_counter() - t0:.1f}s]", flush=True)
        return e

    return measure


def build_target(mol, vmc, run_dir: str, generator: torch.Generator):
    """Host phase: the sampled seed -> selected CI (500 parents, 2 rounds,
    tol 2e-4) -> the smallest power-of-two truncation (2^17, 2^18, 2^19)
    within 0.3 mHa of the expansion, written to ``run_dir/target.npz``.
    Returns (dets, coef, e0)."""
    t0 = time.perf_counter()
    seed = support_ci.sample_support(vmc, generator, FULL_ENERGY_SAMPLES,
                                     passes=3)
    print(f"sampled seed support: {len(seed)} "
          f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    def log_round(r):
        print(f"  selected-CI round {r['round']}: |S|={r['size']} "
              f"E={r['energy']:.6f} gain {r['gain'] * 1e3:.3f} mHa "
              f"[{r['seconds']:.0f}s]", flush=True)

    e_full, dets, coef = sci.selected_ci(seed, mol.h1, mol.v, mol.e_nuc,
                                         n_parents=500, rounds=2, tol=2e-4,
                                         on_round=log_round)
    print(f"expansion: |S|={len(dets)} E0={e_full:.6f} "
          f"({(e_full - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa)", flush=True)
    for k in (1 << 17, 1 << 18, 1 << 19):
        if k >= len(dets):
            td, tc, e_k = dets, np.asarray(coef, np.float64), e_full
            break
        td, tc = sci.truncate_by_weight(dets, coef, k)
        t0 = time.perf_counter()
        e_k, tc = sci.restricted_ground_state(td, mol.h1, mol.v, mol.e_nuc)
        print(f"top-{k}: E0={e_k:.6f} "
              f"({(e_k - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa) "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
        if e_k - e_full < 3e-4:
            break
    np.savez_compressed(os.path.join(run_dir, "target.npz"),
                        dets=np.array(td, np.uint64), coef=tc, e0=e_k,
                        e0_full=e_full, n_full=len(dets))
    return td, tc, e_k


def main(argv=None, device="cuda", run_root="runs",
         full_samples: int = FULL_ENERGY_SAMPLES, **overrides):
    """``full_samples``: the full energy's sample (tests cut it);
    ``overrides``: other ``VMCConfig`` fields."""
    argv = sys.argv if argv is None else argv
    stage_iters = int(argv[1]) if len(argv) > 1 else 6000
    build = len(argv) > 2 and argv[2] == "build"
    run_dir = os.path.join(run_root, RUN_NAME)
    vmc = li2o_sci_vmc(device=device, run_dir=run_dir, **overrides)
    mol = vmc.mol

    own = latest_checkpoint(run_dir)
    if own:
        state, start_stage = vmc.load_checkpoint(own)
        print(f"resuming from {own} (stage {start_stage})", flush=True)
    else:
        state, start_stage = vmc.init_state(), 0
        vmc.anqs.load_state_dict(li2o_nade_closure_params())
        print("warm start from the packaged JAX closure state", flush=True)

    own_target = os.path.join(run_dir, "target.npz")
    if os.path.exists(own_target):
        td, tc, e_k = load_target(own_target)
    elif build:
        seed_gen = torch.Generator(device=vmc.device).manual_seed(7)
        td, tc, e_k = build_target(mol, vmc, run_dir, seed_gen)
    else:
        td, tc, e_k = load_target()
    print(f"target: |S|={len(td)} E0={e_k:.6f} "
          f"({(e_k - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa)", flush=True)
    target = support_ci.make_target(td, tc, mol.qubit_num, vmc.device)
    full_energy = full_energy_fn(vmc, state.generator, full_samples)

    t0 = time.perf_counter()

    def plog(row):
        print(f"  distill {row['iter']:5d} loss {row['loss']:.6f} "
              f"ce {row['cross_entropy']:.6f} best {row['best_loss']:.6f} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    results = {"target_e0": e_k, "target_size": len(td), "stages": []}
    best = (np.inf, None, -1)
    full_energy("warm start")
    for si, lr in enumerate(DISTILL_LRS):
        if si < start_stage:
            continue
        support_ci.distill(
            vmc.anqs, target,
            torch.Generator(device=vmc.device).manual_seed(100 + si),
            ((stage_iters, lr),), batch=DISTILL_BATCH, on_log=plog,
            log_every=500)
        e = full_energy(f"stage {si} lr={lr:g}")
        ck = os.path.join(run_dir, f"ckpt_{si + 1}")
        vmc.save_checkpoint(ck, state, si + 1)
        results["stages"].append({"stage": si, "lr": lr, "full_e": e})
        if e < best[0]:
            best = (e, ck, si)
    results["best_full_e"] = best[0]
    results["best_stage"] = best[2]
    results["gap_mha"] = (best[0] - LI2O_FCI_ENERGY) * 1e3
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"BEST sampled full energy {best[0]:.6f} "
          f"({results['gap_mha']:+.3f} mHa vs FCI; "
          f"{'CHEMICAL ACCURACY' if results['gap_mha'] < 1.6 else 'not yet'}"
          ")", flush=True)
    return results


if __name__ == "__main__":
    main()
