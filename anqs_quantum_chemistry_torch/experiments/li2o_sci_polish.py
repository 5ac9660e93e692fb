"""The Li2O support-CI closure, polish leg, on one card: the port's
counterpart of the JAX package's ``examples/li2o_sci_polish.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.li2o_sci_polish \
        [steps] [temp] [lam]

Minibatched distillation (``li2o_support_ci``) slows down where the
remaining energy lives, in the target's tail, which its importance-sampled
batches rarely draw. This leg fits the whole 131,072-determinant target in
one batch a step, with the example's own loss:

    CE = -2 sum p la                     (mass placement)
  + the offset-free regression of la on log sqrt(p) with weights
    w = p^(1/temp) normalised: sum w dd^2 - (sum w dd)^2, dd = la - la_t
  + the tempered phase MSE sum w (ph - ph_t)^2
  + lam (1 - m)^2, m = sum exp(2 la) over the support (quadratic)

for 4 stages of ``steps`` (default 2000) Adam steps (lam 0: 3e-4, 1e-4,
3e-5, 1e-5; else 1e-4, 3e-5, 1e-5, 3e-6), each keeping its best-loss
parameters. This is the example's loss as the example has it, which
differs from ``support_ci.polish``: no gradient clip, la_t from p clamped
at 1e-38, exp(2 la) not clamped and the penalty quadratic. ``temp``
default 4, ``lam`` default 1000. Before the first stage and after each it
prints the exact Rayleigh quotient of the network restricted to the target
(host float64, H built once from the integrals) and, after each, the
sampled full energy of 16,384 determinants; it checkpoints ``ckpt_<base +
stage>`` (base 10 at lam 0, else 20) and writes ``polish_summary[_lam<lam>
].json``.

It shares ``runs/li2o_sci_torch`` with ``li2o_support_ci`` and starts from
that directory's newest checkpoint, else from the JAX package's state
after distillation (``data/li2o_sci_ckpt4.npz``). The closing leg of the
JAX record (linear penalty, temperature 2, lam 30: ``ckpt_26``) is
``support_ci.polish`` at its defaults, which needs no script of its own.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..chem import fci as fci_mod
from ..chem import selected_ci as sci
from . import support_ci
from .li2o_support_ci import (
    FULL_ENERGY_SAMPLES,
    RUN_NAME,
    full_energy_fn,
    li2o_sci_params,
    li2o_sci_vmc,
    load_target,
)
from .vmc import LI2O_FCI_ENERGY, latest_checkpoint


def example_polish_loss(anqs, target: dict, temp: float, lam: float,
                        chunk=None):
    """The JAX example's polish (loss, mass), as described in the module
    docstring."""
    p = target["p"]
    la_t = 0.5 * torch.log(torch.clamp(p, min=1e-38))
    w_l = p ** (1.0 / temp)
    w_l = w_l / torch.sum(w_l)

    def fn(la, ph, p_, la_t_, ph_t_, wl):
        la, ph = la.double(), ph.double()  # sums in float64, as polish's
        dd = la - la_t_
        dph = ph - ph_t_
        return (torch.sum(p_ * la), torch.sum(wl * dd),
                torch.sum(wl * dd * dd), torch.sum(wl * dph * dph),
                torch.sum(torch.exp(2.0 * la)))

    s = support_ci.row_sums(anqs, target["words"], fn,
                            (p, la_t, target["ph"], w_l), chunk)
    m = s[4]
    return -2.0 * s[0] + s[2] - s[1] * s[1] + s[3] + lam * (1.0 - m) ** 2, m


def stage_lrs(lam: float):
    return (3e-4, 1e-4, 3e-5, 1e-5) if lam == 0.0 else (1e-4, 3e-5, 1e-5,
                                                        3e-6)


def main(argv=None, device="cuda", run_root="runs",
         full_samples: int = FULL_ENERGY_SAMPLES,
         target_k: Optional[int] = None, **overrides):
    """``full_samples``: the full energy's sample; ``target_k``: fit only
    the target's top-k determinants by |coef| (tests cut both);
    ``overrides``: other ``VMCConfig`` fields."""
    argv = sys.argv if argv is None else argv
    steps = int(argv[1]) if len(argv) > 1 else 2000
    temp = float(argv[2]) if len(argv) > 2 else 4.0
    lam = float(argv[3]) if len(argv) > 3 else 1000.0
    run_dir = os.path.join(run_root, RUN_NAME)
    vmc = li2o_sci_vmc(device=device, run_dir=run_dir, **overrides)
    mol = vmc.mol

    src = latest_checkpoint(run_dir)
    if src:
        state, _ = vmc.load_checkpoint(src)
        print(f"resuming from {src}", flush=True)
    else:
        state = vmc.init_state()
        vmc.anqs.load_state_dict(li2o_sci_params(4))
        print("warm start from the packaged JAX state ckpt_4", flush=True)

    td, tc, e_k = load_target()
    if target_k is not None:
        td, tc = sci.truncate_by_weight(td, tc, target_k)
    print(f"target: |S|={len(td)} E0={e_k:.6f} "
          f"({(e_k - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa)", flush=True)
    target = support_ci.make_target(td, tc, mol.qubit_num, vmc.device)
    full_energy = full_energy_fn(vmc, state.generator, full_samples)

    t0 = time.perf_counter()
    h = fci_mod.sparse_hamiltonian(td, mol.h1, mol.v)
    print(f"  H({len(td)}) built: nnz {h.nnz} "
          f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    def rayleigh(tag):
        e = support_ci.support_rayleigh(mol, target, vmc.anqs, h=h)
        print(f"  [{tag}] model Rayleigh on support {e:+.6f} "
              f"({(e - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa)", flush=True)
        return e

    t0 = time.perf_counter()
    results = {"temp": temp, "lam": lam, "stages": []}
    results["before_rayleigh"] = rayleigh("before polish")
    base = 10 if lam == 0.0 else 20
    best = (np.inf, None)
    for si, lr in enumerate(stage_lrs(lam)):
        bl, l0 = support_ci.fit_stage(
            vmc.anqs,
            lambda: example_polish_loss(vmc.anqs, target, temp, lam)[0],
            lr, steps)
        with torch.no_grad():
            m = float(example_polish_loss(vmc.anqs, target, temp, lam)[1])
        print(f"stage {si} lr={lr:g}: loss {l0:.6f} -> {bl:.6f} mass "
              f"{m:.6f} [{time.perf_counter() - t0:.0f}s]", flush=True)
        e_sup = rayleigh(f"stage {si}")
        e = full_energy(f"stage {si}")
        ck = os.path.join(run_dir, f"ckpt_{base + si}")
        vmc.save_checkpoint(ck, state, base + si)
        results["stages"].append({"stage": si, "lr": lr, "loss": bl,
                                  "first_loss": l0, "mass": m, "full_e": e,
                                  "support_rayleigh": e_sup})
        if e < best[0]:
            best = (e, ck)
    results["best_full_e"] = best[0]
    results["gap_mha"] = (best[0] - LI2O_FCI_ENERGY) * 1e3
    suffix = "" if lam == 0.0 else f"_lam{lam:g}"
    with open(os.path.join(run_dir, f"polish_summary{suffix}.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    print(f"BEST sampled full energy {best[0]:.6f} "
          f"({results['gap_mha']:+.3f} mHa vs FCI; "
          f"{'CHEMICAL ACCURACY' if results['gap_mha'] < 1.6 else 'not yet'}"
          ")", flush=True)
    return results


if __name__ == "__main__":
    main()
