"""Distillation-interleaved VMC of Li2O on one card, the port's counterpart
of the JAX package's ``examples/li2o_distill_closure.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.li2o_distill_closure \
        [src_run] [iters] [tau]

Trains ``li2o_nade_vmc`` (8192 Gumbel samples, prefilter capacities (768,
4096), MinSR top 50, clip 0.5, gradient weights |psi|^(2/2)) with Adam
3e-5 and, every 10 iterations, a distillation cycle of 100 Adam steps at
1e-4 toward (1 - tau (H - E)) |psi> on the step's support (cross-entropy;
``tau`` default 0.1), the full energy every 250 iterations, for ``iters``
(default 12000) in windows of 25, into ``runs/li2o_distill_torch``. It
warm-starts as ``li2o_closure`` does: its own newest checkpoint, else the
newest of ``src_run``, else the packaged JAX closure state (the JAX leg's
own start, ``runs/li2o_closure/ckpt_16000``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .li2o_closure import report, warm_start
from .vmc import LI2O_FCI_ENERGY, li2o_nade_vmc


def main(argv=None, device="cuda", run_root="runs", **overrides):
    argv = sys.argv if argv is None else argv
    src = argv[1] if len(argv) > 1 and argv[1] else None
    iters = int(argv[2]) if len(argv) > 2 else 12000
    tau = float(argv[3]) if len(argv) > 3 else 0.1

    cfg = dict(lr=3e-5, lr_schedule=None, full_energy_period=250,
               iter_num=iters, distill_period=10, distill_steps=100,
               distill_tau=tau, distill_lr=1e-4, distill_loss="ce")
    vmc = li2o_nade_vmc(device=device,
                        run_dir=os.path.join(run_root, "li2o_distill_torch"),
                        **{**cfg, **overrides})
    resume = warm_start(vmc, src)
    t0 = time.perf_counter()

    def progress(it, row):
        if it % 100 == 0 or np.isfinite(row["full_energy"]):
            print(f"iter {it:6d} E {row['energy']:+.6f} gap "
                  f"{(row['energy'] - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa "
                  f"full {row['full_energy']:+.6f} "
                  f"dloss {row['distill_loss_last']:.5f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=500, steps_per_call=25,
                               resume_from=resume)
    report(best, vmc.mol.hf_energy)
    return history, best


if __name__ == "__main__":
    main()
