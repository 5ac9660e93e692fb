"""The Li2O support-CI closure, pinned-support VMC, on one card: the port's
counterpart of the JAX package's ``examples/li2o_pin_vmc.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.li2o_pin_vmc \
        [iters] [lr] [src_ckpt]

After distillation and polish, the NADE restricted to the selected-CI
support is within a fraction of a mHa of its restricted ground state, but
its sampled full energy is mHa higher: it leaks amplitude onto
determinants outside the support. VMC's energy gradient trims such leaks,
but a top-k sampler forgets the tail it never draws. Here the top 8192
determinants of the selected-CI target by |coef| (``couple_support_file``
= the packaged target, ``couple_support_k`` 8192; their restricted E0 is
+0.111 mHa above FCI) ride in every batch with Born weights.

``VMC.run`` for ``iters`` (default 6000) at the example's settings: 16,384
Gumbel samples, NADE-(128, 128), qubit_per_qudit 6, Adam ``lr`` (default
1e-4; lr/3 from 3000, lr/10 from 5000), clip 0.5, gradient weights
|psi|^(2/2), Born weights, MinSR top 50, prefilter capacities (768, 4096),
the full energy every 250 iterations, windows of 25, checkpoints every 250
in ``runs/li2o_pin_torch``. It resumes from that directory's newest
checkpoint; else it warm-starts from ``src_ckpt`` (a checkpoint directory
of this package) or, by default, from the JAX package's state after the
temperature-4 polish (``data/li2o_sci_ckpt13.npz``, the JAX run's own
start), saved as ``ckpt_0``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..chem.molecule import load_li2o
from ..optim.sr import SRConfig
from .li2o_support_ci import LI2O_SCI_TARGET, li2o_sci_params
from .vmc import (
    CHECKPOINT_FILE,
    LI2O_FCI_ENERGY,
    LI2O_NADE,
    LI2O_PREFILTER,
    VMC,
    VMCConfig,
    latest_checkpoint,
)

RUN_NAME = "li2o_pin_torch"


def pin_config(iters: int = 6000, lr: float = 1e-4) -> dict:
    """The example's ``VMCConfig`` fields."""
    return dict(
        sample_num=16384, sampling_mode="gumbel", qubit_per_qudit=6, lr=lr,
        lr_schedule=((0, lr), (3000, lr / 3), (5000, lr / 10)),
        grad_clip_norm=0.5, grad_weight_temperature=2.0,
        use_theor_freqs=True, sr=SRConfig(max_indices_num=50),
        couple_support_file=LI2O_SCI_TARGET, couple_support_k=8192,
        engine_overrides=LI2O_PREFILTER, full_energy_period=250, seed=0,
        iter_num=iters)


def li2o_pin_vmc(device="cuda", run_dir=None, iters: int = 6000,
                 lr: float = 1e-4, **overrides) -> VMC:
    return VMC(load_li2o(),
               VMCConfig(**{**pin_config(iters, lr), **overrides}),
               LI2O_NADE, device=device, run_dir=run_dir)


def main(argv=None, device="cuda", run_root="runs", **overrides):
    argv = sys.argv if argv is None else argv
    iters = int(argv[1]) if len(argv) > 1 else 6000
    lr = float(argv[2]) if len(argv) > 2 else 1e-4
    src = argv[3] if len(argv) > 3 and argv[3] else None
    run_dir = os.path.join(run_root, RUN_NAME)
    vmc = li2o_pin_vmc(device=device, run_dir=run_dir, iters=iters, lr=lr,
                       **overrides)

    resume = latest_checkpoint(run_dir)
    if resume is None:
        state = vmc.init_state()
        if src:
            params = torch.load(os.path.join(src, CHECKPOINT_FILE),
                                map_location="cpu",
                                weights_only=True)["params"]
        else:
            src = "the packaged JAX state ckpt_13"
            params = li2o_sci_params(13)
        vmc.anqs.load_state_dict(params)
        resume = os.path.join(run_dir, "ckpt_0")
        vmc.save_checkpoint(resume, state, 0)
        print(f"warm start from {src}", flush=True)
    else:
        print(f"resuming from {resume}", flush=True)

    t0 = time.perf_counter()

    def progress(it, row):
        if it % 250 == 0 or np.isfinite(row["full_energy"]):
            gap = (row["energy"] - LI2O_FCI_ENERGY) * 1e3
            print(f"iter {it:6d} E {row['energy']:+.6f} gap {gap:+.3f} mHa "
                  f"full {row['full_energy']:+.6f} "
                  f"unique {int(row['unique_num'])} "
                  f"found {int(row['found_pairs'])} "
                  f"pf_dropped {int(row['pf_dropped_rows'])} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=250, steps_per_call=25,
                               resume_from=resume)
    fulls = [h["full_energy"] for h in history
             if np.isfinite(h["full_energy"])]
    best_full = min(fulls) if fulls else float("nan")
    gap = (best_full - LI2O_FCI_ENERGY) * 1e3
    print(f"best proxy {best['energy']:.6f} at {best['iter']}; best FULL "
          f"{best_full:.6f} gap {gap:+.3f} mHa "
          f"({'CHEMICAL ACCURACY' if gap < 1.6 else 'not yet'})", flush=True)
    return history, best


if __name__ == "__main__":
    main()
