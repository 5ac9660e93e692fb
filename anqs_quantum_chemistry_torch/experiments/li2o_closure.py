"""The Li2O closure leg on one card, the port's counterpart of the JAX
package's ``examples/li2o_closure.py``: NADE-(128, 128) VMC with tempered
gradient weights and the closure's learning-rate ladder.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.li2o_closure \
        [src_run] [iters] [T]

Trains ``li2o_nade_vmc`` (8192 Gumbel samples, prefilter capacities (768,
4096), MinSR top 50, clip 0.5) with Adam 1e-4 (3e-5 from 8000, 1e-5 from
13000), gradient weights |psi|^(2/T) (``T`` default 2), the full energy
every 500 iterations, for ``iters`` (default 16000) in windows of 25, into
``runs/li2o_closure_torch`` (checkpoints every 500). It resumes from its
own newest checkpoint; else it warm-starts from the newest ``ckpt_*`` of
``src_run`` (a run directory of this package, e.g. ``cisd_pretrain_vmc``'s)
or, with no ``src_run``, from the JAX package's closure state that ships
with the port (``li2o_nade_closure_params``), saved as ``ckpt_0``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .vmc import (
    CHECKPOINT_FILE,
    LI2O_FCI_ENERGY,
    latest_checkpoint,
    li2o_nade_closure_params,
    li2o_nade_vmc,
)


def warm_start(vmc, src: str = None) -> str:
    """The checkpoint ``vmc.run`` resumes from: the newest of its own run
    directory, else a ``ckpt_0`` written there from the newest checkpoint
    of ``src`` (its parameters, a fresh optimizer) or, with no ``src``,
    from the packaged JAX closure state."""
    resume = latest_checkpoint(vmc.run_dir)
    if resume:
        print(f"resuming from {resume}", flush=True)
        return resume
    if src:
        src_ckpt = latest_checkpoint(src)
        if src_ckpt is None:
            raise FileNotFoundError(f"no checkpoint under {src}")
        params = torch.load(os.path.join(src_ckpt, CHECKPOINT_FILE),
                            map_location="cpu", weights_only=True)["params"]
    else:
        src_ckpt = "the packaged JAX closure state"
        params = li2o_nade_closure_params()
    state = vmc.init_state()
    vmc.anqs.load_state_dict(params)
    resume = os.path.join(vmc.run_dir, "ckpt_0")
    vmc.save_checkpoint(resume, state, 0)
    print(f"warm start from {src_ckpt}", flush=True)
    return resume


def report(best, hf):
    gap = (best["energy"] - LI2O_FCI_ENERGY) * 1e3
    corr = (best["energy"] - hf) / (LI2O_FCI_ENERGY - hf)
    print(f"best {best['energy']:.6f} at {best['iter']} gap {gap:+.3f} mHa "
          f"({100 * corr:.2f}% of FCI corr; "
          f"{'CHEMICAL ACCURACY' if gap < 1.6 else 'not yet'})", flush=True)


def main(argv=None, device="cuda", run_root="runs", **overrides):
    argv = sys.argv if argv is None else argv
    src = argv[1] if len(argv) > 1 and argv[1] else None
    iters = int(argv[2]) if len(argv) > 2 else 16000
    temp = float(argv[3]) if len(argv) > 3 else 2.0

    cfg = dict(lr=1e-4, lr_schedule=((0, 1e-4), (8000, 3e-5), (13000, 1e-5)),
               full_energy_period=500, iter_num=iters,
               grad_weight_temperature=temp)
    vmc = li2o_nade_vmc(device=device,
                        run_dir=os.path.join(run_root, "li2o_closure_torch"),
                        **{**cfg, **overrides})
    resume = warm_start(vmc, src)
    t0 = time.perf_counter()

    def progress(it, row):
        if it % 250 == 0 or np.isfinite(row["full_energy"]):
            print(f"iter {it:6d} E {row['energy']:+.6f} gap "
                  f"{(row['energy'] - LI2O_FCI_ENERGY) * 1e3:+.3f} mHa "
                  f"full {row['full_energy']:+.6f} "
                  f"found {int(row['found_pairs'])} "
                  f"pf_dropped {int(row['pf_dropped_rows'])} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)

    _, history, best = vmc.run(iter_num=iters, on_iter=progress,
                               checkpoint_every=500, steps_per_call=25,
                               resume_from=resume)
    report(best, vmc.mol.hf_energy)
    return history, best


if __name__ == "__main__":
    main()
