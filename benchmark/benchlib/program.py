"""The program under test: the port's ``VMC`` trainer built from a cell's
configuration and workload files, and what the benchmark observes of its
first steps for the reference to follow.

Everything of the port is imported inside these functions, so that the
harness's own modules load without it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import inputs


def build(config: dict, cell: dict, seed: int, device, mesh=None):
    """(vmc, state, initial parameters): the trainer of the cell at the
    seed's weights, with its optimizer and sampler generator seeded
    ``seed``."""
    from anqs_quantum_chemistry_torch.chem.molecule import Molecule
    from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
    from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig

    ansatz = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["ansatz"].items()}
    vmc_cfg = {**config["vmc"], **cell.get("vmc", {}),
               "seed": inputs.seed64(seed),
               "sr": SRConfig(**config["sr"])}
    vmc = VMC(Molecule.from_npz(inputs.molecule_path(config)),
              VMCConfig(**vmc_cfg), AnqsConfig(**ansatz), device=device,
              mesh=mesh)
    state = vmc.init_state()
    params0 = inputs.initial_params(config, seed, vmc.device)
    vmc.anqs.load_state_dict(params0, strict=True)
    return vmc, state, params0


class FirstSteps:
    """Records, while the first ``n`` steps run through the window's own
    call, each step's support and what the step computed on it (this
    rank's rows: words, validity, log|psi|, phase and the local energies'
    numerators t), the gradient as the optimizer gets it at the first
    applied update (Adam's first moment / (1 - beta1)) and the parameters
    after the ``n``-th. ``close()`` restores the trainer."""

    def __init__(self, vmc, state, n: int):
        self.vmc, self.n = vmc, n
        self.sets: List[tuple] = []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.params_n: Dict[str, torch.Tensor] = {}
        self.updates = 0
        support = vmc._support_and_eloc

        def recorded(*args, **kwargs):
            out = support(*args, **kwargs)
            if len(self.sets) < n:
                words, _, valid, _, la, ph, e = out
                self.sets.append(tuple(t.detach().clone() for t in (
                    words, valid, la, ph, e.t_re, e.t_im)))
            return out

        vmc._support_and_eloc = recorded
        named = dict(vmc.anqs.named_parameters())
        inner = state.opt.inner
        beta1 = inner.param_groups[0]["betas"][0]

        def after_update(optimizer, args, kwargs):
            self.updates += 1
            if self.updates == 1:
                self.grad1 = {k: inner.state[p]["exp_avg"].detach().clone()
                              / (1.0 - beta1) for k, p in named.items()}
            if self.updates == n:
                self.params_n = {k: p.detach().clone()
                                 for k, p in named.items()}

        self._hook = inner.register_step_post_hook(after_update)

    def close(self):
        self._hook.remove()
        self.vmc.__dict__.pop("_support_and_eloc", None)


def step_failures(metrics: dict) -> int:
    """Steps of a window that failed, each counted once: its energy is not
    finite, its gradient is not (the finite guard skips such an update),
    or its membership overflowed (a dropped row biases the local
    energies)."""
    bad = ~np.isfinite(metrics["energy"]) | ~np.isfinite(metrics["grad_norm"])
    for key in ("table_overflow", "pf_dropped_rows"):
        if key in metrics:
            bad |= metrics[key] > 0
    return int(bad.sum())
