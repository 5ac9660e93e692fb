"""Ansatz ensembles: stacked parameter sets evaluated under ``vmap``.

Counterpart of the JAX package's ``models/ensemble.py`` (reference
``MultiHeadLinear`` / ``multi_head_mlp.py``): H independent parameter sets
of one ``ANQS``, every parameter stacked along a leading head axis, and
``torch.func.vmap`` over ``functional_call`` of the ansatz -- any net and
head ensemble-capable without new modules. The stacked dict has the
ansatz's parameter names, so ``convert.params_from_jax`` of a JAX stacked
tree (leading replica axis) is one.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
from torch.func import functional_call, vmap


@contextlib.contextmanager
def preserved_parameters(module):
    """Yield ``module``'s parameters by name; on exit they hold again the
    values they held on entry (code inside may load other sets)."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in params.items()}
    try:
        yield params
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])


@torch.no_grad()
def ensemble_init(anqs, generators: Sequence[torch.Generator]
                  ) -> Dict[str, torch.Tensor]:
    """One fresh parameter set of ``anqs`` a generator, drawn in turn
    (``ANQS.reset_parameters``; a generator given twice draws two sets one
    after the other), stacked: every parameter gains a leading
    (len(generators),) axis. ``anqs`` keeps its own parameters."""
    heads = []
    with preserved_parameters(anqs) as params:
        for generator in generators:
            anqs.reset_parameters(generator)
            heads.append({n: p.detach().clone() for n, p in params.items()})
    return {n: torch.stack([h[n] for h in heads]) for n in heads[0]}


def ensemble_log_psi(anqs, stacked_params: Dict[str, torch.Tensor], words):
    """(H-stacked parameters, (B, W) words) -> (log_abs (H, B), phase
    (H, B)): ``anqs.log_psi`` at each head's parameters."""
    def one(params):
        return functional_call(anqs, params, (words,))

    return vmap(one)(stacked_params)


def ensemble_mean_energy(e_heads, weights: Optional[torch.Tensor] = None):
    """The heads' energies (H, ...) averaged over the head axis, uniformly
    or by ``weights`` (H,)."""
    e = torch.as_tensor(e_heads)
    if weights is None:
        return torch.mean(e, dim=0)
    w = torch.as_tensor(weights, dtype=e.dtype, device=e.device)
    w = w.reshape(-1, *([1] * (e.dim() - 1)))
    return torch.sum(w * e, dim=0) / torch.sum(w)
