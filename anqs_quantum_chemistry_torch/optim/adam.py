"""Adam over a module's parameters as one flat vector, its whole state on
the device.

``optax.adam(lr)``'s update (JAX ``optim/pretrain.py``), and with
``max_consecutive_errors`` set, ``optax.apply_if_finite(optax.adam(lr),
max_consecutive_errors)`` (the JAX distillation cycle's optimizer,
``experiments/vmc.py`` ``_get_distill``): an update whose gradients hold a
NaN or an Inf is skipped -- parameters, moments and the count of applied
updates untouched -- until more than ``max_consecutive_errors`` come in a
row. The skip is a device select, so a step reads nothing back to the host
(``experiments.vmc.FiniteGuardOptimizer`` decides on the host). The
parameters, gradients and moments are handled as flat float32 vectors: a
step launches a fixed handful of kernels whatever the number of parameter
tensors.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

# optax.adam's defaults.
B1, B2, EPS = 0.9, 0.999, 1e-8


class FlatAdam:
    def __init__(self, params: Iterable[torch.nn.Parameter],
                 max_consecutive_errors: Optional[int] = None):
        self.params = list(params)
        self.sizes = [p.numel() for p in self.params]
        self.max_consecutive_errors = max_consecutive_errors
        device = self.params[0].device
        n = sum(self.sizes)
        self.mu = torch.zeros(n, dtype=torch.float32, device=device)
        self.nu = torch.zeros(n, dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.notfinite_count = torch.zeros((), dtype=torch.int64,
                                           device=device)

    @staticmethod
    def flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1) for t in tensors])

    def flat_params(self) -> torch.Tensor:
        return self.flat(self.params)

    @torch.no_grad()
    def load(self, flat: torch.Tensor):
        """Copy a flat vector into the parameters."""
        torch._foreach_copy_(
            self.params,
            [c.view_as(p) for c, p in zip(flat.split(self.sizes),
                                          self.params)])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float):
        """One update from ``grads`` (one per parameter) at rate ``lr``."""
        g = self.flat(grads)
        if self.max_consecutive_errors is None:
            apply = None
        else:
            finite = torch.isfinite(g).all()
            self.notfinite_count = torch.where(
                finite, 0, self.notfinite_count + 1)
            apply = finite | (self.notfinite_count
                              > self.max_consecutive_errors)
        count = self.count + 1
        mu = (1.0 - B1) * g + B1 * self.mu
        nu = (1.0 - B2) * (g * g) + B2 * self.nu
        # optax's bias corrections, in float64 as the JAX package runs.
        c = count.to(torch.float64)
        mu_hat = mu / (1.0 - B1 ** c).to(torch.float32)
        nu_hat = nu / (1.0 - B2 ** c).to(torch.float32)
        p_old = self.flat_params()
        p = p_old + (mu_hat / (torch.sqrt(nu_hat) + EPS)) * (-lr)
        if apply is not None:
            mu = torch.where(apply, mu, self.mu)
            nu = torch.where(apply, nu, self.nu)
            count = torch.where(apply, count, self.count)
            p = torch.where(apply, p, p_old)
        self.mu, self.nu, self.count = mu, nu, count
        self.load(p)
