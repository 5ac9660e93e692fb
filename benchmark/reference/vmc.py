"""The VMC update of one step, in plain PyTorch, and three steps in a row.

A step on a set S of unique determinants (the valid rows the program
sampled) at parameters theta:

1. log|psi| and phase of S (``ansatz.MadeAnqs``), float32;
2. sample-aware local energies (``hamiltonian``), float64, and the Born
   estimate E = sum_x a_x t_x / sum_x a_x^2, a_x = |psi(x)|;
3. the surrogate loss 2 sum_x f_x [log|psi(x)| Re(E_loc - E) + phase(x)
   Im(E_loc - E)], f_x = a_x^2 / sum a^2, held constant, and its gradient g;
4. MinSR on the k most probable rows: O = sqrt(f_i) (J_i - sum_j f_j J_j),
   J_i = d log psi(x_i) / d theta (complex: log|psi| + i phase) row by row,
   f renormalised over the k rows; g <- (g - Re O^H (eps I + O O^H)^-1 O g)
   / eps, with eps raised to 2^-20 max diag(O O^H) where that is larger;
5. the global-norm clip, then Adam.

``tf32``: the networks' float32 matmuls run in TF32 (the control, on a
CUDA device).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch

from .ansatz import MadeAnqs, words_to_bits
from .hamiltonian import GroupedPauliHamiltonian


@dataclasses.dataclass(frozen=True)
class UpdateConfig:
    lr: float = 1e-3
    clip: float = 1.0
    sr_k: int = 50
    sr_eps: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8


@contextlib.contextmanager
def matmul_tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def energy_and_gradient(net: MadeAnqs, ham: GroupedPauliHamiltonian,
                        params: Dict[str, torch.Tensor], words, cfg):
    """(E, the update's gradient before the clip, the set's (log|psi|,
    phase, t_re, t_im)) of one set."""
    bits = words_to_bits(words, net.n)
    with torch.no_grad():
        la, ph = net.log_psi(params, bits)
        t_re, t_im = ham.local_energy_numerators(words, la, ph)
        a = torch.exp(la.to(torch.float64))
        denom = torch.sum(a * a)
        e_re = torch.sum(a * t_re) / denom
        e_im = torch.sum(a * t_im) / denom
        f = a * a / denom
        d_re = t_re / a - e_re
        d_im = t_im / a - e_im
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    la_g, ph_g = net.log_psi(leaves, bits)
    loss = 2.0 * torch.sum(f * (la_g.to(torch.float64) * d_re
                                + ph_g.to(torch.float64) * d_im))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    g = torch.cat([x.reshape(-1) for x in grads]).to(torch.float64)
    g = minsr(net, params, bits, f, g, cfg)
    return float(e_re), g, (la, ph, t_re, t_im)


def minsr(net, params, bits, f, g, cfg):
    k = min(cfg.sr_k, bits.shape[0])
    top_f, top = torch.topk(f, k)
    w = top_f / torch.sum(top_f)
    rows = []
    for i in top.tolist():
        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in params.items()}
        la, ph = net.log_psi(leaves, bits[i:i + 1])
        d_la = torch.autograd.grad(la[0], list(leaves.values()),
                                   allow_unused=True, retain_graph=True)
        d_ph = torch.autograd.grad(ph[0], list(leaves.values()),
                                   allow_unused=True)
        flat = [torch.cat([(torch.zeros_like(v) if d is None else d)
                           .reshape(-1) for d, v in zip(ds, leaves.values())])
                for ds in (d_la, d_ph)]
        rows.append(torch.complex(flat[0].to(torch.float64),
                                  flat[1].to(torch.float64)))
    jac = torch.stack(rows)
    o = torch.sqrt(w)[:, None] * (jac - torch.sum(w[:, None] * jac, 0))
    s = o @ o.conj().T
    eps = max(cfg.sr_eps, 2.0 ** -20 * float(torch.max(s.diagonal().real)))
    eye = torch.eye(k, dtype=s.dtype, device=s.device)
    y = torch.linalg.solve(s + eps * eye, o @ g.to(s.dtype))
    return (g - (o.conj().T @ y).real) / eps


def follow(net: MadeAnqs, ham: GroupedPauliHamiltonian,
           params0: Dict[str, torch.Tensor], sets: List[torch.Tensor],
           cfg: UpdateConfig = UpdateConfig(), tf32: bool = False) -> dict:
    """Steps on ``sets`` (each the (S, W) valid rows of one step) from
    ``params0``. Returns each step's energy and its set's (log|psi|,
    phase, t_re, t_im), the first step's clipped gradient by leaf and the
    parameters after the last step."""
    names = list(params0)
    shapes = [params0[n].shape for n in names]
    sizes = [params0[n].numel() for n in names]
    theta = torch.cat([params0[n].reshape(-1) for n in names]).to(
        torch.float64)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    energies, grad1, rows = [], None, []

    def unflat(x):
        return {n: c.reshape(s) for n, c, s in
                zip(names, torch.split(x, sizes), shapes)}

    with matmul_tf32(tf32):
        for t, words in enumerate(sets, start=1):
            params = {n: p.to(torch.float32) for n, p in
                      unflat(theta).items()}
            e, g, row = energy_and_gradient(net, ham, params, words, cfg)
            rows.append(row)
            norm = torch.linalg.vector_norm(g)
            g = g * min(1.0, cfg.clip / max(float(norm), 1e-30))
            if grad1 is None:
                grad1 = unflat(g)
            energies.append(e)
            m = cfg.beta1 * m + (1.0 - cfg.beta1) * g
            v = cfg.beta2 * v + (1.0 - cfg.beta2) * g * g
            m_hat = m / (1.0 - cfg.beta1 ** t)
            v_hat = v / (1.0 - cfg.beta2 ** t)
            # The parameters stay float32, as the configuration states.
            theta = (theta - cfg.lr * m_hat / (torch.sqrt(v_hat)
                                               + cfg.adam_eps)).to(
                torch.float32).to(torch.float64)
    return {"energies": energies, "grad1": grad1, "rows": rows,
            "params": {n: p.to(torch.float32)
                       for n, p in unflat(theta).items()}}
