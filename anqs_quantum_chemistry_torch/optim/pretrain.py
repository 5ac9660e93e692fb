"""Supervised amplitude pretraining: warm-start an ANQS from a known
wavefunction (the CISD vector, ``chem/fci.py`` ``cisd_ground_state``).

Counterpart of the JAX package's ``optim/pretrain.py``: Adam on the
cross-entropy toward the target Born weights plus ``phase_weight`` times
the phase MSE over the target's determinants,

    L = -2 sum_i w_i p_i log|psi(x_i)| + phase_weight sum_i w_i p_i
        (phase(x_i) - phase_i)^2,

over the whole support when it fits one batch (w = 1), else over an
importance-sampled minibatch (indices drawn by probability with
replacement, p = 1, w = 1/batch). ``keep_best`` returns the parameters
that produced the lowest loss, tracked on the device with no host sync a
step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import bits as bitops
from .adam import FlatAdam


def amplitude_targets_from_coefs(coefs: np.ndarray):
    """(probs, phases) float32 targets from real CI coefficients: Born
    weights renormalized over the support, phases 0 / pi from the signs,
    the global sign fixed so that the largest-|c| determinant has phase 0
    (JAX ``amplitude_targets_from_coefs``)."""
    c = np.asarray(coefs, np.float64)
    c = c * np.sign(c[np.argmax(np.abs(c))] or 1.0)
    p = c * c
    p = p / p.sum()
    ph = np.where(c < 0.0, np.pi, 0.0)
    return p.astype(np.float32), ph.astype(np.float32)


def pack_dets(dets, qubit_num: int) -> torch.Tensor:
    """uint64 determinants (bit q = qubit q) -> (N, W) int64 packed words,
    each holding 32 qubits (up to 64 qubits)."""
    d = np.asarray(dets, np.uint64)
    w = bitops.n_words(qubit_num)
    if w > 2:
        raise ValueError("more than 64 qubits do not fit a uint64")
    words = np.stack([(d >> np.uint64(32 * k)) & np.uint64(bitops.MASK32)
                      for k in range(w)], axis=1)
    return torch.from_numpy(words.astype(np.int64))


def pretrain(anqs, words, probs, phases,
             generator: Optional[torch.Generator] = None, iters: int = 1500,
             lr: float = 1e-3, batch: int = 8192, phase_weight: float = 1.0,
             log_every: int = 200, on_log: Optional[Callable] = None,
             keep_best: bool = True,
             draw: Optional[Callable[[int], torch.Tensor]] = None):
    """Adam (``FlatAdam``: optax's ``adam`` update) on the loss
    above for ``iters`` steps, starting from the parameters ``anqs`` holds.
    Returns (params, history): ``params`` by name, also loaded into
    ``anqs`` -- with ``keep_best`` the pre-update parameters that produced
    the lowest loss (a NaN never replaces them; the final parameters are
    not evaluated), else the final ones. ``history``: rows ``iter``,
    ``loss``, ``cross_entropy``, ``phase_mse``, ``best_loss`` every
    ``log_every`` steps and at the last (each also to ``on_log``).

    ``words`` (N, W), ``probs`` and ``phases`` (N,) move to the ansatz's
    device. Above ``batch`` determinants each step draws ``batch`` indices
    by ``probs`` with replacement from ``generator`` (on the ansatz's
    device; seed 0 when None), or takes ``draw(step)`` in their place."""
    params = dict(anqs.named_parameters())
    device = next(iter(params.values())).device
    words = torch.as_tensor(words).to(device)
    probs = torch.as_tensor(probs, dtype=torch.float32).to(device)
    phases = torch.as_tensor(phases, dtype=torch.float32).to(device)
    n = words.shape[0]
    full = n <= batch
    if not full and draw is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)

        def draw(_):
            return torch.multinomial(probs, batch, replacement=True,
                                     generator=generator)
    opt = FlatAdam(params.values())
    best_l = torch.full((), torch.inf, device=device)
    best_p = opt.flat_params()
    history = []
    for it in range(iters):
        if full:
            w, tp, tph = words, probs, phases
            wgt = 1.0
        else:
            idx = draw(it).to(device)
            w, tph = words[idx], phases[idx]
            tp, wgt = 1.0, 1.0 / batch
        la, ph = anqs.log_psi(w)
        ce = -2.0 * torch.sum(wgt * tp * la)
        dph = ph - tph
        pml = torch.sum(wgt * tp * dph * dph)
        loss = ce + phase_weight * pml
        grads = torch.autograd.grad(loss, list(params.values()))
        loss, ce, pml = loss.detach(), ce.detach(), pml.detach()
        # Snapshot the parameters that produced this loss, before the
        # update (device selects, no host sync).
        better = loss < best_l
        best_l = torch.where(better, loss, best_l)
        best_p = torch.where(better, opt.flat_params(), best_p)
        opt.step(grads, lr)
        if it % log_every == 0 or it == iters - 1:
            row = {"iter": it, "loss": float(loss),
                   "cross_entropy": float(ce), "phase_mse": float(pml),
                   "best_loss": float(best_l)}
            history.append(row)
            if on_log is not None:
                on_log(row)
    if keep_best:
        opt.load(best_p)
    out = {k: v.detach().clone() for k, v in params.items()}
    return out, history
