"""Regularized stochastic reconfiguration (MinSR) on the top-k determinants.

Counterpart of the JAX package's ``optim/sr.py`` (reference: nqs/nqs/
applications/quantum_chemistry/experiments/calculations/sr.py:88-137):
centered per-sample log-derivatives O over the top-k most probable sampled
determinants, then the sample-space solve

    grad <- eps^-1 [g - O^dag (eps I + O O^dag)^-1 O g],

or, with ``use_reg=False``, the unregularised pseudo-inverse form
``O^dag (S + floor)^-2 O g`` (reference sr.py:129-135).

Per-sample Jacobians come from ``torch.func.jacrev`` of the batched
``log_psi`` through ``functional_call``; complex quantities are carried as
(re, im) pairs. The Hermitian k x k system is solved directly in float64
(the JAX package needs a Schulz iteration in float32 there, because f64
linear algebra does not compile for its TPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.func import functional_call, jacrev

from ..utils import cost


@dataclasses.dataclass(frozen=True)
class SRConfig:
    max_indices_num: int = 25
    use_reg: bool = True
    reg_eps: float = 1e-4


def _flatten(tensors: Dict[str, torch.Tensor], names, lead=()):
    return torch.cat([tensors[n].reshape(*lead, -1) for n in names], dim=-1)


def _unflatten(flat: torch.Tensor, like: Dict[str, torch.Tensor]):
    out, off = {}, 0
    for name, t in like.items():
        out[name] = flat[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
    return out


def _per_sample_jacobians(anqs, params: Dict[str, torch.Tensor], words
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, P) Jacobians of log|psi| and phase of ``words`` with respect to
    ``params`` flattened in their dict order."""
    k = words.shape[0]

    def both(p):
        return functional_call(anqs, p, (words,))

    detached = {n: t.detach() for n, t in params.items()}
    # jacrev backs 2k cotangents through the k-row batch: k times the work
    # of JAX's one vjp a row; a counter files it apart (utils/cost.py).
    with cost.region("minsr_jacobians"):
        jac_la, jac_ph = jacrev(both)(detached)
    names = list(params)
    return _flatten(jac_la, names, (k,)), _flatten(jac_ph, names, (k,))


def sr_transform(anqs, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], words, weights,
                 config: SRConfig = SRConfig()) -> Dict[str, torch.Tensor]:
    """Apply the MinSR preconditioner to ``grads`` (a dict like
    ``params``). ``weights`` are the (B,) normalized frequencies of
    ``words`` (invalid rows weight 0)."""
    k = min(config.max_indices_num, words.shape[0])
    top_w, top_idx = torch.topk(weights, k)
    f = top_w / torch.clamp(torch.sum(top_w), min=1e-30)
    j_la, j_ph = _per_sample_jacobians(anqs, params, words[top_idx])
    g = _flatten(grads, list(params))

    # Center: J <- J - sum_i f_i J_i (reference sr.py:119).
    j_la = j_la - torch.sum(f[:, None] * j_la, dim=0, keepdim=True)
    j_ph = j_ph - torch.sum(f[:, None] * j_ph, dim=0, keepdim=True)
    sqrt_f = torch.sqrt(f)[:, None]
    new = minsr_precondition(sqrt_f * j_la, sqrt_f * j_ph, g,
                             config.reg_eps, config.use_reg)
    return _unflatten(new, grads)


def minsr_precondition(o_re, o_im, g, eps: float, use_reg: bool = True):
    """The MinSR sample-space solve on an explicit (k, P) O-matrix, in
    float64; returns float32 like ``g``. With ``use_reg`` (reference
    sr.py:121-128):

        grad <- eps^-1 [g - O^dag (eps I + O O^dag)^-1 O g],

    ``eps`` under the JAX package's relative floor 2^-20 * max diag S, so
    both packages solve the same system. Without it (reference
    sr.py:129-135, utils/misc.py:45-52; JAX ``optim/sr.py:170-232``):

        grad <- O^dag (S + floor)^-2 O g,  floor = 2^-14 * max diag S,

    JAX's twice-applied small-ridge stand-in for (O^dag O)^+ g, whose floor
    truncates the near-zero eigenvalues as the reference's SVD cutoff does.
    """
    k = o_re.shape[0]
    o_re = o_re.to(torch.float64)
    o_im = o_im.to(torch.float64)
    g64 = g.to(torch.float64)
    s_re = o_re @ o_re.T + o_im @ o_im.T
    s_im = o_im @ o_re.T - o_re @ o_im.T
    block = torch.cat(
        [torch.cat([s_re, -s_im], 1), torch.cat([s_im, s_re], 1)], 0
    )
    floor = 2.0 ** (-20 if use_reg else -14) * torch.max(torch.diag(block))
    reg = torch.clamp(floor, min=eps if use_reg else 0.0)
    m = block + reg * torch.eye(2 * k, dtype=torch.float64, device=g.device)
    rhs = torch.cat([o_re @ g64, o_im @ g64])
    y = torch.linalg.solve(m, rhs)
    if not use_reg:
        y = torch.linalg.solve(m, y)
    # O^dag y = (O_re^T - i O_im^T)(y_re + i y_im); real part only.
    ody_re = o_re.T @ y[:k] + o_im.T @ y[k:]
    if not use_reg:
        return ody_re.to(g.dtype)
    return ((g64 - ody_re) / reg).to(g.dtype)


def clip_grad_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """Global-norm clipping (reference process_grad.py:56-70); returns
    (clipped grads, norm before clipping)."""
    norm = torch.linalg.vector_norm(
        torch.cat([g.reshape(-1) for g in grads.values()])
    )
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-30), max=1.0)
    return {n: g * scale for n, g in grads.items()}, norm
