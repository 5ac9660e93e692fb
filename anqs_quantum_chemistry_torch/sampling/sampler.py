"""Exact Gumbel top-k sampling of unique determinants.

Counterpart of the JAX package's ``sampling/sampler.py`` for ``mode='gumbel'``
(reference sample_indices_gumbel, abstract_anqs.py:676-818): a frontier of at
most K = ``sample_num`` rows advances one qudit per step; every child gets a
Gumbel conditioned on its parent's (Kool et al. stochastic beams), and the
global top-K by Gumbel survives. Keeping the global top-K each step is exact.
Symmetry projection happens during sampling through the masker's per-qudit
transition/mask tables, so every emitted determinant is physical.

The Gumbel noise comes from uniforms in ``[1e-38, 1)``: drawn from a
``torch.Generator`` by default, or given, one array per qudit step of shape
``uniform_shapes(...)[q]`` -- the tests feed the JAX package's own uniforms
here (torch cannot reproduce JAX's threefry stream).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.anqs import ANQS, NEG
from ..ops import bits as bitops


class GumbelSample(NamedTuple):
    words: torch.Tensor  # (K, W)
    log_probs: torch.Tensor  # (K,) renormalized over the returned set
    valid: torch.Tensor  # (K,) bool


def _log1mexp(x):
    """log(1 - exp(x)) for x <= 0, stable at both ends."""
    return torch.where(
        x > -0.693,
        torch.log(-torch.expm1(torch.clamp(x, max=-1e-20))),
        torch.log1p(-torch.exp(x)),
    )


def _log1pexp(x):
    return torch.where(
        x < 18.0,
        torch.log1p(torch.exp(torch.clamp(x, max=18.0))),
        x + torch.exp(-torch.clamp(x, min=18.0)),
    )


def _gumbels_given_max(u, centers, maxes):
    """Children Gumbels conditioned on their max being ``maxes``.

    u (K, D) uniforms; centers (K, D) = children log-probs; maxes (K,) =
    parent Gumbel (reference sample_gumbels_given_max,
    abstract_anqs.py:676-688).
    """
    g = centers - torch.log(-torch.log(u))
    observed = torch.max(g, dim=-1, keepdim=True).values
    v = maxes[:, None] - g + _log1mexp(g - observed)
    cond = maxes[:, None] - torch.clamp(v, min=0.0) - _log1pexp(-torch.abs(v))
    return torch.clamp(torch.nan_to_num(cond, nan=NEG, neginf=NEG), min=NEG)


def _expand_words_dyn(anqs: ANQS, words, parent_idx, cont, q: int):
    """Advance the frontier words: copy parents, write the continuation into
    qudit ``q``'s bit range."""
    return bitops.set_bit_range_dyn(
        words[parent_idx], anqs.qudit_starts[q], anqs.max_width, cont
    )


def _frontier_saturation_step(anqs: ANQS, k_cap: int) -> int:
    """First qudit step whose incoming frontier already holds ``k_cap``
    rows: steps before it run on exactly-sized smaller frontiers."""
    c = 1
    for q in range(anqs.qudit_num):
        if c >= k_cap:
            return q
        c *= 1 << int(anqs.qudit_widths[q])
    return anqs.qudit_num


def uniform_shapes(anqs: ANQS, sample_num: int) -> List[Tuple[int, int]]:
    """Shape of the uniform draw at each qudit step: (incoming rows, D)."""
    q_sat = _frontier_saturation_step(anqs, sample_num)
    shapes, rows = [], 1
    for q in range(anqs.qudit_num):
        shapes.append((rows, anqs.max_dim))
        rows = (
            min(rows * (1 << int(anqs.qudit_widths[q])), sample_num)
            if q < q_sat - 1
            else sample_num
        )
    return shapes


def _uniform(shape, device, generator):
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u, min=1e-38)


@torch.no_grad()
def gumbel_top_k_sample(
    anqs: ANQS,
    sample_num: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
) -> GumbelSample:
    """Exactly the ``sample_num`` distinct most-probable-by-Gumbel states."""
    k_cap = sample_num
    d = anqs.max_dim
    device = anqs.trans_tables.device
    shapes = uniform_shapes(anqs, k_cap)
    q_sat = _frontier_saturation_step(anqs, k_cap)

    words = torch.zeros((1, anqs.n_words), dtype=torch.int64, device=device)
    memo = torch.full((1,), anqs.start_memo_idx, dtype=torch.int64,
                      device=device)
    logp = torch.zeros((1,), dtype=torch.float32, device=device)
    gumbel = torch.zeros((1,), dtype=torch.float32, device=device)
    cap_now = 1
    for q in range(anqs.qudit_num):
        if q < q_sat:
            cap_now = min(cap_now * (1 << int(anqs.qudit_widths[q])), k_cap)
        k_out = cap_now if q < q_sat else k_cap

        u = (
            _uniform(shapes[q], device, generator)
            if uniforms is None
            else torch.as_tensor(uniforms[q], device=device)
        )
        if tuple(u.shape) != shapes[q]:
            raise ValueError(f"step {q}: uniforms {tuple(u.shape)}, "
                             f"expected {shapes[q]}")
        alive = logp > 0.5 * NEG
        cond = anqs.cond_for_qudit_dyn(
            words, q, anqs.mask_tables[q][memo], alive=alive
        )
        child_logp = torch.clamp(logp[:, None] + 2.0 * cond, min=NEG)
        child_gumbel = _gumbels_given_max(u, child_logp, gumbel)
        child_gumbel = torch.where(child_logp > 0.5 * NEG, child_gumbel, NEG)

        top_g, top_idx = torch.topk(child_gumbel.reshape(-1), k_out)
        parent = top_idx // d
        cont = top_idx % d
        words = _expand_words_dyn(anqs, words, parent, cont, q)
        memo = anqs.trans_tables[q][memo[parent], cont]
        logp = child_logp.reshape(-1)[top_idx]
        gumbel = top_g
        if q == q_sat - 1 and cap_now < k_cap:
            # Whole space smaller than k_cap: pad to the fixed shape.
            pad = k_cap - cap_now
            words = torch.cat([words, words.new_zeros((pad, anqs.n_words))])
            memo = torch.cat(
                [memo, memo.new_full((pad,), anqs.start_memo_idx)]
            )
            logp = torch.cat([logp, logp.new_full((pad,), NEG)])
            gumbel = torch.cat([gumbel, gumbel.new_full((pad,), NEG)])

    valid = logp > 0.5 * NEG
    norm = torch.logsumexp(torch.where(valid, logp, NEG), dim=0)
    log_probs = torch.where(valid, logp - norm, NEG)
    return GumbelSample(words=words, log_probs=log_probs, valid=valid)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Counterpart of the reference SamplingConfig
    (reference: .../experiments/calculations/sample.py:8-50); the port
    samples in ``mode='gumbel'`` only."""

    sample_num: int = 10000
    mode: str = "gumbel"


def sample(anqs: ANQS, config: SamplingConfig,
           generator: Optional[torch.Generator] = None,
           uniforms: Optional[Sequence[torch.Tensor]] = None):
    """Unified entry: returns (words, weights, valid, stats dict).

    ``weights`` are the theoretical |psi|^2 frequencies renormalized over
    the returned set."""
    if config.mode != "gumbel":
        raise NotImplementedError(
            f"sampling mode {config.mode!r} is not ported; use 'gumbel'"
        )
    out = gumbel_top_k_sample(anqs, config.sample_num, generator, uniforms)
    weights = torch.where(out.valid, torch.exp(out.log_probs), 0.0)
    stats = {"unique_num": torch.sum(out.valid), "dropped": 0}
    return out.words, weights, out.valid, stats
