"""Fixed-capacity ancestral samplers: exact Gumbel top-k and multinomial.

Counterpart of the JAX package's ``sampling/sampler.py``: a frontier of at
most K = ``sample_num`` rows advances one qudit per step. Symmetry
projection happens during sampling through the masker's per-qudit
transition/mask tables, so every emitted determinant is physical.

* ``gumbel_top_k_sample`` (reference sample_indices_gumbel,
  abstract_anqs.py:676-818): every child gets a Gumbel conditioned on its
  parent's (Kool et al. stochastic beams), and the global top-K by Gumbel
  survives. Keeping the global top-K each step is exact. The Gumbel noise
  comes from uniforms in ``[1e-38, 1)``: drawn from a ``torch.Generator`` by
  default, or given, one array per qudit step of shape
  ``uniform_shapes(...)[q]`` -- the tests feed the JAX package's own
  uniforms here (torch cannot reproduce JAX's threefry stream).
* ``multinomial_sample`` (reference sample_mult_new_new,
  abstract_anqs.py:557-591): occupation counts of a ``budget``-draw
  multinomial, split over each row's children by binomial bisection of the
  masked softmax, counts carried in float64. The K largest child counts
  survive a step; the rest are reported as ``dropped``. The binomial draw
  is ``torch.binomial`` with the caller's generator, or a given
  ``draw(counts, p)`` (the tests' deterministic split).

With a data-parallel ``mesh`` (``parallel/mesh.py``), ``gumbel_top_k_sample``
shards the full-capacity frontier (JAX ``sampler.py:152-214``): from the
saturation step on, each rank runs the network on its row block of the
frontier, with its rows of the step's (K, D) uniforms, drawn whole from the
generator that every rank seeds alike (so the stream is the single-process
one); the children's log-probabilities and Gumbels are all-gathered, the
top-K, the expansion and the memo run replicated, and the frontier stays
whole on every rank. Multinomial sampling runs replicated, as in JAX.

On a transformer without ``spin_flip_abs``, a Gumbel draw with no mesh
decodes incrementally (``ANQS.decode_cache``): at each qudit the main
decoder runs the new position of each frontier row alone, against each
layer's keys and values of the earlier positions, which follow the
survivors' parents after each top-k. Every other draw recomputes every
position of every row at each qudit (``ANQS.cond_for_qudit_dyn``).

Both select each step's survivors with ``topk_impl``: 'lax' (``torch.topk``
on the Gumbel keys, a stable sort on the counts) or 'bisect'
(``ops.topk.exact_top_k``, ``jax.lax.top_k``'s order, -0.0 below 0.0,
by a stable sort of order-preserving integer images; JAX
``_select_top_k``, ``sampling/sampler.py:112-121``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.anqs import ANQS, NEG
from ..ops import bits as bitops
from ..ops.topk import exact_top_k
from ..parallel.mesh import replicate, shard_rows

TOPK_IMPLS = ("lax", "bisect")


class GumbelSample(NamedTuple):
    words: torch.Tensor  # (K, W)
    log_probs: torch.Tensor  # (K,) renormalized over the returned set
    valid: torch.Tensor  # (K,) bool


class MultinomialSample(NamedTuple):
    words: torch.Tensor  # (K, W)
    counts: torch.Tensor  # (K,) int64
    valid: torch.Tensor  # (K,) bool
    dropped: torch.Tensor  # () int64: counts lost to capacity truncation


# A multinomial budget above this is refused: the JAX package keeps counts
# in int32 (the float64 bisection itself is exact to 2^53).
MAX_BUDGET = 1 << 30


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


def _top_k(x, k: int):
    """The ``k`` largest of ``x`` and their indices, ties to the lower
    index (the order of ``jax.lax.top_k``)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def _select_top_k(x, k: int, impl: str):
    """A step's survivors: the ``k`` largest of the flat candidates ``x``
    by ``impl`` (``TOPK_IMPLS``); raises ``ValueError`` on another."""
    if impl == "bisect":
        return exact_top_k(x, k)
    if impl != "lax":
        raise ValueError(f"topk_impl={impl!r}: expected one of {TOPK_IMPLS}")
    if x.is_floating_point():
        return torch.topk(x, k)
    return _top_k(x, k)


@torch.no_grad()
def gumbel_top_k_sample(
    anqs: ANQS,
    sample_num: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[torch.Tensor]] = None,
    topk_impl: str = "lax",
    mesh=None,
) -> GumbelSample:
    """Exactly the ``sample_num`` distinct most-probable-by-Gumbel states;
    ``mesh``: shard the full-capacity frontier (module docstring)."""
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
    cache = anqs.decode_cache(k_cap) if mesh is None else None
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
        rows = (words, memo, logp, gumbel, u)
        if q >= q_sat:
            rows = shard_rows(rows, mesh)
        b_words, b_memo, b_logp, b_gumbel, b_u = rows
        if cache is None:
            cond = anqs.cond_for_qudit_dyn(
                b_words, q, anqs.mask_tables[q][b_memo],
                alive=b_logp > 0.5 * NEG,
            )
        else:
            cond = anqs.cond_for_qudit_cached(
                cache, b_words, q, anqs.mask_tables[q][b_memo],
                alive=b_logp > 0.5 * NEG,
            )
        child_logp = torch.clamp(b_logp[:, None] + 2.0 * cond, min=NEG)
        child_gumbel = _gumbels_given_max(b_u, child_logp, b_gumbel)
        child_gumbel = torch.where(child_logp > 0.5 * NEG, child_gumbel, NEG)
        if q >= q_sat:
            child_logp, child_gumbel = replicate((child_logp, child_gumbel),
                                                 mesh, k_cap)

        top_g, top_idx = _select_top_k(child_gumbel.reshape(-1), k_out,
                                       topk_impl)
        parent = top_idx // d
        cont = top_idx % d
        words = _expand_words_dyn(anqs, words, parent, cont, q)
        memo = anqs.trans_tables[q][memo[parent], cont]
        logp = child_logp.reshape(-1)[top_idx]
        gumbel = top_g
        if cache is not None and q + 1 < anqs.qudit_num:
            cache.advance(parent, q)
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


def _binomial_bisect(counts, probs, k_bits: int, generator=None,
                     draw: Optional[Callable] = None):
    """Split integer ``counts`` (K,) over D = 2**k_bits slots ~ multinomial
    of ``probs`` (K, D), by ``k_bits`` levels of binomial halving.

    Counts ride in float64, so draws stay exact up to 2^53. The
    deterministic splits (p = 0 or 1) bypass the draw: the JAX package's
    binomial loses counts at p == 1, so it special-cases them, and so does
    this port."""
    if draw is None:
        def draw(n, p):
            return torch.binomial(n, p, generator=generator)
    k_cap = counts.shape[0]
    counts_l = counts[:, None].to(torch.float64)  # (K, 1)
    blocks = probs[:, None, :]  # (K, blocks, block_size)
    for _ in range(k_bits):
        half = blocks.shape[-1] // 2
        left, right = blocks[..., :half], blocks[..., half:]
        pl = torch.sum(left, dim=-1)
        pr = torch.sum(right, dim=-1)
        ratio = torch.nan_to_num(pl / torch.clamp(pl + pr, min=1e-38),
                                 nan=0.0)
        safe_ratio = torch.clamp(ratio, 1e-7, 1.0 - 1e-7).to(torch.float64)
        n_left = torch.nan_to_num(
            draw(counts_l.expand_as(safe_ratio).contiguous(), safe_ratio),
            nan=0.0)
        n_left = torch.where(ratio >= 1.0 - 1e-9, counts_l, n_left)
        n_left = torch.where(ratio <= 1e-9, 0.0, n_left)
        n_left = torch.where(counts_l > 0, n_left, 0.0)
        counts_l = torch.stack([n_left, counts_l - n_left],
                               dim=-1).reshape(k_cap, -1)
        blocks = torch.stack([left, right], dim=2).reshape(k_cap, -1, half)
    return counts_l.to(torch.int64)  # (K, D)


@torch.no_grad()
def _multinomial_core(anqs: ANQS, k_cap: int, budget: int, generator=None,
                      draw: Optional[Callable] = None,
                      topk_impl: str = "lax") -> MultinomialSample:
    """``multinomial_sample`` without the budget check. Capacity-scheduled
    like ``gumbel_top_k_sample``: exactly-sized frontiers until the
    frontier saturates at ``k_cap``, then ``k_cap`` rows a step."""
    d = anqs.max_dim
    k_bits = int(d).bit_length() - 1
    device = anqs.trans_tables.device
    q_sat = _frontier_saturation_step(anqs, k_cap)

    words = torch.zeros((1, anqs.n_words), dtype=torch.int64, device=device)
    memo = torch.full((1,), anqs.start_memo_idx, dtype=torch.int64,
                      device=device)
    counts = torch.full((1,), int(budget), dtype=torch.int64, device=device)
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    cap_now = 1
    for q in range(anqs.qudit_num):
        if q < q_sat:
            cap_now = min(cap_now * (1 << int(anqs.qudit_widths[q])), k_cap)
        k_out = cap_now if q < q_sat else k_cap
        alive = counts > 0
        cond = anqs.cond_for_qudit_dyn(
            words, q, anqs.mask_tables[q][memo], alive=alive
        )
        probs = torch.where(cond > 0.5 * NEG,
                            torch.exp(2.0 * torch.clamp(cond, min=-40.0)),
                            0.0)
        child = _binomial_bisect(counts, probs, k_bits, generator, draw)
        child = torch.where(counts[:, None] > 0, child, 0).reshape(-1)
        top_c, top_idx = _select_top_k(child, k_out, topk_impl)
        dropped = dropped + (torch.sum(child) - torch.sum(top_c))
        parent = top_idx // d
        cont = top_idx % d
        words = _expand_words_dyn(anqs, words, parent, cont, q)
        memo = anqs.trans_tables[q][memo[parent], cont]
        counts = top_c
        if q == q_sat - 1 and cap_now < k_cap:
            pad = k_cap - cap_now
            words = torch.cat([words, words.new_zeros((pad, anqs.n_words))])
            memo = torch.cat(
                [memo, memo.new_full((pad,), anqs.start_memo_idx)]
            )
            counts = torch.cat([counts, counts.new_zeros((pad,))])
    return MultinomialSample(words=words, counts=counts, valid=counts > 0,
                             dropped=dropped)


def multinomial_sample(anqs: ANQS, sample_num: int,
                       budget: Optional[int] = None, generator=None,
                       draw: Optional[Callable] = None,
                       topk_impl: str = "lax") -> MultinomialSample:
    """Occupation-count sampling of ``budget`` draws (default
    ``sample_num``) with capacity K = ``sample_num``."""
    budget = int(budget if budget is not None else sample_num)
    if budget > MAX_BUDGET:
        raise ValueError("multinomial budget > 2^30 overflows int32 counts")
    return _multinomial_core(anqs, sample_num, budget, generator, draw,
                             topk_impl)


def sample_precisely(anqs: ANQS, sample_num: int, target_unique: int,
                     max_budget: int = 1 << 27, growth: float = 4.0,
                     generator=None, draw: Optional[Callable] = None):
    """Adaptive multinomial budget: grow it by ``growth`` until at least
    ``min(target_unique, sample_num)`` unique states are drawn or it reaches
    ``max_budget`` (reference sample_precisely,
    calculations/sample.py:62-75). Returns (MultinomialSample, budget)."""
    budget = sample_num
    while True:
        out = _multinomial_core(anqs, sample_num, budget, generator, draw)
        n_unique = int(torch.sum(out.valid))
        if n_unique >= min(target_unique, sample_num) or budget >= max_budget:
            return out, budget
        budget = min(int(budget * growth), max_budget)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Counterpart of the reference SamplingConfig
    (reference: .../experiments/calculations/sample.py:8-50)."""

    sample_num: int = 10000
    mode: str = "gumbel"  # 'gumbel' (unique top-k) | 'multinomial'
    budget: Optional[int] = None  # multinomial budget (default sample_num)
    topk_impl: str = "lax"  # 'lax' | 'bisect' (ops.topk.exact_top_k)

    def __post_init__(self):
        if self.topk_impl not in TOPK_IMPLS:
            raise ValueError(f"topk_impl={self.topk_impl!r}: expected one "
                             f"of {TOPK_IMPLS}")


def sample(anqs: ANQS, config: SamplingConfig,
           generator: Optional[torch.Generator] = None,
           uniforms: Optional[Sequence[torch.Tensor]] = None,
           budget: Optional[int] = None, draw: Optional[Callable] = None,
           mesh=None):
    """Unified entry: returns (words, weights, valid, stats dict).

    ``weights`` are normalized frequencies: the theoretical |psi|^2
    renormalized over the returned set in Gumbel mode, the empirical
    counts / total in multinomial mode. ``budget`` overrides the
    multinomial budget (the trainer's adaptive ``sample_precisely``);
    ``uniforms`` (Gumbel) and ``draw`` (multinomial) replace the
    generator's draws. ``mesh`` shards the Gumbel frontier (module
    docstring); the returned set is whole on every rank."""
    if config.mode == "gumbel":
        out = gumbel_top_k_sample(anqs, config.sample_num, generator,
                                  uniforms, config.topk_impl, mesh)
        weights = torch.where(out.valid, torch.exp(out.log_probs), 0.0)
        stats = {"unique_num": torch.sum(out.valid), "dropped": 0}
        return out.words, weights, out.valid, stats
    if config.mode == "multinomial":
        if budget is None:
            out = multinomial_sample(anqs, config.sample_num, config.budget,
                                     generator, draw, config.topk_impl)
        else:
            out = _multinomial_core(anqs, config.sample_num, int(budget),
                                    generator, draw, config.topk_impl)
        total = torch.clamp(torch.sum(out.counts), min=1)
        weights = out.counts.to(torch.float32) / total
        stats = {"unique_num": torch.sum(out.valid), "dropped": out.dropped}
        return out.words, weights, out.valid, stats
    raise ValueError(config.mode)
