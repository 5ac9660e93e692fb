"""Multi-word key ordering: lexicographic sort and compare, binary search,
dedup.

Packed determinants are ``(B, W)`` words (little-endian: word ``W-1`` is most
significant); the canonical order is the unsigned integer order of the full
bit string. The JAX package's ``ops/keys.py``: the sector path searches the
sorted sector (``PauliEngine.local_energy_sector`` without a position map),
the dynamic-membership path sorts the sampled set (``VMC._support_and_eloc``).
"""

from __future__ import annotations

import math

import torch


def lex_less(a, b):
    """Elementwise canonical a < b over the trailing word axis."""
    less = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(less)
    for j in range(a.shape[-1] - 1, -1, -1):
        word_ne = a[..., j] != b[..., j]
        less = torch.where(~decided & word_ne, a[..., j] < b[..., j], less)
        decided = decided | word_ne
    return less


def lex_eq(a, b):
    """Elementwise equality over the trailing word axis."""
    return torch.all(a == b, dim=-1)


def sort_words(words, *extra):
    """Canonically sort rows of ``(B, W)`` words, carrying extras along.

    Returns ``(sorted_words, perm)`` plus the sorted extras, appended. The
    order is stable: one stable sort per word, least significant first (the
    JAX version's ``lax.sort`` over W keys, most significant first).
    """
    perm = torch.arange(words.shape[0], device=words.device)
    for j in range(words.shape[1]):
        order = torch.sort(words[perm, j], stable=True).indices
        perm = perm[order]
    return (words[perm], perm) + tuple(e[perm] for e in extra)


def unique_mask(sorted_words, valid=None):
    """First-occurrence mask over canonically sorted rows.

    ``valid`` rows (if given) must be sorted to the front; invalid rows are
    never marked unique.
    """
    first = torch.ones(sorted_words.shape[0], dtype=torch.bool,
                       device=sorted_words.device)
    first[1:] = ~lex_eq(sorted_words[1:], sorted_words[:-1])
    if valid is not None:
        first = first & valid
    return first


def searchsorted_words(sorted_words, queries):
    """Lower-bound binary search of ``(Q, W)`` queries in sorted ``(B, W)``.

    Returns ``(idx, found)``: ``idx`` is the insertion position and
    ``found`` marks exact matches. Branchless ``ceil(log2(B+1))`` rounds,
    like the JAX package's version.
    """
    b = sorted_words.shape[0]
    q_shape = queries.shape[:-1]
    lo = torch.zeros(q_shape, dtype=torch.int64, device=queries.device)
    hi = torch.full_like(lo, b)
    for _ in range(max(1, math.ceil(math.log2(b + 1)))):
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = lex_less(sorted_words[mid.clamp(0, b - 1)], queries)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    at = sorted_words[lo.clamp(0, b - 1)]
    found = (lo < b) & lex_eq(at, queries)
    return lo, found


def rank_in_group(group):
    """Stable 0-based rank of each element among the elements of equal
    ``group`` value, in index order (JAX ``parallel/dist_membership.py``
    ``_rank_in_group``): a stable sort by group, then position less the
    start of its run."""
    n = group.shape[0]
    iota = torch.arange(n, device=group.device)
    sorted_g, sorted_i = torch.sort(group, stable=True)
    run_start = torch.ones(n, dtype=torch.bool, device=group.device)
    run_start[1:] = sorted_g[1:] != sorted_g[:-1]
    start = torch.cummax(torch.where(run_start, iota, 0), 0).values
    rank = torch.empty_like(iota)
    rank[sorted_i] = iota - start
    return rank
