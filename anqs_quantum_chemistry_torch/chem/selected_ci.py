"""Selected CI: support expansion and restricted diagonalisation, on the host.

Counterpart of the JAX package's ``chem/selected_ci.py`` (numpy and scipy
there too). A support of determinants (an ANQS sample, a CISD support, or
just the HF determinant) grows by the single and double excitations of its
largest-|coef| determinants; H restricted to it is built from the integrals
(``fci.sparse_hamiltonian``, the C++ builder above 512 determinants) and
its lowest state found by Lanczos (``eigsh``); the rounds repeat until the
energy gain falls below a tolerance. ``HeatBathTable`` and
``expand_support_heatbath`` screen the doubles by the size of their
element (the heat-bath rule), for orbital counts where the unscreened
doubles are too many. ``truncate_by_weight`` cuts a vector to its top-k
determinants: the distillation target of ``experiments/support_ci.py``.

Determinants are Python ints (or uint64) on the host: bit p set =
spin-orbital p occupied, alpha on even bits, beta on odd. They become
packed int64 words only through ``optim.pretrain.pack_dets``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse.linalg as spla

from . import fci as fci_mod


def restricted_ground_state(dets: Sequence[int], h1: np.ndarray,
                            v: np.ndarray,
                            e_nuc: float = 0.0) -> Tuple[float, np.ndarray]:
    """Lowest state of H restricted to ``dets``: (energy + ``e_nuc``, unit
    coefficients in ascending determinant order; their global sign is
    Lanczos's)."""
    dets = sorted(int(d) for d in dets)
    h = fci_mod.sparse_hamiltonian(dets, h1, v)
    if h.shape[0] == 1:
        return float(h[0, 0]) + e_nuc, np.ones(1)
    vals, vecs = spla.eigsh(h, k=1, which="SA")
    return float(vals[0]) + e_nuc, vecs[:, 0]


def expand_support(dets: Sequence[int], coef: np.ndarray, n_so: int,
                   n_parents: int, max_new: Optional[int] = None) -> list:
    """Sorted union of ``dets`` with all in-sector singles and doubles of
    its ``n_parents`` largest-|coef| determinants. ``max_new`` caps the
    determinants added, taken in the order the parents (by |coef|) and
    their excitations (``fci.excitations_in_sector``) produce them."""
    dets = [int(d) for d in dets]
    order = np.argsort(-np.abs(np.asarray(coef, np.float64)))
    have = set(dets)
    new = []
    for i in order[: int(n_parents)]:
        for x in fci_mod.excitations_in_sector(dets[i], n_so).tolist():
            if x not in have:
                have.add(x)
                new.append(x)
                if max_new is not None and len(new) >= max_new:
                    return sorted(set(dets) | set(new))
    return sorted(have)


def selected_ci(seed_dets: Sequence[int], h1: np.ndarray, v: np.ndarray,
                e_nuc: float = 0.0, n_parents: int = 500, rounds: int = 4,
                tol: float = 2e-4, max_new: Optional[int] = None,
                grow_parents: float = 2.0,
                on_round: Optional[Callable] = None
                ) -> Tuple[float, list, np.ndarray]:
    """Iterative selected CI from ``seed_dets``: (energy, sorted
    determinants, coefficients). Each round diagonalises the support,
    expands it by ``expand_support`` from the top ``n_parents`` (times
    ``grow_parents`` each round) and diagonalises again; it stops after
    ``rounds``, when no determinant is added, or when a round gains less
    than ``tol`` Ha. ``on_round`` gets each round's ``round``, ``size``,
    ``energy``, ``gain`` and ``seconds``."""
    dets = sorted(set(int(d) for d in seed_dets))
    energy, coef = restricted_ground_state(dets, h1, v, e_nuc)
    n_par = n_parents
    for rnd in range(rounds):
        t0 = time.perf_counter()
        bigger = expand_support(dets, coef, h1.shape[0], n_par, max_new)
        if len(bigger) == len(dets):
            break
        e_new, c_new = restricted_ground_state(bigger, h1, v, e_nuc)
        if on_round is not None:
            on_round({"round": rnd, "size": len(bigger), "energy": e_new,
                      "gain": energy - e_new,
                      "seconds": time.perf_counter() - t0})
        dets, coef, gained = bigger, c_new, energy - e_new
        energy = e_new
        n_par = int(n_par * grow_parents)
        if gained < tol:
            break
    return energy, dets, coef


class HeatBathTable:
    """For every occupied pair (i, j), i > j, the targets (a, b), a < b, of
    its double excitations with the same spins, sorted by the magnitude of
    their element |v[b,a,j,i] - v[b,a,i,j]| (which does not depend on the
    rest of the determinant), zeros dropped: ``pairs[(i, j)] = (mag, a,
    b)``. The heat-bath rule (Holmes et al. 2016) then selects the doubles
    of a parent above a threshold by a prefix of each list."""

    def __init__(self, h1: np.ndarray, v: np.ndarray):
        n = h1.shape[0]
        self.n_so = n
        spin = np.arange(n) % 2
        self.pairs = {}
        for j in range(n):
            for i in range(j + 1, n):
                si = spin[i]
                if si == spin[j]:
                    cand = [(a, b)
                            for a in range(n) if spin[a] == si
                            for b in range(a + 1, n) if spin[b] == si]
                else:
                    cand = [(min(a, b), max(a, b))
                            for a in range(n) if spin[a] == 0
                            for b in range(n) if spin[b] == 1]
                a_arr = np.array([a for a, _ in cand], np.int16)
                b_arr = np.array([b for _, b in cand], np.int16)
                mag = np.abs(v[b_arr, a_arr, j, i] - v[b_arr, a_arr, i, j])
                order = np.argsort(-mag)
                keep = mag[order] > 0.0
                self.pairs[(i, j)] = (mag[order][keep], a_arr[order][keep],
                                      b_arr[order][keep])


def expand_support_heatbath(dets: Sequence[int], coef: np.ndarray,
                            table: HeatBathTable, eps: float,
                            n_parents: int,
                            n_singles_parents: Optional[int] = None,
                            max_new: Optional[int] = None) -> list:
    """Sorted union of ``dets`` with, for each of its top ``n_parents`` by
    |coef|, every double whose |element x coef| >= ``eps``, and all singles
    of the top ``n_singles_parents`` (default ``n_parents``; singles are
    not screened). With ``eps`` 0 it adds every double of nonzero element,
    a subset of ``expand_support``'s. ``max_new`` stops before a parent
    once that many determinants were added."""
    n_so = table.n_so
    dets = [int(d) for d in dets]
    c = np.abs(np.asarray(coef, np.float64))
    order = np.argsort(-c)
    if n_singles_parents is None:
        n_singles_parents = n_parents
    have = set(dets)
    new = []

    def add(x):
        if x not in have:
            have.add(x)
            new.append(x)

    for rank, pi in enumerate(order[: int(n_parents)]):
        y = dets[pi]
        if max_new is not None and len(new) >= max_new:
            break
        occ = [p for p in range(n_so) if (y >> p) & 1]
        if rank < n_singles_parents:
            for s in (0, 1):
                for p in occ:
                    if p % 2 != s:
                        continue
                    for q in range(s, n_so, 2):
                        if not (y >> q) & 1:
                            add(y ^ (1 << p) | (1 << q))
        thresh = eps / max(c[pi], 1e-300)
        for ji in range(len(occ)):
            for ii in range(ji + 1, len(occ)):
                j, i = occ[ji], occ[ii]
                mag, a_arr, b_arr = table.pairs[(i, j)]
                k = np.searchsorted(-mag, -thresh, side="right")
                base = y ^ (1 << i) ^ (1 << j)
                for a, b in zip(a_arr[:k].tolist(), b_arr[:k].tolist()):
                    if not (y >> a) & 1 and not (y >> b) & 1:
                        add(base | (1 << a) | (1 << b))
    return sorted(have)


def truncate_by_weight(dets: Sequence[int], coef: np.ndarray,
                       k: int) -> Tuple[list, np.ndarray]:
    """The top ``k`` determinants by |coef|, in ascending order, with their
    coefficients renormalised: a compact distillation target."""
    coef = np.asarray(coef, np.float64)
    order = np.argsort(-np.abs(coef))[: int(k)]
    sel = sorted(range(len(order)), key=lambda i: int(dets[order[i]]))
    idx = order[sel]
    c = coef[idx]
    return [int(dets[i]) for i in idx], c / np.linalg.norm(c)
