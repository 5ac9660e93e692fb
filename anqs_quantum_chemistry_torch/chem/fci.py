"""Sector enumeration, the exact sector ground state from the Pauli form,
and the Hamiltonian over a determinant list from the integrals.

``sector_determinants`` is the JAX package's ``chem/fci.py`` enumeration as a
sorted uint64 array. ``sector_hamiltonian`` builds the sparse Hamiltonian of
the (N_alpha, N_beta) sector straight from the grouped Pauli terms, in
float64 -- the oracle that ``chem/molecule.py`` uses to fill in an FCI
energy a molecule file lacks, and ``chip_smoke.py`` uses as its Rayleigh
quotient reference. ``cisd_ground_state`` diagonalises H over the HF
determinant and its single and double excitations (JAX
``fci.cisd_ground_state``), from the integrals or from the Pauli form: the
target of supervised pretraining (``optim/pretrain.py``).

``fci_ground_state`` diagonalises H over the whole sector from the
integrals, and ``mp2_energy`` is the spin-orbital MP2 correlation energy
(both JAX ``chem/fci.py``), for the molecule build (``chem/molecule.py``).

``sparse_hamiltonian(dets, h1, v)`` builds H over any determinant list from
the spin-orbital integrals by the Slater-Condon rules (JAX
``fci.sparse_hamiltonian``), as selected CI needs it (``chem/
selected_ci.py``): H = sum h1[p,q] a+_p a_q + 1/2 sum v[p,q,r,s] a+_p a+_q
a_s a_r with ``v[p,q,r,s] = <pq|rs>``. It stores only the nonzero
elements, where the Pauli form's dense (N, M) tables would take 3.2 GB at
Li2O's 131,072-determinant target. A sorted list of more than 512
determinants goes through the C++ builder (``chem/native.py``); the
Python loop ``sparse_hamiltonian_plain`` is the readable oracle that the
tests hold it to.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from .jw import PauliHamiltonian, words_to_ints

_U = np.uint64

# The largest (N_alpha, N_beta) sector this module builds and diagonalises:
# 2^16 determinants, the JAX ``VMCConfig.sector_membership_max_dets``
# default (the trainer's own limit is that ``VMCConfig`` field).
SECTOR_MAX_DETS = 1 << 16


def sector_determinants(n_so: int, n_alpha: int, n_beta: int) -> np.ndarray:
    """All determinants with the given alpha/beta electron counts (alpha on
    even qubits, beta on odd), sorted, as uint64."""
    alphas = [
        sum(1 << (2 * o) for o in occ)
        for occ in itertools.combinations(range(n_so // 2), n_alpha)
    ]
    betas = [
        sum(1 << (2 * o + 1) for o in occ)
        for occ in itertools.combinations(range(n_so // 2), n_beta)
    ]
    a = np.asarray(alphas, dtype=_U)
    b = np.asarray(betas, dtype=_U)
    return np.sort((a[:, None] | b[None, :]).reshape(-1))


def random_sector_dets(n_orbitals: int, n_alpha: int, n_beta: int,
                       count: int, rng: np.random.Generator) -> np.ndarray:
    """``count`` random determinants of the (N_alpha, N_beta) sector as
    uint64 (alpha on even qubits, beta on odd; up to 32 orbitals): each
    row's occupied orbitals of each spin are drawn by ``rng`` without
    replacement."""
    dets = np.zeros(count, _U)
    for spin, n_occ in ((0, n_alpha), (1, n_beta)):
        occ = np.argsort(rng.random((count, n_orbitals)), axis=1)[:, :n_occ]
        dets |= np.bitwise_or.reduce(
            _U(1) << (_U(2) * occ.astype(_U) + _U(spin)), axis=1)
    return dets


def _parity64(x: np.ndarray) -> np.ndarray:
    """popcount(x) mod 2 of uint64 values."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> _U(s))
    return x & _U(1)


def sector_matrix_elements(ham: PauliHamiltonian, dets: np.ndarray,
                           row_chunk: int = 2048) -> np.ndarray:
    """(N, M) float64 elements <x ^ A_m | H | x> for uint64 ``dets``."""
    b = words_to_ints(ham.b_words)
    w = np.asarray(ham.weights, np.float64)
    starts = np.asarray(ham.group_starts[:-1], np.int64)
    out = np.empty((len(dets), ham.n_groups), np.float64)
    for r in range(0, len(dets), row_chunk):
        x = dets[r:r + row_chunk]
        par = _parity64(x[:, None] & b[None, :]).astype(np.float64)
        out[r:r + row_chunk] = np.add.reduceat(
            (1.0 - 2.0 * par) * w[None, :], starts, axis=1
        )
    return out


def sector_hamiltonian(ham: PauliHamiltonian, dets: np.ndarray):
    """Sparse float64 H over the sorted uint64 ``dets`` (rows and columns
    in ``dets`` order); partners outside ``dets`` are dropped."""
    n = len(dets)
    me = sector_matrix_elements(ham, dets)
    a = words_to_ints(ham.a_masks)
    partner = dets[:, None] ^ a[None, :]
    idx = np.clip(np.searchsorted(dets, partner), 0, n - 1)
    found = dets[idx] == partner
    cols = np.broadcast_to(np.arange(n)[:, None], idx.shape)
    h = scipy.sparse.csr_matrix(
        (me[found], (idx[found], cols[found])), shape=(n, n)
    )
    return h + ham.constant * scipy.sparse.identity(n, format="csr")


def sector_ground_energy(ham: PauliHamiltonian, n_alpha: int,
                         n_beta: int) -> float:
    """Lowest eigenvalue of H in the (n_alpha, n_beta) sector."""
    dets = sector_determinants(ham.qubit_num, n_alpha, n_beta)
    h = sector_hamiltonian(ham, dets)
    if h.shape[0] <= 256:
        return float(np.linalg.eigvalsh(h.toarray())[0])
    w = scipy.sparse.linalg.eigsh(h, k=1, which="SA", tol=1e-12)[0]
    return float(w[0])


def excitations_in_sector(det: int, n_so: int) -> np.ndarray:
    """All single and double excitations of ``det`` that keep its alpha
    (even qubit) and beta (odd qubit) electron counts, as uint64, in the
    order of JAX ``fci._excitations_in_sector``: singles of each spin,
    then same-spin alpha, opposite-spin and same-spin beta doubles, each
    occupied choice (lexicographic) major over each virtual choice."""
    bits = (int(det) >> np.arange(n_so)) & 1
    spin = np.arange(n_so) % 2
    occ = [np.flatnonzero((bits == 1) & (spin == s)) for s in (0, 1)]
    virt = [np.flatnonzero((bits == 0) & (spin == s)) for s in (0, 1)]
    one = _U(1)
    d = _U(det)

    def masks(orbs):
        return one << orbs.astype(_U)

    def pair_masks(orbs):
        i, j = np.triu_indices(len(orbs), 1)
        return masks(orbs[i]) | masks(orbs[j])

    def cross_masks(a, b):
        return (masks(a)[:, None] | masks(b)[None, :]).reshape(-1)

    out = []
    for s in (0, 1):
        out.append(((d ^ masks(occ[s]))[:, None]
                    | masks(virt[s])[None, :]).reshape(-1))
    for occ_m, virt_m in (
            (pair_masks(occ[0]), pair_masks(virt[0])),
            (cross_masks(occ[0], occ[1]), cross_masks(virt[0], virt[1])),
            (pair_masks(occ[1]), pair_masks(virt[1]))):
        out.append(((d ^ occ_m)[:, None] | virt_m[None, :]).reshape(-1))
    return np.concatenate(out)


def _occ_list(det: int, n_so: int):
    return [p for p in range(n_so) if (det >> p) & 1]


def _parity_between(det: int, p: int, q: int) -> int:
    """(-1)^(number of occupied orbitals strictly between p and q)."""
    lo, hi = (p, q) if p < q else (q, p)
    mask = ((1 << hi) - 1) & ~((1 << (lo + 1)) - 1)
    return -1 if bin(det & mask).count("1") % 2 else 1


def _double_parity(det: int, i: int, j: int, a: int, b: int) -> int:
    """Sign of <D'| a+_a a+_b a_j a_i |D> (apply a_i, a_j, a+_b, a+_a)."""
    sign = 1
    d = det
    for o in (i, j):
        below = bin(d & ((1 << o) - 1)).count("1")
        sign *= -1 if below % 2 else 1
        d &= ~(1 << o)
    for o in (b, a):
        below = bin(d & ((1 << o) - 1)).count("1")
        sign *= -1 if below % 2 else 1
        d |= 1 << o
    return sign


def diagonal_energy(det: int, h1: np.ndarray, v: np.ndarray) -> float:
    occ = _occ_list(det, h1.shape[0])
    e = sum(h1[p, p] for p in occ)
    for p in occ:
        for q in occ:
            if p != q:
                e += 0.5 * (v[p, q, p, q] - v[p, q, q, p])
    return float(e)


def matrix_element(det_a: int, det_b: int, h1: np.ndarray,
                   v: np.ndarray) -> float:
    """<det_a | H | det_b> by the Slater-Condon rules."""
    diff = det_a ^ det_b
    n_diff = bin(diff).count("1")
    if n_diff == 0:
        return diagonal_energy(det_b, h1, v)
    if n_diff == 2:
        p = (diff & det_b).bit_length() - 1  # occupied in b only
        q = (diff & det_a).bit_length() - 1  # occupied in a only
        sign = _parity_between(det_b, p, q)
        val = h1[q, p]
        for r in _occ_list(det_b & det_a, h1.shape[0]):
            val += v[q, r, p, r] - v[q, r, r, p]
        return float(sign * val)
    if n_diff == 4:
        rem = diff & det_b
        add = diff & det_a
        i = rem.bit_length() - 1
        rem &= ~(1 << i)
        j = rem.bit_length() - 1
        a = add.bit_length() - 1
        add &= ~(1 << a)
        b = add.bit_length() - 1
        # i > j and a > b as extracted; the parity is simulated in the
        # same order, so the element does not depend on it.
        sign = _double_parity(det_b, j, i, b, a)
        return float(sign * (v[b, a, j, i] - v[b, a, i, j]))
    return 0.0


def sparse_hamiltonian_plain(dets, h1: np.ndarray,
                             v: np.ndarray) -> scipy.sparse.csr_matrix:
    """Sparse float64 H over ``dets`` (rows and columns in list order, any
    order) from the integrals: each determinant's in-sector single and
    double excitations looked up in the list, one Python loop (JAX
    ``fci.sparse_hamiltonian``'s own path)."""
    n_so = h1.shape[0]
    dets = [int(d) for d in dets]
    index = {d: i for i, d in enumerate(dets)}
    rows, cols, vals = [], [], []
    for i, det in enumerate(dets):
        rows.append(i)
        cols.append(i)
        vals.append(diagonal_energy(det, h1, v))
        for other in excitations_in_sector(det, n_so).tolist():
            j = index.get(other)
            if j is None or j <= i:
                continue
            el = matrix_element(other, det, h1, v)
            if el != 0.0:
                rows += [i, j]
                cols += [j, i]
                vals += [el, el]
    n = len(dets)
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))


def sparse_hamiltonian(dets, h1: np.ndarray,
                       v: np.ndarray) -> scipy.sparse.csr_matrix:
    """Sparse float64 H over ``dets`` from the integrals: the C++ builder
    (``native.sparse_hamiltonian_native``) for a strictly ascending list of
    more than 512 determinants, else ``sparse_hamiltonian_plain`` (JAX's
    rule). The builder's failure to compile raises: it does not fall back
    to the Python loop, which would take hours at 131k determinants."""
    d = np.asarray([int(x) for x in dets], np.uint64)
    if len(d) > 512 and bool(np.all(d[1:] > d[:-1])):
        from .native import sparse_hamiltonian_native

        rows, cols, vals = sparse_hamiltonian_native(d, h1, v)
        return scipy.sparse.csr_matrix((vals, (rows, cols)),
                                       shape=(len(d), len(d)))
    return sparse_hamiltonian_plain(d.tolist(), h1, v)


def _ground_state(h):
    """(lowest eigenvalue, its eigenvector) of a sparse symmetric ``h``, as
    JAX ``fci._ground_state`` solves it: dense ``eigh`` up to 256 rows,
    ``eigsh(k=1, which='SA')`` above."""
    if h.shape[0] == 1:
        return float(h[0, 0]), np.ones(1)
    if h.shape[0] <= 256:
        w, u = np.linalg.eigh(h.toarray())
        return float(w[0]), u[:, 0]
    w, u = scipy.sparse.linalg.eigsh(h, k=1, which="SA")
    return float(w[0]), u[:, 0]


def fci_ground_state(h1: np.ndarray, v: np.ndarray, n_alpha: int,
                     n_beta: int, e_nuc: float = 0.0):
    """In-sector FCI from the integrals (JAX ``fci.fci_ground_state``):
    (energy, sorted uint64 determinants, coefficients, ipr), with H over
    the whole (N_alpha, N_beta) sector from ``sparse_hamiltonian`` and
    ipr = sum c^4, the inverse participation ratio."""
    dets = sector_determinants(h1.shape[0], n_alpha, n_beta)
    energy, coef = _ground_state(sparse_hamiltonian(dets, h1, v))
    return energy + e_nuc, dets, coef, float(np.sum(coef ** 4))


def mp2_energy(h1: np.ndarray, v: np.ndarray, mo_energy_so: np.ndarray,
               hf_det: int) -> float:
    """MP2 correlation energy in spin-orbital form (JAX
    ``fci.mp2_energy``): 1/4 sum_{ijab} (<ab|ij> - <ab|ji>)^2 / (e_i + e_j
    - e_a - e_b) over occupied i, j and virtual a, b, terms with a zero
    numerator left out, as JAX's loop leaves them out."""
    n_so = h1.shape[0]
    occ = np.asarray(_occ_list(int(hf_det), n_so), np.int64)
    virt = np.setdiff1d(np.arange(n_so), occ)
    vv = v[np.ix_(virt, virt, occ, occ)]  # <ab|ij>
    num = vv - vv.transpose(0, 1, 3, 2)
    e = np.asarray(mo_energy_so, np.float64)
    denom = (e[occ][None, None, :, None] + e[occ][None, None, None, :]
             - e[virt][:, None, None, None] - e[virt][None, :, None, None])
    nz = num != 0.0
    return float(0.25 * np.sum(num[nz] ** 2 / denom[nz]))


def cisd_ground_state(ham_or_h1, *args):
    """CISD from the HF determinant: (energy, sorted uint64 determinants,
    float64 coefficients) of the lowest state of H over the determinant
    and its in-sector single and double excitations (JAX
    ``fci.cisd_ground_state``). Two forms:

    - ``cisd_ground_state(h1, v, hf_det, e_nuc=0.0)``, JAX's: H from the
      spin-orbital integrals (``sparse_hamiltonian``: the C++ builder above
      512 determinants), plus ``e_nuc``. The entry points use it wherever
      the molecule carries its integrals (C2H4's 29,593 determinants).
    - ``cisd_ground_state(ham, hf_det)`` with a ``PauliHamiltonian``: H
      from the Pauli form (``sector_hamiltonian``), whose constant plays
      the part of ``e_nuc``; for a molecule packaged without integrals
      (N2). Its dense (N, M) tables grow with the group count, so it does
      not reach C2H4.
    """
    pauli = isinstance(ham_or_h1, PauliHamiltonian)
    if pauli:
        (hf_det,), e_nuc = args, 0.0
        n_so = ham_or_h1.qubit_num
    else:
        v, hf_det, *rest = args
        e_nuc = float(rest[0]) if rest else 0.0
        n_so = ham_or_h1.shape[0]
    dets = np.unique(np.concatenate([
        np.asarray([hf_det], _U),
        excitations_in_sector(int(hf_det), n_so),
    ]))
    h = (sector_hamiltonian(ham_or_h1, dets) if pauli
         else sparse_hamiltonian(dets, ham_or_h1, v))
    energy, coef = _ground_state(h)
    return energy + e_nuc, dets, coef
