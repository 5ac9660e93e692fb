"""Grouped Pauli-sum Hamiltonian in XZ canonical form.

The ``PauliHamiltonian`` container of the JAX package's ``chem/jw.py``
(numpy only). Every Pauli string is ``w * X^A Z^B``, which gives the
matrix-element rule

    <x ^ A | w X^A Z^B | x> = w * (-1)^popcount(x & B)

``A`` is the determinant-flip mask and ``B`` the sign mask.

``jordan_wigner_pauli_hamiltonian`` is the JAX package's transform
(vectorised numpy, chunked at 200,000 two-electron terms): it expands each
ladder product a+_p a_q and a+_p a+_q a_s a_r into its 2^k XZ strings,
merges equal (A, B) strings, folds the identity into the constant and
groups the terms by A. ``z_string_symmetries`` and
``symplectic_symmetries`` are the GF(2) nullspaces that give the Z-string
and the full Pauli symmetry generators.

A term with an odd number of Y factors (popcount(A & B) odd) carries a
factor i that no real weight holds. The container carries it as the JAX
container does: such terms form a second group with the same A whose
``phase_offsets`` entry is pi/2 (``applications/spin_systems.py`` builds
them). The molecular transform never produces one from a real symmetric
Hamiltonian, and raises ``ValueError`` if one is left after merging.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..ops.bits import WORD_BITS, n_words


@dataclasses.dataclass
class PauliHamiltonian:
    """Terms sorted by flip mask A; ``group_starts`` is the CSR layout of
    the terms sharing each A. The weights are real; an odd-Y
    (imaginary-weight) channel is a second group with the same A and a
    ``phase_offsets`` entry of pi/2 (JAX ``chem/jw.py:27-52``)."""

    qubit_num: int
    constant: float  # identity coefficient + nuclear repulsion
    a_masks: np.ndarray  # (M, W) uint32 sorted flip masks (duplicates
    #   allowed: the odd-Y channel's group follows its real twin)
    b_words: np.ndarray  # (T, W) uint32 sign masks per term
    weights: np.ndarray  # (T,) float64 (i^#Y signs folded in)
    group_starts: np.ndarray  # (M+1,) int64 CSR offsets into b_words
    # (M,) float or None: each group's phase, <x ^ A|H_m|x> =
    # e^(i off) sum_b w (-1)^popcount(x & b). None for a real Hamiltonian
    # (every molecular one).
    phase_offsets: object = None

    @property
    def n_groups(self) -> int:
        return self.a_masks.shape[0]

    @property
    def n_terms(self) -> int:
        return self.weights.shape[0]

    def dense_matrix_element(self, x_bits: int, y_bits: int):
        """Oracle <y|H|x> for tests (python ints, any qubit count): a float
        for a real Hamiltonian, complex where ``phase_offsets`` is set."""
        flip = x_bits ^ y_bits
        a_ints = words_to_pyints(self.a_masks)
        b_ints = words_to_pyints(self.b_words)
        cplx = self.phase_offsets is not None
        val = complex(0.0) if cplx else 0.0
        if flip == 0:
            val += self.constant
        m = int(np.searchsorted(a_ints, flip))
        while m < len(a_ints) and a_ints[m] == flip:
            fac = np.exp(1j * float(self.phase_offsets[m])) if cplx else 1.0
            for t in range(self.group_starts[m], self.group_starts[m + 1]):
                par = bin(x_bits & b_ints[t]).count("1") % 2
                val += fac * self.weights[t] * (-1.0 if par else 1.0)
            m += 1
        return complex(val) if cplx else float(val)


def ints_to_words(values, qubit_num: int) -> np.ndarray:
    """(N,) ints (python ints allowed, any size) -> (N, W) uint32 words."""
    w = n_words(qubit_num)
    out = np.zeros((len(values), w), dtype=np.uint32)
    mask = (1 << WORD_BITS) - 1
    for i, v in enumerate(values):
        v = int(v)
        for j in range(w):
            out[i, j] = (v >> (WORD_BITS * j)) & mask
    return out


def words_to_pyints(words: np.ndarray) -> list:
    """(N, W) uint32 words -> list of python ints (any qubit count)."""
    out = []
    for row in words:
        v = 0
        for j in range(words.shape[1]):
            v |= int(row[j]) << (WORD_BITS * j)
        out.append(v)
    return out


def words_to_ints(words: np.ndarray) -> np.ndarray:
    """(N, W) uint32 words -> (N,) uint64 integers; raises ``ValueError``
    above 64 qubits."""
    w = np.asarray(words)
    if w.shape[1] * WORD_BITS > 64:
        raise ValueError("more than 64 qubits do not fit a uint64")
    out = np.zeros(w.shape[0], dtype=np.uint64)
    for j in range(w.shape[1]):
        out |= w[:, j].astype(np.uint64) << np.uint64(WORD_BITS * j)
    return out



def _expand_ladder_products(
    orbitals: np.ndarray, daggers: np.ndarray, coefs: np.ndarray, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """JW-expand the ladder products a^(d1)_{o1} ... a^(dk)_{ok}.

    ``orbitals``: (T, k) int, ``daggers``: (k,) bool (one pattern for the
    batch), ``coefs``: (T,) float, ``w``: words a mask. Returns (A, B,
    weights) of shapes (T 2^k, w), (T 2^k, w), (T 2^k,).

    a_o = Z_{<o} (X_o + i Y_o)/2 and a+_o is its conjugate. In XZ form the
    X choice gives X_o Z_{<o} with factor 1/2 and the Y choice X_o Z_{<=o}
    with factor -sigma/2 (sigma = +1 for an annihilator, -1 for a
    creator). Moving X^x past the accumulated Z^B flips the sign where bit
    o of B is set.
    """
    t_num, k = orbitals.shape
    n_choice = 1 << k
    word_idx = (orbitals // WORD_BITS).astype(np.int64)  # (T, k)
    bit_idx = (orbitals % WORD_BITS).astype(np.uint32)

    j_idx = np.arange(w)
    one_hot = np.uint32(1) << bit_idx[..., None].astype(np.uint32)
    x_words = np.where(j_idx[None, None, :] == word_idx[..., None],
                       one_hot, np.uint32(0)).astype(np.uint32)  # (T, k, w)
    below = np.where(j_idx[None, None, :] < word_idx[..., None],
                     np.uint32(0xFFFFFFFF), np.uint32(0))
    below = below | np.where(j_idx[None, None, :] == word_idx[..., None],
                             one_hot - np.uint32(1), np.uint32(0))
    below = below.astype(np.uint32)

    a_acc = np.zeros((t_num, n_choice, w), dtype=np.uint32)
    b_acc = np.zeros((t_num, n_choice, w), dtype=np.uint32)
    w_acc = np.broadcast_to(coefs[:, None] / (2.0 ** k),
                            (t_num, n_choice)).copy()
    choice_bits = ((np.arange(n_choice)[None, :] >> np.arange(k)[:, None])
                   & 1).astype(bool)  # (k, n_choice)

    for i in range(k):
        use_y = choice_bits[i][None, :]
        x_i = x_words[:, i][:, None, :]  # (T, 1, w)
        z_i = np.where(use_y[..., None], below[:, i][:, None, :] | x_i,
                       below[:, i][:, None, :])
        sigma = -1.0 if daggers[i] else 1.0
        w_acc = np.where(use_y, -sigma * w_acc, w_acc)
        b_word = np.take_along_axis(
            b_acc, word_idx[:, i][:, None, None], axis=2)[..., 0]
        crosses = ((b_word >> bit_idx[:, i][:, None]) & 1).astype(bool)
        w_acc = np.where(crosses, -w_acc, w_acc)
        a_acc = a_acc ^ x_i
        b_acc = b_acc ^ z_i

    return a_acc.reshape(-1, w), b_acc.reshape(-1, w), w_acc.ravel()


# Two-electron terms expanded at a time: bounds the (T, 16, w)
# intermediates at large n.
JW_CHUNK = 200_000


def jordan_wigner_pauli_hamiltonian(
    h1: np.ndarray,
    v: np.ndarray,
    constant: float = 0.0,
    tol: float = 1e-12,
) -> PauliHamiltonian:
    """Second-quantized H -> grouped Pauli form (JAX ``chem/jw.py``).

    H = constant + sum h1[p,q] a+_p a_q
        + 1/2 sum v[p,q,r,s] a+_p a+_q a_s a_r,  v[p,q,r,s] = <pq|rs>.

    Raises ``ValueError`` if a merged term has an odd number of Y factors
    (the integrals are not those of a real symmetric Hamiltonian).
    """
    n_so = h1.shape[0]
    w = n_words(n_so)
    all_a, all_b, all_w = [], [], []

    p_idx, q_idx = np.nonzero(np.abs(h1) > tol)
    if len(p_idx):
        a, b, wt = _expand_ladder_products(
            np.stack([p_idx, q_idx], axis=1), np.array([True, False]),
            h1[p_idx, q_idx], w)
        all_a.append(a)
        all_b.append(b)
        all_w.append(wt)

    pq = np.nonzero(np.abs(v) > tol)
    if len(pq[0]):
        # a+_p a+_q a_s a_r: operator order (p, q, s, r).
        orbitals = np.stack([pq[0], pq[1], pq[3], pq[2]], axis=1)
        coefs = 0.5 * v[pq]
        for s in range(0, len(pq[0]), JW_CHUNK):
            sl = slice(s, s + JW_CHUNK)
            a, b, wt = _expand_ladder_products(
                orbitals[sl], np.array([True, True, False, False]),
                coefs[sl], w)
            all_a.append(a)
            all_b.append(b)
            all_w.append(wt)

    a_all = np.concatenate(all_a) if all_a else np.zeros((0, w), np.uint32)
    b_all = np.concatenate(all_b) if all_b else np.zeros((0, w), np.uint32)
    w_all = np.concatenate(all_w) if all_w else np.zeros(0, np.float64)

    # Merge equal (A, B) strings.
    uniq, inverse = np.unique(np.concatenate([a_all, b_all], axis=1),
                              axis=0, return_inverse=True)
    weights = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(weights, inverse.reshape(-1), w_all)
    keep = np.abs(weights) > tol
    uniq = uniq[keep]
    weights = weights[keep]

    odd_y = np.bitwise_xor.reduce(uniq[:, :w] & uniq[:, w:], axis=1,
                                  initial=np.uint32(0))
    for shift in (16, 8, 4, 2, 1):
        odd_y ^= odd_y >> np.uint32(shift)
    odd_y &= np.uint32(1)
    if odd_y.any():
        raise ValueError(f"{int(odd_y.sum())} Pauli terms with an odd "
                         "number of Y factors: not a real symmetric "
                         "Hamiltonian (the molecular transform builds no "
                         "odd-Y channel)")

    # Identity -> constant.
    is_id = (uniq == 0).all(axis=1)
    const = constant + float(weights[is_id].sum())
    uniq = uniq[~is_id]
    weights = weights[~is_id]

    # Sort by (A, B), most significant word first, and group by A.
    a_cols = uniq[:, :w]
    b_cols = uniq[:, w:]
    order = np.lexsort(tuple(b_cols[:, j] for j in range(w))
                       + tuple(a_cols[:, j] for j in range(w)))
    a_sorted = a_cols[order]
    b_sorted = b_cols[order]
    weights = weights[order]
    _, first = np.unique(a_sorted, axis=0, return_index=True)
    first = np.sort(first)
    group_starts = np.concatenate([first, [len(a_sorted)]]).astype(np.int64)

    return PauliHamiltonian(
        qubit_num=n_so,
        constant=const,
        a_masks=np.ascontiguousarray(a_sorted[first]),
        b_words=np.ascontiguousarray(b_sorted),
        weights=weights,
        group_starts=group_starts,
    )


def _unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """(R, W) uint32 packed rows -> (R, n) 0/1 int8 bit matrix."""
    out = np.zeros((words.shape[0], n), dtype=np.int8)
    for j in range(n):
        out[:, j] = (words[:, j // WORD_BITS]
                     >> np.uint32(j % WORD_BITS)) & np.uint32(1)
    return out


def _gf2_nullspace(rows: np.ndarray) -> np.ndarray:
    """Nullspace basis of a 0/1 matrix over GF(2): (G, C) int8 rows, one a
    free column in ascending order (JAX's elimination order)."""
    n = rows.shape[1]
    m = rows.copy() % 2
    pivots = []
    r = 0
    for c in range(n):
        pivot_rows = np.nonzero(m[r:, c])[0]
        if len(pivot_rows) == 0:
            continue
        pr = r + pivot_rows[0]
        m[[r, pr]] = m[[pr, r]]
        for e in np.nonzero(m[:, c])[0]:
            if e != r:
                m[e] ^= m[r]
        pivots.append(c)
        r += 1
        if r == m.shape[0]:
            break
    basis = []
    for fc in (c for c in range(n) if c not in pivots):
        g = np.zeros(n, dtype=np.int8)
        g[fc] = 1
        for i, pc in enumerate(pivots):
            if m[i, fc]:
                g[pc] = 1
        basis.append(g)
    return np.array(basis, dtype=np.int8).reshape(len(basis), n)


def z_string_symmetries(ham: PauliHamiltonian) -> np.ndarray:
    """Z-string symmetry generators: the GF(2) nullspace of the flip masks.

    Z^g commutes with every term iff popcount(g & A_m) is even for every
    group. Returns (G, qubit_num) 0/1 int8 rows, one an independent
    generator (the sampling masker's input)."""
    return _gf2_nullspace(_unpack_bits(ham.a_masks, ham.qubit_num))


def symplectic_symmetries(ham: PauliHamiltonian):
    """Full Pauli symmetry generators: the GF(2) kernel of the symplectic
    form. A string with x-vector x_g and z-vector z_g commutes with the
    term (a_m, b_m) iff a_m . z_g + b_m . x_g = 0 (mod 2): the kernel of
    the (T, 2n) matrix [B | A]. Returns (x_bits, z_bits), two (G,
    qubit_num) 0/1 int8 arrays."""
    n = ham.qubit_num
    group_id = np.repeat(np.arange(ham.n_groups),
                         np.diff(ham.group_starts).astype(np.int64))
    a_bits = _unpack_bits(ham.a_masks, n)[group_id]
    b_bits = _unpack_bits(ham.b_words, n)
    kernel = _gf2_nullspace(np.concatenate([b_bits, a_bits], axis=1))
    return kernel[:, :n], kernel[:, n:]


def permute_qubits_hamiltonian(ham: PauliHamiltonian,
                               perm) -> PauliHamiltonian:
    """Relabel qubits: new qubit ``i`` carries old qubit ``perm[i]`` (the
    convention of ``ops.bits.permute_qubits``; JAX ``chem/jw.py:379-429``).
    Each group keeps its terms and its phase offset; the groups are
    re-sorted (stably) by their permuted flip masks, so ``a_masks`` stays
    canonically ordered. Raises
    ``ValueError`` unless ``perm`` is a permutation of the qubits."""
    n = ham.qubit_num
    perm = np.asarray(perm, dtype=np.int64)
    if sorted(perm.tolist()) != list(range(n)):
        raise ValueError(f"qubit_perm is not a permutation of {n} qubits")

    def permute_words(words):
        out = np.zeros_like(words)
        for i, p in enumerate(perm):
            bit = (words[:, p // WORD_BITS] >> np.uint32(p % WORD_BITS)) & 1
            out[:, i // WORD_BITS] |= (bit.astype(words.dtype)
                                       << np.uint32(i % WORD_BITS))
        return out

    a_new = permute_words(ham.a_masks)
    b_new = permute_words(ham.b_words)
    a_ints = words_to_pyints(a_new)
    order = sorted(range(len(a_ints)), key=lambda m: a_ints[m])
    starts = ham.group_starts
    new_starts = [0]
    b_parts, w_parts = [], []
    for m in order:
        s, e = int(starts[m]), int(starts[m + 1])
        b_parts.append(b_new[s:e])
        w_parts.append(ham.weights[s:e])
        new_starts.append(new_starts[-1] + (e - s))
    return PauliHamiltonian(
        qubit_num=n,
        constant=ham.constant,
        a_masks=a_new[np.asarray(order)],
        b_words=np.vstack(b_parts),
        weights=np.concatenate(w_parts),
        group_starts=np.asarray(new_starts, dtype=np.int64),
        phase_offsets=(None if ham.phase_offsets is None
                       else np.asarray(ham.phase_offsets)[order]),
    )


def permute_det(det: int, perm) -> int:
    """Relabel the bits of a determinant: new bit i = old bit perm[i]."""
    return sum(((int(det) >> int(p)) & 1) << i for i, p in enumerate(perm))
