"""Grouped Pauli-sum Hamiltonian in XZ canonical form.

The ``PauliHamiltonian`` container of the JAX package's ``chem/jw.py``
(numpy only). Every Pauli string is ``w * X^A Z^B``, which gives the
matrix-element rule

    <x ^ A | w X^A Z^B | x> = w * (-1)^popcount(x & B)

``A`` is the determinant-flip mask and ``B`` the sign mask. The
Jordan-Wigner transform itself is not ported: the port reads a prepared
Hamiltonian from a molecule file (``chem/molecule.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PauliHamiltonian:
    """Terms sorted by flip mask A; ``group_starts`` is the CSR layout of
    the terms sharing each unique A. Real weights only: the odd-Y
    (complex-weight) channel of the JAX container does not occur in the
    molecular Hamiltonians this slice runs."""

    qubit_num: int
    constant: float  # identity coefficient + nuclear repulsion
    a_masks: np.ndarray  # (M, W) uint32 sorted flip masks
    b_words: np.ndarray  # (T, W) uint32 sign masks per term
    weights: np.ndarray  # (T,) float64
    group_starts: np.ndarray  # (M+1,) int64 CSR offsets into b_words

    @property
    def n_groups(self) -> int:
        return self.a_masks.shape[0]

    @property
    def n_terms(self) -> int:
        return self.weights.shape[0]


def words_to_uint64(words: np.ndarray) -> np.ndarray:
    """(N, W <= 2) uint32 words -> (N,) uint64 integers."""
    w = np.asarray(words).astype(np.uint64)
    if w.shape[1] > 2:
        raise ValueError("more than 64 qubits do not fit a uint64")
    out = w[:, 0]
    if w.shape[1] == 2:
        out = out | (w[:, 1] << np.uint64(32))
    return out
