"""Locally decomposable quantum-number symmetries.

A symmetry contributes, per qubit, a local eigenvalue depending on the bit
value; the accumulated eigenvalue (sum for additive, product for
multiplicative) of a full basis state must equal a reference value for the
state to be physical. This mirrors the reference's symmetry hierarchy
(reference: nqs/nqs/stochastic/symmetries/abstract_locally_decomposable_
symmetry.py:9-92 and concrete subclasses) as plain numpy data: everything here
is static per molecule and is consumed by the masker's DP table builder.

A copy of the JAX package's ``symmetries/symmetry.py``. All eigenvalues are
small integers. Spin projection uses doubled Sz (so it
stays integral); Z2 symmetries use eigenvalues in {-1, +1}.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Symmetry:
    name: str
    kind: str  # 'add' | 'mul'
    local_eigs: np.ndarray  # (qubit_num, 2) int64: eig of bit=0 / bit=1
    start_eig: int
    ref_eig: int

    @property
    def qubit_num(self) -> int:
        return self.local_eigs.shape[0]

    @property
    def values(self) -> np.ndarray:
        """All representable accumulated eigenvalues (the ordinal axis)."""
        if self.kind == "mul":
            return np.array([-1, 1], dtype=np.int64)
        lo = self.start_eig + np.minimum(
            self.local_eigs[:, 0], self.local_eigs[:, 1]
        ).sum()
        hi = self.start_eig + np.maximum(
            self.local_eigs[:, 0], self.local_eigs[:, 1]
        ).sum()
        return np.arange(lo, hi + 1, dtype=np.int64)

    def eig_to_ordinal(self, eig):
        """Map accumulated eigenvalues to [0, spectrum_size); -1 if invalid."""
        eig = np.asarray(eig)
        if self.kind == "mul":
            ordinal = (eig + 1) // 2
            valid = np.isin(eig, (-1, 1))
        else:
            vals = self.values
            ordinal = eig - vals[0]
            valid = (eig >= vals[0]) & (eig <= vals[-1])
        return np.where(valid, ordinal, -1).astype(np.int64)

    def ordinal_to_eig(self, ordinal):
        ordinal = np.asarray(ordinal)
        if self.kind == "mul":
            return 2 * ordinal - 1
        return self.values[0] + ordinal

    @property
    def spectrum_size(self) -> int:
        return len(self.values)

    def accumulate(self, acc, local):
        return acc * local if self.kind == "mul" else acc + local

    def acc_eig_of(self, bits: np.ndarray):
        """Accumulated eigenvalue of full/partial bit rows ``(..., m)``."""
        m = bits.shape[-1]
        local = np.where(
            bits.astype(bool), self.local_eigs[:m, 1], self.local_eigs[:m, 0]
        )
        if self.kind == "mul":
            return np.prod(local, axis=-1) * self.start_eig
        return np.sum(local, axis=-1) + self.start_eig


def particle_number_symmetry(qubit_num: int, n_electrons: int) -> Symmetry:
    """N-hat conservation (reference: .../particle_number_symmetry.py:8-59)."""
    local = np.zeros((qubit_num, 2), dtype=np.int64)
    local[:, 1] = 1
    return Symmetry("particle_number", "add", local, 0, n_electrons)


def spin_projection_symmetry(
    qubit_num: int, twice_sz: int, perm=None
) -> Symmetry:
    """Doubled-Sz conservation on interleaved spin-orbitals (even qubit =
    alpha -> +1, odd = beta -> -1); ref = 2*Sz = multiplicity - 1
    (reference: .../spin_half_projection_symmetry.py:8-64, which applies
    a qubit permutation the same way via ``inv_perm``). With ``perm``,
    qubit ``i`` carries original spin-orbital ``perm[i]``."""
    local = np.zeros((qubit_num, 2), dtype=np.int64)
    orig = np.arange(qubit_num) if perm is None else np.asarray(perm)
    local[orig % 2 == 0, 1] = 1
    local[orig % 2 == 1, 1] = -1
    return Symmetry("spin_projection", "add", local, 0, twice_sz)


def z2_symmetry(z_mask_bits: np.ndarray, ref_eig: int,
                name: str = "z2") -> Symmetry:
    """Pauli-Z-string symmetry from tapering generators: local eig =
    (-1)^(z_mask_i * bit) (reference: .../z2_symmetry.py:9-55)."""
    qubit_num = len(z_mask_bits)
    local = np.ones((qubit_num, 2), dtype=np.int64)
    local[np.asarray(z_mask_bits).astype(bool), 1] = -1
    return Symmetry(name, "mul", local, 1, int(ref_eig))


def idle_symmetry(qubit_num: int) -> Symmetry:
    """No-op symmetry for symmetry_level='no_sym'
    (reference: .../idle_symmetry.py:8-53)."""
    local = np.zeros((qubit_num, 2), dtype=np.int64)
    return Symmetry("idle", "add", local, 0, 0)
