"""Symmetry-projection masker: mixed-radix memo index + backward DP table.

All symmetries' accumulated-eigenvalue ordinals are packed into one mixed-radix
"memo index"; a boolean DP table ``memo[(qubit_num+1), memo_size]`` answers
"can this prefix state still reach the target quantum numbers?" by backward
induction from the last qubit. Mirrors the reference masker
(reference: nqs/nqs/stochastic/maskers/locally_decomposable_masker.py:17-177)
but is built once in numpy (it is static per molecule) and consumed as constant
lookup tables on device. A copy of the JAX package's ``symmetries/masker.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .symmetry import Symmetry


class Masker:
    def __init__(self, symmetries: Sequence[Symmetry]):
        assert len(symmetries) > 0
        qubit_num = symmetries[0].qubit_num
        for s in symmetries:
            assert s.qubit_num == qubit_num
        self.symmetries = tuple(symmetries)
        self.qubit_num = qubit_num
        self.sym_num = len(self.symmetries)

        self.spectrum_sizes = np.array(
            [s.spectrum_size for s in self.symmetries], dtype=np.int64
        )
        # bases[i] = product of spectrum sizes of symmetries < i
        self.bases = np.concatenate(
            [[1], np.cumprod(self.spectrum_sizes[:-1])]
        ).astype(np.int64)
        self.memo_size = int(np.prod(self.spectrum_sizes))

        # Decode table: memo_idx -> acc eigenvalues, (memo_size, sym_num).
        idx = np.arange(self.memo_size, dtype=np.int64)
        ordinals = (idx[:, None] // self.bases[None, :]) % self.spectrum_sizes
        self._acc_eigs = np.stack(
            [s.ordinal_to_eig(ordinals[:, i])
             for i, s in enumerate(self.symmetries)],
            axis=1,
        )

        # Per-qubit transitions: next_idx[t, s, b], valid[t, s, b].
        self.next_idx = np.zeros(
            (qubit_num, self.memo_size, 2), dtype=np.int64
        )
        self.next_valid = np.zeros(
            (qubit_num, self.memo_size, 2), dtype=bool
        )
        for t in range(qubit_num):
            for b in (0, 1):
                new_eigs = np.stack(
                    [
                        s.accumulate(self._acc_eigs[:, i],
                                     s.local_eigs[t, b])
                        for i, s in enumerate(self.symmetries)
                    ],
                    axis=1,
                )
                new_idx, valid = self.encode(new_eigs)
                self.next_idx[t, :, b] = new_idx
                self.next_valid[t, :, b] = valid

        # Backward DP (reference init_memo, masker.py:130-146).
        self.memo = np.zeros((qubit_num + 1, self.memo_size), dtype=bool)
        ref = np.array([s.ref_eig for s in self.symmetries], dtype=np.int64)
        self.memo[qubit_num] = np.all(self._acc_eigs == ref, axis=1)
        for t in range(qubit_num - 1, -1, -1):
            reach = np.zeros(self.memo_size, dtype=bool)
            for b in (0, 1):
                ok = self.next_valid[t, :, b]
                nxt = np.where(ok, self.next_idx[t, :, b], 0)
                reach |= ok & self.memo[t + 1, nxt]
            self.memo[t] = reach

        start_eigs = np.array(
            [[s.start_eig for s in self.symmetries]], dtype=np.int64
        )
        self.start_memo_idx = int(self.encode(start_eigs)[0][0])

    def encode(self, acc_eigs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """acc eigenvalues ``(..., sym_num)`` -> (memo_idx, valid)."""
        ordinals = np.stack(
            [s.eig_to_ordinal(acc_eigs[..., i])
             for i, s in enumerate(self.symmetries)],
            axis=-1,
        )
        valid = np.all(ordinals >= 0, axis=-1)
        idx = np.sum(np.where(ordinals >= 0, ordinals, 0) * self.bases,
                     axis=-1)
        return np.where(valid, idx, 0), valid

    def decode(self, memo_idx) -> np.ndarray:
        return self._acc_eigs[np.asarray(memo_idx)]

    def is_physical(self, bits: np.ndarray) -> np.ndarray:
        """Numpy oracle: full basis states ``(..., qubit_num)`` -> bool."""
        eigs = np.stack(
            [s.acc_eig_of(bits) for s in self.symmetries], axis=-1
        )
        ref = np.array([s.ref_eig for s in self.symmetries], dtype=np.int64)
        return np.all(eigs == ref, axis=-1)

    def prefix_extendable(self, bits: np.ndarray) -> np.ndarray:
        """Numpy oracle: can prefix ``(..., m)`` extend to a physical state?

        Brute-force-free check through the DP table; used as the contract for
        sampling-time masks.
        """
        m = bits.shape[-1]
        eigs = np.stack(
            [s.acc_eig_of(bits) for s in self.symmetries], axis=-1
        )
        idx, valid = self.encode(eigs)
        return valid & self.memo[m, idx]
