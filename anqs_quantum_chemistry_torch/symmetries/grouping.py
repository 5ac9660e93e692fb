"""Qubit-to-qudit grouping + per-qudit memo multiplication tables.

Groups qubits into qudits (default 6 qubits -> one 64-way softmax per
autoregressive step) and precomputes, per qudit, the memo-index transition
table and the continuation physicality mask indexed by (memo state,
continuation). Mirrors the reference QubitGrouping
(reference: nqs/nqs/base/qubit_grouping.py:30-213) but emits uniform
``(qudit_num, memo_size, max_qudit_dim)`` stacked numpy tables, which the
sampler and the amplitude evaluator index per qudit on the device. A copy of
the JAX package's ``symmetries/grouping.py`` (numpy only).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .masker import Masker


@dataclasses.dataclass(frozen=True)
class QubitGrouping:
    qubit_num: int
    qudit_starts: Tuple[int, ...]
    qudit_ends: Tuple[int, ...]
    # Stacked tables, shapes (qudit_num, memo_size, max_qudit_dim):
    trans_tables: np.ndarray  # int32 memo-index transitions
    mask_tables: np.ndarray  # bool continuation physicality
    start_memo_idx: int

    @property
    def qudit_num(self) -> int:
        return len(self.qudit_starts)

    @property
    def qudit_widths(self) -> Tuple[int, ...]:
        return tuple(
            e - s for s, e in zip(self.qudit_starts, self.qudit_ends)
        )

    @property
    def qudit_dims(self) -> Tuple[int, ...]:
        return tuple(2**w for w in self.qudit_widths)

    @property
    def max_qudit_dim(self) -> int:
        return max(self.qudit_dims)

    @classmethod
    def create(cls, masker: Masker, qubit_per_qudit: int = 6):
        """Uniform grouping (reference: qubit_grouping.py:111-128)."""
        n = masker.qubit_num
        qudit_num = -(-n // qubit_per_qudit)
        starts = tuple(q * qubit_per_qudit for q in range(qudit_num))
        ends = starts[1:] + (n,)

        max_dim = 2 ** max(e - s for s, e in zip(starts, ends))
        s_size = masker.memo_size
        trans = np.zeros((qudit_num, s_size, max_dim), dtype=np.int32)
        mask = np.zeros((qudit_num, s_size, max_dim), dtype=bool)

        for q, (start, end) in enumerate(zip(starts, ends)):
            width = end - start
            dim = 2**width
            # Compose per-qubit transitions over the qudit's bits for every
            # (memo state, continuation) pair.
            idx = np.broadcast_to(
                np.arange(s_size, dtype=np.int64)[:, None], (s_size, dim)
            ).copy()
            ok = np.ones((s_size, dim), dtype=bool)
            conts = np.arange(dim, dtype=np.int64)
            for j in range(width):
                b = (conts >> j) & 1  # (dim,)
                step_ok = masker.next_valid[start + j, idx, b[None, :]]
                idx = np.where(step_ok,
                               masker.next_idx[start + j, idx, b[None, :]],
                               0)
                ok &= step_ok
            trans[q, :, :dim] = np.where(ok, idx, 0)
            mask[q, :, :dim] = ok & masker.memo[end, idx]

        return cls(
            qubit_num=n,
            qudit_starts=starts,
            qudit_ends=ends,
            trans_tables=trans,
            mask_tables=mask,
            start_memo_idx=masker.start_memo_idx,
        )
