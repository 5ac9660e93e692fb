"""Spin-chain Hamiltonians on the same ANQS/VMC stack.

A copy of the JAX package's ``applications/spin_systems.py`` (numpy only):
spin Hamiltonians are built directly in the XZ canonical bit-mask form that
the local-energy engine consumes, and trained with ``VMC(ham=, masker=,
ref_det=)``.
"""

from __future__ import annotations

import numpy as np

from ..chem.jw import PauliHamiltonian, ints_to_words, words_to_ints

# ``exact_ground_energy`` diagonalises densely up to this many qubits.
MAX_DENSE_QUBITS = 14


def pauli_sum(qubit_num: int, terms, constant: float = 0.0):
    """``terms``: iterable of (pauli_string, weight), a pauli_string a dict
    {qubit: 'X' | 'Y' | 'Z'}. Returns a grouped ``PauliHamiltonian``.

    Y = i X Z, so a term carries i^#Y: its sign folds into the real weight,
    and an odd-Y term's remaining factor i makes it part of a second group
    with the same flip mask and a ``phase_offsets`` entry of pi/2. For a
    fixed (A, B) the Y count popcount(A & B) is fixed, so each (A, B) is
    purely real or purely imaginary and the two channels never mix."""
    acc = {}
    const = constant
    for ops, w in terms:
        a = b = 0
        n_y = 0
        for q, p in ops.items():
            if p == "X":
                a |= 1 << q
            elif p == "Z":
                b |= 1 << q
            elif p == "Y":
                a |= 1 << q
                b |= 1 << q
                n_y += 1
            else:
                raise ValueError(p)
        odd = n_y % 2
        # i^#Y = +-1 for an even count, +-i for an odd one.
        w_eff = float(w) * (-1.0 if n_y % 4 in (2, 3) else 1.0)
        if a == 0 and b == 0:
            const += w_eff
            continue
        acc[(a, odd, b)] = acc.get((a, odd, b), 0.0) + w_eff

    pairs = sorted(acc.items())
    a_all = np.array([p[0][0] for p in pairs], dtype=np.uint64)
    odd_all = np.array([p[0][1] for p in pairs], dtype=np.int64)
    b_all = np.array([p[0][2] for p in pairs], dtype=np.uint64)
    w_all = np.array([p[1] for p in pairs], dtype=np.float64)
    change = np.ones(len(pairs), dtype=bool)
    change[1:] = (a_all[1:] != a_all[:-1]) | (odd_all[1:] != odd_all[:-1])
    first = np.flatnonzero(change)
    group_odd = odd_all[first]
    return PauliHamiltonian(
        qubit_num=qubit_num,
        constant=const,
        a_masks=ints_to_words(a_all[first], qubit_num),
        b_words=ints_to_words(b_all, qubit_num),
        weights=w_all,
        group_starts=np.concatenate([first, [len(a_all)]]).astype(np.int64),
        phase_offsets=((np.pi / 2.0) * group_odd.astype(np.float64)
                       if group_odd.any() else None),
    )


def tfi_hamiltonian(qubit_num: int, j: float = 1.0, h: float = 1.0,
                    periodic: bool = False) -> PauliHamiltonian:
    """Transverse-field Ising chain H = -j sum Z_i Z_{i+1} - h sum X_i."""
    terms = []
    bonds = qubit_num if periodic else qubit_num - 1
    for i in range(bonds):
        terms.append(({i: "Z", (i + 1) % qubit_num: "Z"}, -j))
    for i in range(qubit_num):
        terms.append(({i: "X"}, -h))
    return pauli_sum(qubit_num, terms)


def heisenberg_xxz_hamiltonian(qubit_num: int, jxy: float = 1.0,
                               jz: float = 1.0,
                               periodic: bool = False) -> PauliHamiltonian:
    """XXZ chain: conserves total Sz, so the particle-number masker
    applies."""
    terms = []
    bonds = qubit_num if periodic else qubit_num - 1
    for i in range(bonds):
        k = (i + 1) % qubit_num
        terms.append(({i: "X", k: "X"}, jxy))
        terms.append(({i: "Y", k: "Y"}, jxy))
        terms.append(({i: "Z", k: "Z"}, jz))
    return pauli_sum(qubit_num, terms)


def dm_chain_hamiltonian(qubit_num: int, jxy: float = 1.0,
                         d: float = 0.6) -> PauliHamiltonian:
    """Open XY chain with a Dzyaloshinskii-Moriya term, H = sum jxy (X X +
    Y Y) + d (X_i Y_{i+1} - Y_i X_{i+1}): each bond's DM terms have one Y,
    so every flip mask carries a real group (XX + YY) and an imaginary one
    (the chain of JAX ``tests/test_spin_systems.py``'s ``_dm_chain``)."""
    terms = []
    for i in range(qubit_num - 1):
        terms.append(({i: "X", i + 1: "X"}, jxy))
        terms.append(({i: "Y", i + 1: "Y"}, jxy))
        terms.append(({i: "X", i + 1: "Y"}, d))
        terms.append(({i: "Y", i + 1: "X"}, -d))
    return pauli_sum(qubit_num, terms)


def exact_ground_energy(ham: PauliHamiltonian) -> float:
    """Dense exact diagonalisation (a test oracle); raises ``ValueError``
    above ``MAX_DENSE_QUBITS`` qubits."""
    n = ham.qubit_num
    if n > MAX_DENSE_QUBITS:
        raise ValueError(f"{n} qubits: dense diagonalisation stops at "
                         f"{MAX_DENSE_QUBITS}")
    dim = 1 << n
    cplx = ham.phase_offsets is not None
    # dense_matrix_element sums every group of a flip mask, so iterate the
    # distinct masks only (the odd-Y channel repeats them).
    a_uniq = sorted(set(words_to_ints(ham.a_masks).tolist()))
    mat = np.zeros((dim, dim), dtype=np.complex128 if cplx else np.float64)
    for x in range(dim):
        for a in a_uniq:
            a = int(a)
            mat[x ^ a, x] += ham.dense_matrix_element(x, x ^ a) - (
                ham.constant if a == 0 else 0.0)
        mat[x, x] += ham.constant
    return float(np.linalg.eigvalsh(mat)[0])
