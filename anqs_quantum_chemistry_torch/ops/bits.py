"""Bit-packed determinant codec and bit ops (torch, 32-bit words in int64).

A basis state on ``n`` qubits is ``W = ceil(n/32)`` little-endian 32-bit
words: qubit ``i`` lives in bit ``i % 32`` of word ``i // 32`` -- the layout
of the JAX package's ``ops/bits.py``. The words are stored in ``int64``
tensors holding values in ``[0, 2**32)``, because this torch build refuses
``uint32`` in shifts, comparisons and indexing. Where the JAX code relies on
uint32 wraparound (left shifts, products), the result is masked with
``MASK32``. All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def n_words(qubit_num: int) -> int:
    """Number of 32-bit words needed to store ``qubit_num`` qubits."""
    return -(-qubit_num // WORD_BITS)


def _shifts(device):
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., n)`` 0/1 integers into ``(..., W)`` int64 words."""
    n = bits.shape[-1]
    w = n_words(n)
    b = bits.to(torch.int64)
    pad = w * WORD_BITS - n
    if pad:
        b = torch.cat([b, b.new_zeros((*b.shape[:-1], pad))], dim=-1)
    b = b.reshape(*b.shape[:-1], w, WORD_BITS)
    return torch.sum(b << _shifts(b.device), dim=-1)


def unpack(words: torch.Tensor, qubit_num: int, dtype=torch.int64):
    """Unpack ``(..., W)`` words into ``(..., qubit_num)`` 0/1 values."""
    bits = (words[..., None] >> _shifts(words.device)) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return bits[..., :qubit_num].to(dtype)


def popcount_word(w: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 32-bit words (SWAR, branchless)."""
    w = w & MASK32
    w = w - ((w >> 1) & _M1)
    w = (w & _M2) + ((w >> 2) & _M2)
    w = (w + (w >> 4)) & _M4
    return ((w * 0x01010101) & MASK32) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total popcount over the word axis: ``(..., W) -> (...,)``."""
    return torch.sum(popcount_word(words), dim=-1)


# Set bits of each byte value, counted by Python: the table of
# ``popcount_hw``, independent of ``popcount_word``'s SWAR.
_BYTE_POPCOUNT = tuple(bin(v).count("1") for v in range(256))


def popcount_hw(words: torch.Tensor) -> torch.Tensor:
    """``popcount`` by a byte lookup table: the JAX package's
    ``popcount_hw``, the reference's cross-check mode (hilbert_space.py:
    158-198 keeps three popcounts)."""
    table = torch.tensor(_BYTE_POPCOUNT, dtype=torch.int64,
                         device=words.device)
    w = words & MASK32
    return torch.sum(sum(table[(w >> s) & 0xFF] for s in (0, 8, 16, 24)),
                     dim=-1)


def permute_qubits(words: torch.Tensor, perm, qubit_num: int) -> torch.Tensor:
    """Reorder qubits: output bit ``i`` = input bit ``perm[i]`` (the JAX
    package's ``permute_qubits``; reference perm/inv_perm,
    hilbert_space.py:97-104)."""
    bits = unpack(words, qubit_num)
    idx = torch.as_tensor(perm, dtype=torch.int64, device=words.device)
    return pack(bits[..., idx])


def parity(words: torch.Tensor) -> torch.Tensor:
    """Parity (popcount mod 2) over the word axis: ``(..., W) -> (...,)``."""
    w = words[..., 0]
    for j in range(1, words.shape[-1]):
        w = w ^ words[..., j]
    for s in (16, 8, 4, 2, 1):
        w = w ^ (w >> s)
    return w & 1


def interleave_swap(words: torch.Tensor, qubit_num: int) -> torch.Tensor:
    """Swap even and odd qubits (alpha <-> beta spin-orbitals) in packed
    words: the JAX package's ``interleave_swap``. ``qubit_num`` must be
    even; bits above it must be zero."""
    if qubit_num % 2:
        raise ValueError(f"interleave_swap needs an even qubit count, got "
                         f"{qubit_num}")
    return ((words & _M1) << 1) | ((words & (_M1 << 1)) >> 1)


def set_bit_range(words, start: int, width: int, value):
    """Write ``value`` (ints < 2**width) into qubits [start, start+width).

    ``start``/``width`` are Python ints; ``value`` has shape
    ``words.shape[:-1]``. The target bits must currently be zero (ancestral
    sampling only ever appends to an all-zero suffix).
    """
    assert width <= WORD_BITS
    value = value.to(torch.int64)
    w0, off = start // WORD_BITS, start % WORD_BITS
    out = []
    for j in range(words.shape[-1]):
        piece = words[..., j]
        if j == w0:
            piece = piece | ((value << off) & MASK32)
        elif j == w0 + 1 and off + width > WORD_BITS:
            piece = piece | (value >> (WORD_BITS - off))
        out.append(piece)
    return torch.stack(out, dim=-1)


def get_bit_range(words, start: int, width: int):
    """Read qubits [start, start+width) as an integer; Python-int range."""
    assert width <= WORD_BITS
    w0, off = start // WORD_BITS, start % WORD_BITS
    lo = words[..., w0] >> off
    if off + width > WORD_BITS:
        lo = lo | ((words[..., w0 + 1] << (WORD_BITS - off)) & MASK32)
    return lo & ((1 << width) - 1)


def set_bit_range_dyn(words, start, width: int, value):
    """``set_bit_range`` with a tensor ``start`` (0-d int).

    ``width`` is the static maximum qudit width; callers guarantee
    ``value < 2**width`` and that the target bits are currently zero.
    """
    assert width <= WORD_BITS
    start = torch.as_tensor(start, dtype=torch.int64, device=words.device)
    value = value.to(torch.int64)
    w0 = start // WORD_BITS
    off = start % WORD_BITS
    lo = (value << off) & MASK32
    hi = torch.where(
        off == 0, 0, value >> (WORD_BITS - torch.clamp(off, min=1))
    )
    j = torch.arange(words.shape[-1], dtype=torch.int64, device=words.device)
    return (
        words
        | torch.where(j == w0, lo[..., None], 0)
        | torch.where(j == w0 + 1, hi[..., None], 0)
    )


def get_bit_range_dyn(words, start, width: int):
    """``get_bit_range`` with a tensor ``start`` (0-d int).

    Bits beyond the last qubit are zero by construction, so reading a
    narrower final qudit with the full static ``width`` is harmless.
    """
    assert width <= WORD_BITS
    start = torch.as_tensor(start, dtype=torch.int64, device=words.device)
    w0 = start // WORD_BITS
    off = start % WORD_BITS
    j = torch.arange(words.shape[-1], dtype=torch.int64, device=words.device)
    lo_word = torch.sum(torch.where(j == w0, words, 0), dim=-1)
    hi_word = torch.sum(torch.where(j == w0 + 1, words, 0), dim=-1)
    lo = lo_word >> off
    hi = torch.where(
        off == 0,
        0,
        (hi_word << (WORD_BITS - torch.clamp(off, min=1))) & MASK32,
    )
    return (lo | hi) & ((1 << width) - 1)
