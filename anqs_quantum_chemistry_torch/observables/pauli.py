"""Sample-aware local energies for grouped Pauli Hamiltonians.

A slice of the JAX package's ``observables/pauli.py`` ``PauliEngine``:
matrix elements of every group for every sampled source
(``ops/matrix_elements.py``: the CUDA kernel on the card, its plain version
on the CPU), and local energies over the sampled set,

    E_loc(x) = C + sum_m <x|H|x ^ A_m> psi(x ^ A_m) / psi(x),

summed over partners x ^ A_m in the sampled set. Membership of the
partners is resolved through partner tables built once at set-up: over a
fixed sorted basis in exact summation (``local_energy_static``, plain
gathers of the basis amplitudes), or over the (N_alpha, N_beta) sector for
a sampled set (``local_energy_sector``; its amplitude table is the (N + 1,
2) layout of the JAX engine's ``table_pairs_per_row=1``); or dynamically,
from the sampled set alone (``local_energy_proxy``): a
(2^n, 2) direct-address table up to ``MAX_TABLE_QUBITS`` qubits
(``membership='table'``), or a bucket-hash table of 32 entries per bucket
for any qubit count up to 64 (``membership='hash'``; the lookup is
``ops/hash_lookup.py``, the CUDA kernel on the card). The unbiased full
local energy (``local_energy_full``) evaluates the network at every
partner instead. Amplitudes are real pairs ``(log|psi|, phase)``. Real
Hamiltonians only (every molecular JW case).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..chem.jw import PauliHamiltonian
from ..ops import bits as bitops
from ..ops import hash_lookup as hashops
from ..ops import keys
from ..ops.matrix_elements import build_tables, fused_matrix_elements

NEG = -1e30
MEMBERSHIPS = ("auto", "table", "hash")
# Memberships of the JAX engine that the port does not have yet.
UNPORTED_MEMBERSHIPS = ("search", "prefilter", "hash_dist")


class LocalEnergies(NamedTuple):
    e_re: torch.Tensor  # (B,) E_loc(x) (ratio form; diagnostics)
    e_im: torch.Tensor  # (B,)
    found_pairs: torch.Tensor  # () connected determinants found
    # Overflow-free numerators t_x = |psi(x)| E_loc(x): every term is
    # me * exp(la) with la <= 0, so no amplitude ratio can blow up. The
    # Born-weighted estimators use these: mean = sum(a t) / sum(a^2).
    # (0 where not computed: the full local energy has none.)
    t_re: torch.Tensor | float = 0.0
    t_im: torch.Tensor | float = 0.0
    # Keys dropped by hash-bucket overflow (0 for table and sector
    # membership; expected 0 for hash at its dimensioned load, and acted on
    # by the VMC trainer's overflow policy when it is not).
    table_overflow: torch.Tensor | int = 0


class PauliEngine:
    """Device-resident Hamiltonian structure + local-energy evaluation."""

    # Direct-address tables (sample -> sector index, and the dynamic
    # (2^n, 2) amplitude table) are built up to this qubit count.
    MAX_TABLE_QUBITS = 22

    def __init__(self, ham: PauliHamiltonian, device="cuda",
                 membership: str = "auto", hash_extra_bits: int = 0):
        """``membership``: 'auto' | 'table' | 'hash', the dynamic
        membership of ``local_energy_proxy``; 'auto' resolves as the JAX
        engine's does: to 'table' up to ``MAX_TABLE_QUBITS`` qubits, and
        above that to 'prefilter' (W <= 4) or 'search', which are not
        ported, so ``local_energy_proxy`` raises on such an engine (its
        matrix elements and sector local energies work).
        ``hash_extra_bits``: extra log2 bucket-count bits of the hash table
        (0 = ~25% average load; the trainer's overflow policy raises it)."""
        n_words = bitops.n_words(ham.qubit_num)
        if membership in UNPORTED_MEMBERSHIPS:
            raise NotImplementedError(
                f"membership={membership!r} is not ported (ROADMAP item 6)"
            )
        if membership not in MEMBERSHIPS:
            raise ValueError(f"membership={membership!r}: expected one of "
                             f"{MEMBERSHIPS}")
        if membership == "auto":
            if ham.qubit_num <= self.MAX_TABLE_QUBITS:
                membership = "table"
            else:
                membership = "prefilter" if n_words <= 4 else "search"
        if membership == "table" and ham.qubit_num > self.MAX_TABLE_QUBITS:
            raise ValueError(f"membership='table' needs <= "
                             f"{self.MAX_TABLE_QUBITS} qubits")
        if membership == "hash" and n_words > 2:
            raise NotImplementedError(
                "hash membership above 64 qubits (16-entry bucket rows) is "
                "not ported (ROADMAP item 6)"
            )
        self.membership = membership
        self.hash_extra_bits = hash_extra_bits
        self.qubit_num = ham.qubit_num
        self.constant = float(ham.constant)
        self.n_groups = ham.n_groups
        self.n_terms = ham.n_terms
        self.a_words = torch.from_numpy(
            np.asarray(ham.a_masks).astype(np.int64)
        ).to(device)  # (M, W)
        self.me_tables = build_tables(ham, device)

    def matrix_elements(self, words) -> torch.Tensor:
        """(B, W) packed sources -> (B, M) elements <x ^ A_m | H | x>.

        Group sums are symmetric under x <-> x^A for a real Hamiltonian, so
        signs are evaluated on the source x only."""
        return fused_matrix_elements(words, self.me_tables)

    def local_energy_static(self, words, log_abs, phase, valid,
                            partner_idx, partner_found) -> LocalEnergies:
        """Local energies over a fixed sorted basis whose membership was
        resolved at set-up (exact summation; JAX ``pauli.py:535-553``):
        ``partner_idx`` (B, M) are the partners' rows of ``words`` and
        ``partner_found`` whether they are in it, so partner amplitudes are
        plain gathers. JAX's 64-pair row table (a TPU lane layout) is not
        needed for them. Summed with ``_combine``, as JAX's is."""
        me = self.matrix_elements(words)
        la_p = torch.where(valid, log_abs, NEG)[partner_idx]
        ph_p = torch.where(valid, phase, 0.0)[partner_idx]
        found = partner_found & (la_p > 0.5 * NEG) & valid[:, None]
        return self._combine(me, la_p, ph_p, found, log_abs, phase, valid)

    def local_energy_sector(
        self, words, log_abs, phase, valid,
        sector_words, partner_idx, partner_found, sector_pos=None,
    ) -> LocalEnergies:
        """Sampled-set local energies with membership via the precomputed
        sector connectivity (JAX ``pauli.py:555-621``): (a) each sampled
        word's sector index, through the direct-address ``sector_pos`` map
        or a binary search of ``sector_words``; (b) the sampled amplitudes
        scattered into a sector-indexed (N + 1, 2) table; (c) B x M gathers
        of the partners' static sector indices."""
        me = self.matrix_elements(words)
        n_sector = sector_words.shape[0]
        if sector_pos is not None:
            key32 = words[:, 0]
            safe_key = valid & (key32 < sector_pos.shape[0])
            sidx = torch.where(
                safe_key, sector_pos[torch.where(safe_key, key32, 0)], -1
            )
            sfound = sidx >= 0
        else:
            sidx, sfound = keys.searchsorted_words(sector_words, words)
        ok = valid & sfound
        safe_s = torch.clamp(sidx, 0, n_sector - 1)
        pidx = partner_idx[safe_s]  # (B, M)
        pfnd = partner_found[safe_s] & ok[:, None]
        slot = torch.where(ok, sidx, n_sector)
        tab = torch.full((n_sector + 1, 2), NEG, dtype=torch.float32,
                         device=words.device)
        tab[slot, 0] = torch.where(ok, log_abs, NEG)
        tab[slot, 1] = phase
        rows = tab[pidx]  # (B, M, 2)
        la_p, ph_p = rows[..., 0], rows[..., 1]
        found = pfnd & (la_p > 0.5 * NEG)
        return self._combine_via_t(me, la_p, ph_p, found, log_abs, phase,
                                   valid)

    # ------------------------------------------------------------------
    # Dynamic membership
    # ------------------------------------------------------------------
    _mix2 = staticmethod(hashops.mix2)

    @staticmethod
    def _padded_cols(cols):
        """Pad a 1-word column tuple to the 2-word layout (hi = 0)."""
        if len(cols) == 1:
            return (cols[0], torch.zeros_like(cols[0]))
        return tuple(cols)

    @classmethod
    def _bucket_hash(cls, cols):
        """Bucket hash over W 32-bit key words: the 2-word mix, folded left
        over any extra words (equal to ``_mix2(lo, hi)`` for W <= 2, the
        hash that the lookup kernel computes)."""
        cols = cls._padded_cols(cols)
        acc = cls._mix2(cols[0], cols[1])
        for c in cols[2:]:
            acc = cls._mix2(acc, c)
        return acc

    def local_energy_proxy(self, sorted_words, log_abs, phase,
                           valid) -> LocalEnergies:
        """Sample-aware local energies over the unique sampled set, with
        membership resolved from the set itself (JAX ``pauli.py:443-494``).

        ``sorted_words`` rows of invalid entries must hold words that can
        never match (the VMC step writes all-ones sentinels)."""
        if self.membership in UNPORTED_MEMBERSHIPS:
            raise NotImplementedError(
                f"membership='auto' at {self.qubit_num} qubits resolves to "
                f"{self.membership!r} in the JAX engine, which is not ported "
                "(ROADMAP item 6); pass membership='hash'"
            )
        if self.membership == "table":
            return self._proxy_via_table2(sorted_words, log_abs, phase, valid)
        return self._proxy_via_hash(sorted_words, log_abs, phase, valid)

    def _proxy_via_table2(self, words, log_abs, phase, valid):
        """Direct-address membership with a (2^n, 2) table: one (q, 2) row
        gather per query (JAX ``pauli.py:678-710``). Out-of-range keys
        (sentinels) are written to a spare last row, which no query
        reads."""
        size = 1 << self.qubit_num
        keys_flat = words[:, 0]
        safe = valid & (keys_flat < size)
        kf = torch.where(safe, keys_flat, size)
        tab = torch.full((size + 1, 2), NEG, dtype=torch.float32,
                         device=words.device)
        tab[kf, 0] = torch.where(safe, log_abs, NEG)
        tab[kf, 1] = phase
        q = words[:, 0][:, None] ^ self.a_words[:, 0][None, :]  # (B, M)
        in_range = q < size
        rows = tab[torch.where(in_range, q, 0)]  # (B, M, 2)
        la_p = torch.where(in_range, rows[..., 0], NEG)
        found = (la_p > 0.5 * NEG) & valid[:, None]
        me = self.matrix_elements(words)
        return self._combine(me, la_p, rows[..., 1], found, log_abs, phase,
                             valid)

    def _proxy_via_hash(self, words, log_abs, phase, valid):
        """Membership via bucketed hash rows, any qubit count up to 64 (JAX
        ``pauli.py:728-776``, the ``lookup_kernel='pallas'`` branch): build
        the bucket table from the sampled set, then look every partner
        x ^ A_m up in it (``ops/hash_lookup.py``)."""
        tab, _, overflow = self._hash_build(words, log_abs, phase, valid)
        la_p, ph_p, found = hashops.hash_lookup(tab,
                                                *self._hash_queries(words))
        shape = (words.shape[0], self.n_groups)
        found = found.reshape(shape) & valid[:, None]
        me = self.matrix_elements(words)
        out = self._combine(me, la_p.reshape(shape), ph_p.reshape(shape),
                            found, log_abs, phase, valid)
        return out._replace(table_overflow=overflow)

    def _hash_queries(self, words):
        """The (B * M,) key words of every partner x ^ A_m as int32 bits,
        row-major over (B, M): (q_lo, q_hi), with q_hi None for one-word
        keys (their high word is 0, so nothing needs to be stored)."""
        w32 = hashops.as_int32(words)
        a32 = hashops.as_int32(self.a_words)
        cols = [(w32[:, None, i] ^ a32[None, :, i]).reshape(-1)
                for i in range(words.shape[1])]
        return cols[0], (cols[1] if len(cols) > 1 else None)

    def _hash_build(self, words, log_abs, phase, valid):
        """Scatter (key, log|psi|, phase) entries of the valid rows into
        planar bucket rows (JAX ``pauli.py:799-870``, W <= 2: 32 entries a
        bucket). Returns (table (nb, 128) float32, nb, overflow count).

        Lanes [0, 32) key_lo, [32, 64) key_hi (the keys' 32 bits, written
        through int32 so that no key is handled as a float), [64, 96)
        log|psi| (NEG = empty), [96, 128) phase. Entries are ranked within
        their bucket by a stable sort over bucket ids; buckets are sized to
        ~25% average load, so a bucket of more than 32 entries is a Poisson
        tail, counted in the overflow. Invalid and overflowing rows go to a
        spare last row, cut off at the end."""
        b, w = words.shape
        dev = words.device
        epb = hashops.ENTRIES
        nb = 1 << (max(8, (4 * b // epb - 1).bit_length())
                   + self.hash_extra_bits)
        cols = self._padded_cols(tuple(words[:, i] for i in range(w)))
        bucket = torch.where(valid, self._bucket_hash(cols) & (nb - 1), nb)
        iota = torch.arange(b, device=dev)
        sorted_b, sorted_i = torch.sort(bucket, stable=True)
        run_start = torch.ones(b, dtype=torch.bool, device=dev)
        run_start[1:] = sorted_b[1:] != sorted_b[:-1]
        start_idx = torch.cummax(torch.where(run_start, iota, 0), 0).values
        rank = torch.empty_like(iota)
        rank[sorted_i] = iota - start_idx
        overflow = valid & (rank >= epb)
        ok = valid & ~overflow
        row = torch.where(ok, bucket, nb)
        lane = torch.where(ok, rank, 0)
        neg_bits = torch.tensor(NEG, dtype=torch.float32).view(torch.int32)
        tab = torch.full((nb + 1, hashops.ROW), int(neg_bits),
                         dtype=torch.int32, device=dev)
        for i, c in enumerate(cols):
            tab[row, lane + i * epb] = hashops.as_int32(c)
        tab[row, lane + 2 * epb] = torch.where(
            valid, log_abs, NEG).view(torch.int32)
        tab[row, lane + 3 * epb] = phase.to(torch.float32).view(torch.int32)
        overflow_count = torch.sum(overflow).to(torch.int32)
        return tab[:nb].view(torch.float32), nb, overflow_count

    def _combine_via_t(self, me, la_p, ph_p, found, log_abs, phase, valid):
        """Amplitude-form partner sums computed once; the ratio-form local
        energy is e = t / a_x with a row-level exponent clip on 1/a_x (JAX
        ``pauli.py:1104``). The sector path uses it, as JAX's does; the
        dynamic paths use ``_combine``."""
        dph = ph_p - phase[:, None]
        amp_p = torch.where(found, torch.exp(la_p) * me, 0.0)
        s_re = torch.sum(amp_p * torch.cos(dph), dim=1)
        s_im = torch.sum(amp_p * torch.sin(dph), dim=1)
        a_x = torch.where(valid, torch.exp(log_abs), 0.0)
        inv_a = torch.exp(torch.clamp(-log_abs, -60.0, 60.0))
        return LocalEnergies(
            e_re=torch.where(valid, self.constant + s_re * inv_a, 0.0),
            e_im=torch.where(valid, s_im * inv_a, 0.0),
            found_pairs=torch.sum(found & valid[:, None]),
            t_re=torch.where(valid, self.constant * a_x + s_re, 0.0),
            t_im=torch.where(valid, s_im, 0.0),
        )

    def _combine(self, me, la_p, ph_p, found, log_abs, phase, valid):
        """Ratio-form local energies with the amplitude ratio of each pair
        clipped to e^(+-60), beside the same numerators t as
        ``_combine_via_t``: JAX ``PauliEngine._combine`` (``pauli.py:1132``),
        which JAX's dynamic paths use."""
        ratio = torch.exp(torch.clamp(
            torch.where(found, la_p, 0.0) - log_abs[:, None], -60.0, 60.0))
        dph = ph_p - phase[:, None]
        contrib = torch.where(found, me * ratio, 0.0)
        e_re = torch.sum(contrib * torch.cos(dph), dim=1) + self.constant
        e_im = torch.sum(contrib * torch.sin(dph), dim=1)
        a_x = torch.where(valid, torch.exp(log_abs), 0.0)
        amp_p = torch.where(found, torch.exp(la_p) * me, 0.0)
        t_re = self.constant * a_x + torch.sum(amp_p * torch.cos(dph), dim=1)
        t_im = torch.sum(amp_p * torch.sin(dph), dim=1)
        return LocalEnergies(
            e_re=torch.where(valid, e_re, 0.0),
            e_im=torch.where(valid, e_im, 0.0),
            found_pairs=torch.sum(found & valid[:, None]),
            t_re=torch.where(valid, t_re, 0.0),
            t_im=torch.where(valid, t_im, 0.0),
        )

    # ------------------------------------------------------------------
    def local_energy_full(self, anqs, words, log_abs, phase, valid,
                          amp_chunk: int = 1 << 16) -> LocalEnergies:
        """Full local energies (JAX ``pauli.py:1164-1208``): psi evaluated
        through the network at every connected x ^ A_m of every row, in
        chunks of ``amp_chunk`` partners (a row's result does not depend on
        the chunk it falls in), not only at the sampled ones."""
        b, w = words.shape
        m = self.n_groups
        xp = (words[:, None, :] ^ self.a_words[None, :, :]).reshape(-1, w)
        la_p = torch.empty(b * m, dtype=torch.float32, device=words.device)
        ph_p = torch.empty_like(la_p)
        with torch.no_grad():
            for s in range(0, b * m, amp_chunk):
                la_p[s:s + amp_chunk], ph_p[s:s + amp_chunk] = anqs.log_psi(
                    xp[s:s + amp_chunk])
        la_p = la_p.reshape(b, m)
        ph_p = ph_p.reshape(b, m)
        me = self.matrix_elements(words)
        ratio = torch.exp(torch.clamp(la_p - log_abs[:, None], -60.0, 60.0))
        dph = ph_p - phase[:, None]
        e_re = torch.sum(me * ratio * torch.cos(dph), dim=1) + self.constant
        e_im = torch.sum(me * ratio * torch.sin(dph), dim=1)
        return LocalEnergies(
            e_re=torch.where(valid, e_re, 0.0),
            e_im=torch.where(valid, e_im, 0.0),
            found_pairs=torch.tensor(b * m, device=words.device),
        )


def mc_estimate(values_re, values_im, weights) -> Tuple:
    """Weighted Monte-Carlo mean and variance (JAX ``pauli.py:1211-1219``;
    reference MonteCarloEstimator, compute_local_energies.py:47-62).
    ``weights`` must sum to 1 over valid rows (invalid rows weight 0)."""
    mean_re = torch.sum(weights * values_re)
    mean_im = torch.sum(weights * values_im)
    var = torch.sum(
        weights * ((values_re - mean_re) ** 2 + (values_im - mean_im) ** 2)
    )
    return mean_re, mean_im, var
