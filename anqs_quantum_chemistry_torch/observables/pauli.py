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
(``membership='table'``), or a bucket-hash table for any qubit count up to
128 (``membership='hash'``: 32 entries a bucket up to 64 qubits, or
``hash_epb`` 8 or 16; 16 above; the lookup is ``ops/hash_lookup.py``, the
CUDA kernel on the card), or cheap-first through the same table
(``membership='prefilter'``, the JAX engine's choice above 22 qubits): a
32-bit fingerprint pass over every partner (``ops/hash_lookup.py``
``fp_filter``, kernel #3 on the card), per-row compaction of the
candidates, and exact verification of the survivors by the lookup kernel,
with a dense fallback for rows over capacity; or by a binary search of the
sorted set (``membership='search'``, any width, the JAX engine's choice
above 128 qubits); or from a bucket table sharded over the ranks of a
data-parallel mesh (``membership='hash_dist'``,
``parallel/dist_membership.py``: each rank owns nb / D buckets, entries and
queries are routed to their owners, and kernel #2 answers on each shard;
``mesh=None`` is one shard). The
unbiased full local energy (``local_energy_full``) evaluates the network at
every partner instead. Amplitudes are real pairs ``(log|psi|, phase)``.

A Hamiltonian with an odd-Y channel (``PauliHamiltonian.phase_offsets``,
the spin chains of ``applications/spin_systems.py``) gives each group a
phase: <x ^ A_m|H_m|x> = e^(i off_m) times the real element that kernel #1
computes. A local energy needs the conjugate direction <x|H|x ^ A_m>, so
``_combine``, ``_combine_via_t`` and ``local_energy_full`` rotate each
pair's phase difference by -off_m (``group_phase``, JAX
``pauli.py:247-263``). The prefilter's per-row compaction carries no such
channel, and the engine refuses the pair, as JAX's does. For a real
Hamiltonian ``group_phase`` is None and nothing changes.

Under a mesh (``mesh``, ``parallel/mesh.py``) every local-energy method
takes this rank's rows of the set: kernel #1 and the combine run on them.
'hash_dist' keeps its table sharded; every other membership (table, hash,
prefilter, search, sector, static) builds its table from the set gathered
whole (``replicate``) and queries this rank's rows only. ``found_pairs``,
``table_overflow`` and ``pf_dropped_rows`` come back summed over the ranks.

Groups come in the Hamiltonian's order, or, where the JAX engine would use
its ``'grouped'`` matrix elements (``weights_matmul``), in its class-major
order (``regroup_by_size_class``), so that ``a_words`` and the columns of
``matrix_elements`` match the JAX engine's row for row.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..chem.jw import PauliHamiltonian
from ..ops import bits as bitops
from ..ops import hash_lookup as hashops
from ..ops import keys
from ..ops.matrix_elements import build_tables, fused_matrix_elements
from ..parallel.dist_membership import hash_membership_dist
from ..parallel.mesh import all_reduce, replicate
from ..utils import spans

NEG = -1e30
MEMBERSHIPS = ("auto", "table", "hash", "prefilter", "search", "hash_dist")
# Key words up to which the hash and prefilter memberships run (128 qubits:
# JAX ``pauli.py:813``, ``:959``).
MAX_HASH_WORDS = 4
# The JAX engine's ``hash_epb`` values (W <= 2 only).
HASH_EPBS = (8, 16, 32)
# The JAX engine's matrix-element forms that fix the group order: 'split'
# keeps the Hamiltonian's, 'grouped' its class-major order; 'auto' picks
# 'grouped' where the dense (T, M) operand would exceed 2^29 elements.
WEIGHTS_MATMULS = ("auto", "split", "grouped")
GROUPED_MIN_ELEMENTS = 1 << 29
# Partner queries a row block of the search membership: bounds its (chunk,
# W) int64 query array and the search's temporaries at a few GB.
SEARCH_QUERY_CHUNK = 1 << 24


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
    # Rows whose candidate count exceeded the prefilter's row capacity and
    # did not fit its dense-row fallback: their E_loc is truncated (0 means
    # the prefilter result is exact; 0 for every other membership).
    pf_dropped_rows: torch.Tensor | int = 0


def regroup_by_size_class(ham: PauliHamiltonian) -> PauliHamiltonian:
    """The JAX engine's ``'grouped'`` group order (``_regroup_by_size_class``,
    JAX ``pauli.py:266-312``): groups stably sorted by their power-of-two
    size class. JAX also pads each group's terms to its class size (a TPU
    layout); the port keeps the terms as they are, since kernel #1 walks
    each group's CSR range."""
    starts = np.asarray(ham.group_starts).astype(np.int64)
    sizes = np.diff(starts)
    kpad = np.array([1 << max(0, int(n - 1).bit_length()) for n in sizes],
                    dtype=np.int64)
    order = np.argsort(kpad, kind="stable")
    new_sizes = sizes[order]
    new_starts = np.concatenate([[0], np.cumsum(new_sizes)])
    terms = (np.repeat(starts[order] - new_starts[:-1], new_sizes)
             + np.arange(int(new_starts[-1])))
    return PauliHamiltonian(
        qubit_num=ham.qubit_num,
        constant=ham.constant,
        a_masks=np.asarray(ham.a_masks)[order],
        b_words=np.asarray(ham.b_words)[terms],
        weights=np.asarray(ham.weights)[terms],
        group_starts=new_starts,
        phase_offsets=(None if ham.phase_offsets is None
                       else np.asarray(ham.phase_offsets)[order]),
    )


class PauliEngine:
    """Device-resident Hamiltonian structure + local-energy evaluation."""

    # Direct-address tables (sample -> sector index, and the dynamic
    # (2^n, 2) amplitude table) are built up to this qubit count.
    MAX_TABLE_QUBITS = 22

    def __init__(self, ham: PauliHamiltonian, device="cuda",
                 membership: str = "auto", hash_extra_bits: int = 0,
                 weights_matmul: str = "auto",
                 prefilter_row_capacity: int = 64,
                 prefilter_dense_rows: int = 256,
                 pf_row_chunk: Optional[int] = None,
                 me_chunk: Optional[int] = None,
                 hash_epb: Optional[int] = None,
                 mesh=None,
                 dist_entry_slack: float = 4.0,
                 dist_query_slack: float = 1.5):
        """``membership``: 'auto' | 'table' | 'hash' | 'prefilter' |
        'search' | 'hash_dist', the dynamic membership of
        ``local_energy_proxy``; 'auto'
        resolves as the JAX engine's does: to 'table' up to
        ``MAX_TABLE_QUBITS`` qubits, and above that to 'prefilter' (W <= 4)
        or 'search'. ``hash_extra_bits``: extra log2 bucket-count bits of
        the hash table (0 = ~25% average load; the trainer's overflow
        policy raises it). ``hash_epb``: entries a bucket of the hash table
        (JAX's option: 8, 16 or 32, W <= 2 only; None: 32 up to 64 qubits,
        16 above). ``weights_matmul``: 'auto' | 'split' | 'grouped', the
        JAX engine's option, which here only chooses the group order
        (module docstring). ``me_chunk``: rows a launch of the matrix
        elements (None: all). Prefilter capacities (JAX's defaults):
        candidates kept a row (``prefilter_row_capacity``), rows over it
        re-done over all groups (``prefilter_dense_rows``), and the rows a
        block of the fingerprint, compaction and verification stages
        (``pf_row_chunk``; None: one block). ``mesh``: the data-parallel
        ``parallel.mesh.Mesh`` whose rank's rows the methods take (module
        docstring; its one axis stands for JAX's ``mesh_axis``);
        ``dist_entry_slack`` and ``dist_query_slack``: the routing
        capacities of 'hash_dist' (JAX's defaults), which the trainer's
        overflow policy doubles."""
        n_words = bitops.n_words(ham.qubit_num)
        if membership not in MEMBERSHIPS:
            raise ValueError(f"membership={membership!r}: expected one of "
                             f"{MEMBERSHIPS}")
        if weights_matmul not in WEIGHTS_MATMULS:
            raise ValueError(f"weights_matmul={weights_matmul!r}: expected "
                             f"one of {WEIGHTS_MATMULS}")
        if membership == "auto":
            if ham.qubit_num <= self.MAX_TABLE_QUBITS:
                membership = "table"
            else:
                membership = "prefilter" if n_words <= 4 else "search"
        elif membership in ("hash", "prefilter", "hash_dist") and (
                n_words > MAX_HASH_WORDS):
            raise ValueError(f"{membership} membership supports <= "
                             f"{32 * MAX_HASH_WORDS} qubits")
        if hash_epb is not None and (n_words > 2
                                     or hash_epb not in HASH_EPBS):
            raise ValueError(f"hash_epb={hash_epb!r}: expected one of "
                             f"{HASH_EPBS}, at <= 64 qubits")
        if membership == "table" and ham.qubit_num > self.MAX_TABLE_QUBITS:
            raise ValueError(f"membership='table' needs <= "
                             f"{self.MAX_TABLE_QUBITS} qubits")
        has_phase = (ham.phase_offsets is not None
                     and bool(np.any(ham.phase_offsets)))
        if membership in ("prefilter", "hash_dist") and has_phase:
            # JAX pauli.py:252-262 (an assert there): these paths carry no
            # per-group phase channel. 'auto' lands here too above
            # MAX_TABLE_QUBITS qubits at W <= 4.
            raise ValueError(f"{membership} membership does not carry the "
                             "per-group phase channel of an odd-Y "
                             "Hamiltonian: use table, hash or search")
        if min(prefilter_row_capacity, prefilter_dense_rows) < 1 or any(
                chunk is not None and chunk < 1
                for chunk in (pf_row_chunk, me_chunk)):
            raise ValueError("prefilter capacities and chunks must be "
                             "positive")
        if weights_matmul == "auto":
            weights_matmul = (
                "grouped" if ham.n_terms * ham.n_groups * 2
                > GROUPED_MIN_ELEMENTS else "split")
        if weights_matmul == "grouped":
            ham = regroup_by_size_class(ham)
        self.weights_matmul = weights_matmul
        self.membership = membership
        self.hash_extra_bits = hash_extra_bits
        self.prefilter_row_capacity = prefilter_row_capacity
        self.prefilter_dense_rows = prefilter_dense_rows
        self.pf_row_chunk = pf_row_chunk
        self.me_chunk = me_chunk
        self.hash_epb = hash_epb or (32 if n_words <= 2 else 16)
        self.mesh = mesh
        self.dist_entry_slack = float(dist_entry_slack)
        self.dist_query_slack = float(dist_query_slack)
        self.qubit_num = ham.qubit_num
        self.constant = float(ham.constant)
        self.n_groups = ham.n_groups
        self.n_terms = ham.n_terms
        self.a_words = torch.from_numpy(
            np.asarray(ham.a_masks).astype(np.int64)
        ).to(device)  # (M, W)
        # (W, M) int32: the masks as planar columns for kernel #3.
        self.a_cols = hashops.as_int32(self.a_words).T.contiguous()
        self.me_tables = build_tables(ham, device)
        # (M,) float32 phase of each group, None for a real Hamiltonian.
        self.group_phase = (
            torch.from_numpy(np.asarray(ham.phase_offsets, np.float32)).to(
                device) if has_phase else None)

    def with_capacities(self, **capacities) -> "PauliEngine":
        """A copy of this engine with other membership capacities
        (``hash_extra_bits``, ``prefilter_row_capacity``,
        ``prefilter_dense_rows``, ``dist_entry_slack``,
        ``dist_query_slack``), sharing its device tables: what the
        trainer's overflow escalation rebuilds, without recutting kernel
        #1's tables on the host."""
        kinds = {"hash_extra_bits": int, "prefilter_row_capacity": int,
                 "prefilter_dense_rows": int, "dist_entry_slack": float,
                 "dist_query_slack": float}
        unknown = set(capacities) - set(kinds)
        if unknown:
            raise ValueError(f"not a capacity: {sorted(unknown)}")
        eng = copy.copy(self)
        for name, value in capacities.items():
            setattr(eng, name, kinds[name](value))
        return eng

    @property
    def sharded(self) -> bool:
        """Whether the methods take one rank's rows of a mesh of D > 1."""
        return self.mesh is not None and self.mesh.size > 1

    def _whole_set(self, rows):
        """(The whole set gathered from every rank's rows, the index of
        this rank's first row in it); ``rows`` itself and 0 unless
        sharded. The rows are blocks as ``shard_rows`` cuts them."""
        if not self.sharded:
            return rows, 0
        n = torch.tensor(rows[0].shape[0], device=rows[0].device)
        total = int(all_reduce(n, self.mesh))
        start, stop = self.mesh.row_range(total)
        if stop - start != rows[0].shape[0]:
            raise ValueError(f"rank {self.mesh.rank}: {rows[0].shape[0]} "
                             f"rows, not its block of {total}")
        return replicate(tuple(rows), self.mesh, total), start

    def _reduced(self, out: "LocalEnergies",
                 overflow_summed: bool = False) -> "LocalEnergies":
        """``out`` with ``found_pairs``, ``table_overflow`` and
        ``pf_dropped_rows`` summed over the ranks (``table_overflow``
        as it is where ``overflow_summed``)."""
        if not self.sharded:
            return out
        counts = torch.stack([torch.as_tensor(
            v, device=out.e_re.device).to(torch.int64) for v in (
                out.found_pairs, out.table_overflow, out.pf_dropped_rows)])
        summed = all_reduce(counts, self.mesh)
        return out._replace(
            found_pairs=summed[0],
            table_overflow=(out.table_overflow if overflow_summed
                            else summed[1]),
            pf_dropped_rows=summed[2])

    def matrix_elements(self, words) -> torch.Tensor:
        """(B, W) packed sources -> (B, M) elements <x ^ A_m | H | x>, in
        launches of ``me_chunk`` rows (JAX ``pauli.py:432-441``; a row's
        elements do not depend on the rows beside it).

        Group sums are symmetric under x <-> x^A for a real Hamiltonian, so
        signs are evaluated on the source x only; an odd-Y group's sum is
        antisymmetric, which its phase offset accounts for
        (``group_phase``)."""
        chunk = self.me_chunk
        if chunk is None or words.shape[0] <= chunk:
            return fused_matrix_elements(words, self.me_tables)
        return torch.cat([fused_matrix_elements(words[s:s + chunk],
                                                self.me_tables)
                          for s in range(0, words.shape[0], chunk)])

    def local_energy_static(self, words, log_abs, phase, valid,
                            partner_idx, partner_found) -> LocalEnergies:
        """Local energies over a fixed sorted basis whose membership was
        resolved at set-up (exact summation; JAX ``pauli.py:535-553``):
        ``partner_idx`` (B, M) are the partners' rows of ``words`` and
        ``partner_found`` whether they are in it, so partner amplitudes are
        plain gathers. JAX's 64-pair row table (a TPU lane layout) is not
        needed for them. Summed with ``_combine``, as JAX's is. Sharded,
        ``partner_idx`` and ``partner_found`` are this rank's rows of the
        basis's tables, indices into the whole basis."""
        with spans.span("eloc.static"):
            me = self.matrix_elements(words)
            (_, la_all, ph_all, v_all), _ = self._whole_set(
                (words, log_abs, phase, valid))
            la_p = torch.where(v_all, la_all, NEG)[partner_idx]
            ph_p = torch.where(v_all, ph_all, 0.0)[partner_idx]
            found = partner_found & (la_p > 0.5 * NEG) & valid[:, None]
            return self._reduced(
                self._combine(me, la_p, ph_p, found, log_abs, phase, valid))

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
        with spans.span("eloc.sector"):
            return self._sector(words, log_abs, phase, valid, sector_words,
                                partner_idx, partner_found, sector_pos)

    def _sector(self, words, log_abs, phase, valid, sector_words,
                partner_idx, partner_found, sector_pos):
        me = self.matrix_elements(words)
        n_sector = sector_words.shape[0]
        (w_all, la_all, ph_all, v_all), start = self._whole_set(
            (words, log_abs, phase, valid))
        if sector_pos is not None:
            key32 = w_all[:, 0]
            safe_key = v_all & (key32 < sector_pos.shape[0])
            sidx = torch.where(
                safe_key, sector_pos[torch.where(safe_key, key32, 0)], -1
            )
            sfound = sidx >= 0
        else:
            sidx, sfound = keys.searchsorted_words(sector_words, w_all)
        ok_all = v_all & sfound
        slot = torch.where(ok_all, sidx, n_sector)
        tab = torch.full((n_sector + 1, 2), NEG, dtype=torch.float32,
                         device=words.device)
        tab[slot, 0] = torch.where(ok_all, la_all, NEG)
        tab[slot, 1] = ph_all
        own = slice(start, start + words.shape[0])
        ok = ok_all[own]
        safe_s = torch.clamp(sidx[own], 0, n_sector - 1)
        pidx = partner_idx[safe_s]  # (B, M)
        pfnd = partner_found[safe_s] & ok[:, None]
        rows = tab[pidx]  # (B, M, 2)
        la_p, ph_p = rows[..., 0], rows[..., 1]
        found = pfnd & (la_p > 0.5 * NEG)
        return self._reduced(self._combine_via_t(me, la_p, ph_p, found,
                                                 log_abs, phase, valid))

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
        over any extra words (equal to ``_mix2(lo, hi)`` for W <= 2; the
        hash that the lookup kernel computes)."""
        return hashops.bucket_hash(cls._padded_cols(cols))

    @classmethod
    def _fp_hash(cls, cols):
        """Fingerprint over W key words (JAX ``_fp_hash``): ``fp32(lo,
        hi)`` for W <= 2, folded left over any extra words
        (``hashops.fp_hash``, the hash that kernel #3 computes)."""
        return hashops.fp_hash(cls._padded_cols(cols))

    def local_energy_proxy(self, sorted_words, log_abs, phase,
                           valid) -> LocalEnergies:
        """Sample-aware local energies over the unique sampled set, with
        membership resolved from the set itself (JAX ``pauli.py:443-494``).

        ``sorted_words`` rows of invalid entries must hold words that can
        never match (the VMC step writes all-ones sentinels)."""
        rows = (sorted_words, log_abs, phase, valid)
        if self.membership == "hash_dist":
            with spans.span("eloc.hash_dist"):
                return self._proxy_via_hash_dist(*rows)
        whole, start = self._whole_set(rows)
        if self.membership == "prefilter":
            # Its stages are spans of their own (pf.*).
            out = self._proxy_via_prefilter(rows, whole, start)
        else:
            with spans.span(f"eloc.{self.membership}"):
                if self.membership == "table":
                    out = self._proxy_via_table2(rows, whole)
                elif self.membership == "search":
                    out = self._proxy_via_search(rows, whole)
                else:
                    out = self._proxy_via_hash(rows, whole, start)
        return self._reduced(out)

    def _proxy_via_search(self, rows, whole):
        """Membership by a binary search of every partner x ^ A_m of the
        ``rows`` in the sorted ``whole`` set (JAX ``pauli.py:477-494``), any
        word count, in row blocks of about ``SEARCH_QUERY_CHUNK`` partners
        so that the (rows, M, W) query array stays bounded. The set's
        invalid rows hold sentinels that no partner equals."""
        words, log_abs, phase, valid = rows
        w_all, la_all, ph_all, _ = whole
        b, w = words.shape
        n_all = w_all.shape[0]
        m = self.n_groups
        step = max(1, SEARCH_QUERY_CHUNK // m)
        parts = []
        for s in range(0, b, step):
            block = words[s:s + step]
            xp = (block[:, None, :] ^ self.a_words[None, :, :]).reshape(-1, w)
            idx, found = keys.searchsorted_words(w_all, xp)
            shape = (block.shape[0], m)
            safe = torch.clamp(idx, 0, n_all - 1).reshape(shape)
            parts.append(self._combine(
                self.matrix_elements(block), la_all[safe], ph_all[safe],
                found.reshape(shape) & valid[s:s + step, None],
                log_abs[s:s + step], phase[s:s + step], valid[s:s + step]))
        return LocalEnergies(
            **{f: torch.cat([getattr(p, f) for p in parts])
               for f in ("e_re", "e_im", "t_re", "t_im")},
            found_pairs=sum(p.found_pairs for p in parts))

    def _proxy_via_table2(self, rows, whole):
        """Direct-address membership with a (2^n, 2) table of the ``whole``
        set: one (q, 2) row gather per query of the ``rows`` (JAX
        ``pauli.py:678-710``). Out-of-range keys (sentinels) are written to
        a spare last row, which no query reads."""
        words, log_abs, phase, valid = rows
        w_all, la_all, ph_all, v_all = whole
        size = 1 << self.qubit_num
        keys_flat = w_all[:, 0]
        safe = v_all & (keys_flat < size)
        kf = torch.where(safe, keys_flat, size)
        tab = torch.full((size + 1, 2), NEG, dtype=torch.float32,
                         device=words.device)
        tab[kf, 0] = torch.where(safe, la_all, NEG)
        tab[kf, 1] = ph_all
        q = words[:, 0][:, None] ^ self.a_words[:, 0][None, :]  # (B, M)
        in_range = q < size
        got = tab[torch.where(in_range, q, 0)]  # (B, M, 2)
        la_p = torch.where(in_range, got[..., 0], NEG)
        found = (la_p > 0.5 * NEG) & valid[:, None]
        me = self.matrix_elements(words)
        return self._combine(me, la_p, got[..., 1], found, log_abs, phase,
                             valid)

    def _build_whole(self, whole, start, n_rows, with_fp=False):
        """``_hash_build`` of the ``whole`` set; sharded, its overflow
        counts only the entries of this rank's ``n_rows`` rows from
        ``start``, so that the sum over the ranks is the set's."""
        kw = {"with_fp": True} if with_fp else {}
        if self.sharded:
            kw["rows"] = (start, start + n_rows)
        return self._hash_build(*whole, **kw)

    def _proxy_via_hash(self, rows, whole, start):
        """Membership via bucketed hash rows, any qubit count up to 128
        (JAX ``pauli.py:728-776``, the ``lookup_kernel='pallas'`` branch):
        build the bucket table from the ``whole`` set, then look every
        partner x ^ A_m of the ``rows`` up in it (``ops/hash_lookup.py``)."""
        words, log_abs, phase, valid = rows
        tab, _, overflow = self._build_whole(whole, start, words.shape[0])
        la_p, ph_p, found = hashops.hash_lookup(
            tab, *self._hash_queries(words), entries=self.hash_epb)
        shape = (words.shape[0], self.n_groups)
        found = found.reshape(shape) & valid[:, None]
        me = self.matrix_elements(words)
        out = self._combine(me, la_p.reshape(shape), ph_p.reshape(shape),
                            found, log_abs, phase, valid)
        return out._replace(table_overflow=overflow)

    def _proxy_via_hash_dist(self, words, log_abs, phase, valid):
        """Membership via the bucket table sharded over the mesh (JAX
        ``pauli.py:778-797``; ``parallel/dist_membership.py``): kernel #2
        on each rank's shard answers the routed partners, kernel #1 runs
        on this rank's rows, then the same ``_combine`` as 'hash'. E is
        ``hash_epb`` (JAX's hash_dist keeps its default); the bucket count
        honours ``hash_extra_bits``."""
        la_p, ph_p, overflow = hash_membership_dist(
            self.mesh, words, log_abs, phase, valid, self.a_words,
            epb=self.hash_epb, entry_slack=self.dist_entry_slack,
            query_slack=self.dist_query_slack,
            hash_extra_bits=self.hash_extra_bits)
        found = (la_p > 0.5 * NEG) & valid[:, None]
        me = self.matrix_elements(words)
        out = self._combine(me, la_p, ph_p, found, log_abs, phase, valid)
        return self._reduced(out._replace(table_overflow=overflow),
                             overflow_summed=True)

    def _hash_queries(self, words):
        """The (B * M,) key words of every partner x ^ A_m as int32 bits,
        row-major over (B, M), one column a word (a one-word key's high
        word is 0, so nothing needs to be stored for it)."""
        w32 = hashops.as_int32(words)
        a32 = hashops.as_int32(self.a_words)
        return tuple((w32[:, None, i] ^ a32[None, :, i]).reshape(-1)
                     for i in range(words.shape[1]))

    def _hash_build(self, words, log_abs, phase, valid, with_fp=False,
                    rows=None):
        """Scatter (key, log|psi|, phase) entries of the valid rows into
        planar bucket rows (JAX ``pauli.py:799-870``): E = ``hash_epb``
        entries a bucket. Returns (table (nb, (K + 2) E) float32, nb,
        overflow count), and with ``with_fp`` also the (nb, E) fingerprint
        table (each entry's ``_fp_hash`` as int32 bits, 0 for an empty
        slot) under the same bucket and rank assignment.

        Lanes [j E, (j + 1) E) key word j for the K = max(W, 2) words (the
        keys' 32 bits, written through int32 so that no key is handled as a
        float; a one-word key's high word is 0), [K E, (K + 1) E) log|psi|
        (NEG = empty), [(K + 1) E, (K + 2) E) phase. Entries are ranked
        within their bucket by a stable sort over bucket ids; buckets are
        sized to ~25% average load, so a bucket of more than E entries is a
        Poisson tail, counted in the overflow (of the (start, stop) range
        ``rows`` of the set only, where given). Invalid and overflowing
        rows go to a spare last row, cut off at the end."""
        b, w = words.shape
        dev = words.device
        epb = self.hash_epb
        nb = 1 << (max(8, (4 * b // epb - 1).bit_length())
                   + self.hash_extra_bits)
        cols = self._padded_cols(tuple(words[:, i] for i in range(w)))
        bucket = torch.where(valid, self._bucket_hash(cols) & (nb - 1), nb)
        rank = keys.rank_in_group(bucket)
        overflow = valid & (rank >= epb)
        ok = valid & ~overflow
        row = torch.where(ok, bucket, nb)
        lane = torch.where(ok, rank, 0)
        nk = len(cols)
        neg_bits = torch.tensor(NEG, dtype=torch.float32).view(torch.int32)
        tab = torch.full((nb + 1, (nk + 2) * epb), int(neg_bits),
                         dtype=torch.int32, device=dev)
        for i, c in enumerate(cols):
            tab[row, lane + i * epb] = hashops.as_int32(c)
        tab[row, lane + nk * epb] = torch.where(
            valid, log_abs, NEG).view(torch.int32)
        tab[row, lane + (nk + 1) * epb] = phase.to(torch.float32).view(
            torch.int32)
        counted = overflow if rows is None else overflow[rows[0]:rows[1]]
        overflow_count = torch.sum(counted).to(torch.int32)
        if not with_fp:
            return tab[:nb].view(torch.float32), nb, overflow_count
        fptab = torch.zeros((nb + 1, epb), dtype=torch.int32, device=dev)
        fptab[row, lane] = hashops.as_int32(self._fp_hash(cols))
        return tab[:nb].view(torch.float32), nb, overflow_count, fptab[:nb]

    def _fp_candidates(self, fptab, words):
        """Stage 1 of the prefilter: (B, M) bool, whether any entry of the
        bucket of partner x ^ A_m of the (nb, E) fingerprint table has its
        fingerprint -- no false negatives against the table, ~E /
        2^32 false positives a partner (``hashops.fp_filter``: kernel #3 on
        the card, ``fp_filter_plain`` on the CPU)."""
        return hashops.fp_filter(fptab, words.contiguous(), self.a_cols)

    def _lookup_rows(self, tab, words, m_idx=None):
        """Exact lookups of partners x ^ A_m of each row of ``words``: of
        the groups ``m_idx`` (rows, k) of each row, or of all M. Returns
        (log|psi|, phase, found), each shaped like ``m_idx`` or (rows, M)."""
        w32 = hashops.as_int32(words)
        a32 = hashops.as_int32(self.a_words)
        cols = [(w32[:, None, i] ^ (a32[:, i][m_idx] if m_idx is not None
                                    else a32[None, :, i])).reshape(-1)
                for i in range(words.shape[1])]
        la, ph, found = hashops.hash_lookup(tab, *cols,
                                            entries=self.hash_epb)
        shape = (words.shape[0], -1)
        return la.reshape(shape), ph.reshape(shape), found.reshape(shape)

    def _proxy_via_prefilter(self, rows, whole, start):
        """Cheap-first membership (JAX ``pauli.py:907-1084``) of the
        ``rows`` against the ``whole`` set:

        1. fingerprint pass over all (B, M) partners (``_fp_candidates``:
           kernel #3, which replaces no Pallas kernel -- XLA in the JAX
           package);
        2. per-row compaction: the first ``c_row = min(row capacity, M)``
           candidate groups of each row, in ascending group order (top-k of
           the keys m - idx);
        3. (a) exact verification of the B x c_row candidates, (b) a dense
           pass over all M groups for up to ``prefilter_dense_rows`` rows
           with more than c_row candidates; both look up through
           ``hash_lookup`` (kernel #2 on the card; JAX's ``_hash_query`` is
           the same function, the table's keys being unique);
        4. merge: dense rows replace their truncated sums; rows over
           capacity beyond the dense buffer are counted in
           ``pf_dropped_rows``.

        Each stage is a span (``utils/spans.py``): ``pf.build`` (the
        tables), ``pf.stage1`` (counting its ``partners``; kernel #3's
        span ``fp_filter`` inside), ``pf.stage2``
        and ``pf.stage3a`` once a row block, ``pf.stage3b``, ``pf.merge``.

        Stages 1-3a run in blocks of ``pf_row_chunk`` rows. The dense buffer
        holds min(``prefilter_dense_rows``, B) rows: at most B rows can be
        over capacity, so the result is JAX's. Sharded, the buffer takes the
        set's first rows over capacity as one process would, wherever they
        lie (``_dense_rows``)."""
        words, log_abs, phase, valid = rows
        b = words.shape[0]
        m = self.n_groups
        dev = words.device
        c_row = min(self.prefilter_row_capacity, m)
        with spans.span("pf.build"):
            tab, nb, build_overflow, fptab = self._build_whole(
                whole, start, b, with_fp=True)
            keys_m = m - torch.arange(m, dtype=torch.int32, device=dev)

        sums, counts = [], []
        chunk = self.pf_row_chunk or b
        for s in range(0, b, chunk):
            words_c, valid_c = words[s:s + chunk], valid[s:s + chunk]
            with spans.span("pf.stage1"):
                spans.count("partners", words_c.shape[0] * m)
                hit = (self._fp_candidates(fptab, words_c)
                       & valid_c[:, None])
                counts.append(torch.sum(hit, dim=1))
            with spans.span("pf.stage2"):
                kvals, m_idx = torch.topk(torch.where(hit, keys_m, 0), c_row,
                                          dim=1)
            with spans.span("pf.stage3a"):
                me = self.matrix_elements(words_c)
                la1, ph1, found1 = self._lookup_rows(tab, words_c, m_idx)
                sums.append(self._combine_rows(
                    torch.gather(me, 1, m_idx), la1, ph1,
                    found1 & (kvals > 0), phase[s:s + chunk]))

        # Stage 3b: the rows over capacity, up to the dense buffer's size.
        with spans.span("pf.stage3b"):
            over = valid & (torch.cat(counts) > c_row)
            n_all = whole[0].shape[0]
            before = self._flagged_before(over)
            rows_buf, row_ok, safe_rows = self._dense_rows(over, n_all,
                                                           before)
            rw = words[safe_rows]
            la2, ph2, found2 = self._lookup_rows(tab, rw)
            dense = self._combine_rows(self.matrix_elements(rw), la2, ph2,
                                       found2 & row_ok[:, None],
                                       phase[safe_rows])

        # Merge: dense rows overwrite their truncated stage-3a sums.
        with spans.span("pf.merge"):
            s_re, s_im, found_per_row = (torch.cat(parts)
                                         for parts in zip(*sums))
            scatter_to = torch.where(row_ok, rows_buf, b)
            s_re, s_im, found_per_row = (
                torch.cat([s1, s1.new_zeros(1)]).index_put_(
                    (scatter_to,), s2)[:b]
                for s1, s2 in zip((s_re, s_im, found_per_row), dense))

            ratio_scale = torch.exp(torch.clamp(
                -torch.where(valid, log_abs, 0.0), -60.0, 60.0))
            a_x = torch.where(valid, torch.exp(log_abs), 0.0)
            # This rank's flagged rows beyond the buffer's r places.
            r_buf = min(self.prefilter_dense_rows, n_all)
            dropped = torch.clamp(torch.sum(over) - max(r_buf - before, 0),
                                  min=0)
            return LocalEnergies(
                e_re=torch.where(valid, s_re * ratio_scale + self.constant,
                                 0.0),
                e_im=torch.where(valid, s_im * ratio_scale, 0.0),
                found_pairs=torch.sum(torch.where(valid, found_per_row, 0)),
                t_re=torch.where(valid, self.constant * a_x + s_re, 0.0),
                t_im=torch.where(valid, s_im, 0.0),
                table_overflow=build_overflow,
                pf_dropped_rows=dropped,
            )

    def _flagged_before(self, over) -> int:
        """How many rows of the ranks before this one are flagged (0
        unless sharded): where this rank's flagged rows start in the set's
        order."""
        if not self.sharded:
            return 0
        counts = replicate(torch.sum(over).reshape(1), self.mesh,
                           self.mesh.size)
        return int(torch.sum(counts[:self.mesh.rank]))

    def _dense_rows(self, over, n_all=None, before: int = 0):
        """The dense fallback's row buffer: the first r =
        min(``prefilter_dense_rows``, ``n_all``, default B) rows of the set
        flagged ``over``, in order, then filler; ``before`` flagged rows
        of the set precede these B (``_flagged_before``), so a rank's
        buffer keeps its own rows among the set's first r. Returns (r row
        indices, B for filler; which are rows; the indices clamped into
        range)."""
        b = over.shape[0]
        r_buf = min(self.prefilter_dense_rows, b if n_all is None else n_all)
        pos = torch.cumsum(over.to(torch.int64), 0) - 1 + before
        rows_buf = torch.full((r_buf + 1,), b, dtype=torch.int64,
                              device=over.device)
        rows_buf[torch.where(over & (pos < r_buf), pos, r_buf)] = (
            torch.arange(b, device=over.device))
        rows_buf = rows_buf[:r_buf]
        return rows_buf, rows_buf < b, torch.clamp(rows_buf, max=b - 1)

    @staticmethod
    def _combine_rows(me, la_p, ph_p, found, phase_x):
        """Per-row partner sums in amplitude form (JAX ``_combine_rows``,
        ``pauli.py:1086-1103``; the 1/|psi(x)| scale is the caller's):
        (sum me a_p cos, sum me a_p sin, found count), each (rows,)."""
        amp_p = torch.where(
            found, torch.exp(torch.where(found, la_p, 0.0)) * me, 0.0)
        dph = ph_p - phase_x[:, None]
        return (torch.sum(amp_p * torch.cos(dph), dim=1),
                torch.sum(amp_p * torch.sin(dph), dim=1),
                torch.sum(found, dim=1))

    def _phase_difference(self, ph_p, phase):
        """(B, M) phase of psi(x ^ A_m) / psi(x), less each group's phase
        offset where the Hamiltonian has an odd-Y channel."""
        dph = ph_p - phase[:, None]
        if self.group_phase is not None:
            dph = dph - self.group_phase[None, :]
        return dph

    def _combine_via_t(self, me, la_p, ph_p, found, log_abs, phase, valid):
        """Amplitude-form partner sums computed once; the ratio-form local
        energy is e = t / a_x with a row-level exponent clip on 1/a_x (JAX
        ``pauli.py:1104``). The sector path uses it, as JAX's does; the
        dynamic paths use ``_combine``."""
        dph = self._phase_difference(ph_p, phase)
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
        dph = self._phase_difference(ph_p, phase)
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
        the chunk it falls in), not only at the sampled ones. Sharded, on
        this rank's rows."""
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
        dph = self._phase_difference(ph_p, phase)
        e_re = torch.sum(me * ratio * torch.cos(dph), dim=1) + self.constant
        e_im = torch.sum(me * ratio * torch.sin(dph), dim=1)
        return self._reduced(LocalEnergies(
            e_re=torch.where(valid, e_re, 0.0),
            e_im=torch.where(valid, e_im, 0.0),
            found_pairs=torch.tensor(b * m, device=words.device),
        ))


def mc_estimate(values_re, values_im, weights, mesh=None) -> Tuple:
    """Weighted Monte-Carlo mean and variance (JAX ``pauli.py:1211-1219``;
    reference MonteCarloEstimator, compute_local_energies.py:47-62).
    ``weights`` must sum to 1 over valid rows (invalid rows weight 0).
    Under a ``mesh`` the rows are this rank's and the sums are all-reduced
    (never the ranks' means)."""
    mean = all_reduce(torch.stack([torch.sum(weights * values_re),
                                   torch.sum(weights * values_im)]), mesh)
    var = all_reduce(torch.sum(
        weights * ((values_re - mean[0]) ** 2 + (values_im - mean[1]) ** 2)
    ), mesh)
    return mean[0], mean[1], var
