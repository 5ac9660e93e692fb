"""Sample-aware local energies for grouped Pauli Hamiltonians, sector path.

The main-path slice of the JAX package's ``observables/pauli.py``
``PauliEngine``: matrix elements of every group for every sampled source
(``ops/matrix_elements.py``: the CUDA kernel on the card, its plain version
on the CPU), and local energies over the sampled set with membership
resolved through the precomputed connectivity of the (N_alpha, N_beta)
sector (``local_energy_sector``; its amplitude table is the (N + 1, 2)
layout of the JAX engine's ``table_pairs_per_row=1``):

    E_loc(x) = C + sum_m <x|H|x ^ A_m> psi(x ^ A_m) / psi(x),

summed over partners x ^ A_m in the sampled set. Amplitudes are real pairs
``(log|psi|, phase)``. Real Hamiltonians only (every molecular JW case).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..chem.jw import PauliHamiltonian
from ..ops import keys
from ..ops.matrix_elements import build_tables, fused_matrix_elements

NEG = -1e30


class LocalEnergies(NamedTuple):
    e_re: torch.Tensor  # (B,) E_loc(x) (ratio form; diagnostics)
    e_im: torch.Tensor  # (B,)
    found_pairs: torch.Tensor  # () connected determinants found
    # Overflow-free numerators t_x = |psi(x)| E_loc(x): every term is
    # me * exp(la) with la <= 0, so no amplitude ratio can blow up. The
    # Born-weighted estimators use these: mean = sum(a t) / sum(a^2).
    t_re: torch.Tensor
    t_im: torch.Tensor


class PauliEngine:
    """Device-resident Hamiltonian structure + local-energy evaluation."""

    # Direct-address sample -> sector-index maps are built up to this qubit
    # count (2^22 int64 entries = 32 MB).
    MAX_TABLE_QUBITS = 22

    def __init__(self, ham: PauliHamiltonian, device="cuda"):
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

    def _combine_via_t(self, me, la_p, ph_p, found, log_abs, phase, valid):
        """Amplitude-form partner sums computed once; the ratio-form local
        energy is e = t / a_x with a row-level exponent clip on 1/a_x (JAX
        ``pauli.py:1104``)."""
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
