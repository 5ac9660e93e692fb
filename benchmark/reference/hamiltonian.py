"""Sample-aware local energies of a qubit Hamiltonian, in plain PyTorch.

The Hamiltonian is read from the molecule's npz file as the program reads
it: a constant, and Pauli terms grouped by their flip mask A_m, each term
a sign mask b_t and a real weight w_t, so that

    <x ^ A_m | H_m | x> = sum_{t in m} w_t (-1)^popcount(x & b_t).

For a set S of unique determinants and amplitudes psi = exp(la + i ph),
the sample-aware local energy keeps only the partners inside S:

    t(x) = constant a(x) + sum_{y in S, y != x or A_m = 0} <x|H'|y> a(y)
           e^{i (ph(y) - ph(x))},   E_loc(x) = t(x) / a(x).

Unlike the program, which enumerates every partner x ^ A_m of a row and
looks it up in the set, this walks the pairs (x, y) of S x S, finds the
group whose flip mask equals x ^ y, and sums that group's terms: float64
throughout, in blocks of rows.
"""

from __future__ import annotations

import numpy as np
import torch

# Pairs of one block of rows (x ^ y words) held at once.
PAIR_BLOCK = 1 << 24


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each element of an int64 tensor of 32-bit values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


class GroupedPauliHamiltonian:
    def __init__(self, npz_path: str, device="cpu"):
        with np.load(npz_path) as f:
            self.constant = float(f["ham_constant"])
            a = np.asarray(f["ham_a_masks"]).astype(np.int64)
            b = np.asarray(f["ham_b_words"]).astype(np.int64)
            self.weights = torch.as_tensor(np.asarray(f["ham_weights"],
                                                      np.float64),
                                           device=device)
            self.starts = torch.as_tensor(np.asarray(f["ham_group_starts"],
                                                     np.int64), device=device)
            self.qubit_num = int(f["qubit_num"])
            self.n_alpha = int(f["n_alpha"])
            self.n_beta = int(f["n_beta"])
            self.hf_det = int(np.asarray(f["hf_det"]).reshape(-1)[0])
        self.device = torch.device(device)
        self.a = torch.as_tensor(a, device=device)
        self.b = torch.as_tensor(b, device=device)
        self.n_words = a.shape[1]
        if len(np.unique(a, axis=0)) != len(a):
            raise ValueError("two groups share a flip mask: the pair walk "
                             "assumes one group a mask")
        # Exact keys where the qubits fit one int64.
        self.keyed = self.qubit_num <= 62
        if self.keyed:
            self.a_keys = self._key(self.a)
            self.a_order = torch.argsort(self.a_keys)
            self.a_sorted = self.a_keys[self.a_order]

    def _key(self, words):
        key = torch.zeros(words.shape[:-1], dtype=torch.int64,
                          device=words.device)
        for j in range(words.shape[-1]):
            key = key | (words[..., j] << (32 * j))
        return key

    def groups_of(self, flips: torch.Tensor) -> torch.Tensor:
        """(P, W) flip masks -> (P,) index of the group with that mask, or
        -1."""
        if self.keyed:
            key = self._key(flips)
            pos = torch.clamp(torch.searchsorted(self.a_sorted, key), max=
                              self.a_sorted.numel() - 1)
            return torch.where(self.a_sorted[pos] == key,
                               self.a_order[pos], -1)
        m = self.a.shape[0]
        _, inv = torch.unique(torch.cat([self.a, flips]), dim=0,
                              return_inverse=True)
        group = torch.full((int(inv.max()) + 1,), -1, dtype=torch.int64,
                           device=flips.device)
        group[inv[:m]] = torch.arange(m, device=flips.device)
        return group[inv[m:]]

    def group_elements(self, words: torch.Tensor, groups: torch.Tensor):
        """<x ^ A_m|H_m|x> for rows ``words`` (P, W) and groups (P,),
        float64."""
        lo, hi = self.starts[groups], self.starts[groups + 1]
        counts = hi - lo
        pair = torch.repeat_interleave(
            torch.arange(groups.numel(), device=words.device), counts)
        first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                        counts)
        term = lo[pair] + torch.arange(pair.numel(), device=words.device) \
            - first
        par = torch.zeros_like(term)
        for j in range(self.n_words):
            par = par + popcount(words[pair, j] & self.b[term, j])
        vals = self.weights[term] * (1.0 - 2.0 * (par & 1).to(torch.float64))
        out = torch.zeros(groups.numel(), dtype=torch.float64,
                          device=words.device)
        return out.index_add_(0, pair, vals)

    def pairs(self, words: torch.Tensor):
        """Every (i, j, <x_i|H'|x_j>) of the set with a group whose flip
        mask is x_i ^ x_j (the diagonal group included)."""
        s = words.shape[0]
        block = max(1, PAIR_BLOCK // max(s, 1))
        ii, jj, vv = [], [], []
        for i0 in range(0, s, block):
            x = words[i0:i0 + block]
            flips = (x[:, None, :] ^ words[None, :, :]).reshape(-1,
                                                                 self.n_words)
            g = self.groups_of(flips)
            hit = torch.nonzero(g >= 0)[:, 0]
            i = i0 + hit // s
            j = hit % s
            ii.append(i)
            jj.append(j)
            vv.append(self.group_elements(words[i], g[hit]))
        return torch.cat(ii), torch.cat(jj), torch.cat(vv)

    def local_energy_numerators(self, words, la, ph):
        """(t_re, t_im) of every row of the unique set ``words``, float64,
        from float log|psi| ``la`` and phase ``ph`` of the same rows."""
        i, j, h = self.pairs(words)
        la64 = la.to(torch.float64)
        ph64 = ph.to(torch.float64)
        amp = h * torch.exp(la64[j])
        dph = ph64[j] - ph64[i]
        a = torch.exp(la64)
        t_re = self.constant * a + torch.zeros_like(a).index_add_(
            0, i, amp * torch.cos(dph))
        t_im = torch.zeros_like(a).index_add_(0, i, amp * torch.sin(dph))
        return t_re, t_im

    def hf_neighbours(self, k: int):
        """(HF ^ A_m, |<HF ^ A_m|H|HF>|) of the k largest: the set's pinned
        rows."""
        hf = torch.as_tensor([[(self.hf_det >> (32 * j)) & 0xFFFFFFFF
                               for j in range(self.n_words)]],
                             dtype=torch.int64, device=self.device)
        m = self.a.shape[0]
        me = self.group_elements(hf.expand(m, -1),
                                 torch.arange(m, device=self.device))
        top = torch.topk(me.abs(), k)
        return hf ^ self.a[top.indices], top.values
