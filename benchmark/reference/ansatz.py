"""A MADE autoregressive neural quantum state over qudits, in plain PyTorch.

The determinant's qubits (interleaved spin-orbitals: even qubit alpha, odd
qubit beta) are cut into qudits of ``qubit_per_qudit`` consecutive qubits.
Two MADE networks (Germain et al. 2015, one hidden layer, tanh) read the
+-1 encoding 1 - 2x of the qubits: the main network gives, for every qudit
q and every continuation value v of its bits, a raw conditional log|psi|,
the aux network a raw phase (times pi). Causality comes from connectivity
masks built from degrees: input qubit i has the degree of its qudit, hidden
unit j the degree j mod max(Q - 1, 1); a hidden unit sees inputs of degree
<= its own, and an output of qudit q sees hidden units of degree < q.

The conditional of qudit q is soft-capped (cap tanh(. / cap)), centred
(its mean over all D continuations subtracted), restricted to the
continuations that can still reach the sector (N_alpha, N_beta) given the
prefix, and normalised so that sum_v exp(2 cond(v)) = 1. log|psi(x)| is the
sum of the chosen conditionals, phase(x) the sum of the chosen phases.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

NEG = -1e30


class MadeAnqs:
    """log|psi| and phase of determinants given as (B, n) 0/1 bits."""

    def __init__(self, qubit_num: int, n_alpha: int, n_beta: int,
                 qubit_per_qudit: int, logit_cap: Optional[float],
                 device="cpu"):
        n = qubit_num
        self.n = n
        self.starts = list(range(0, n, qubit_per_qudit))
        self.ends = self.starts[1:] + [n]
        self.widths = [e - s for s, e in zip(self.starts, self.ends)]
        self.q = len(self.starts)
        self.d = 1 << max(self.widths)
        self.logit_cap = logit_cap
        self.device = torch.device(device)
        q_in = np.concatenate([np.full(w, q) for q, w in
                               enumerate(self.widths)])
        self.q_in = q_in
        # Per qudit: alpha and beta electrons of each continuation value,
        # and whether the value exists (a narrower last qudit).
        cont = np.arange(self.d)
        a_cnt = np.zeros((self.q, self.d), np.int64)
        b_cnt = np.zeros((self.q, self.d), np.int64)
        exists = np.zeros((self.q, self.d), bool)
        for q, (s, w) in enumerate(zip(self.starts, self.widths)):
            exists[q] = cont < (1 << w)
            for j in range(w):
                bit = (cont >> j) & 1
                if (s + j) % 2 == 0:
                    a_cnt[q] += bit
                else:
                    b_cnt[q] += bit
        # Alpha and beta qubits after each qudit.
        after_a = np.array([sum(1 for i in range(e, n) if i % 2 == 0)
                            for e in self.ends])
        after_b = np.array([sum(1 for i in range(e, n) if i % 2 == 1)
                            for e in self.ends])
        t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.a_cnt, self.b_cnt, self.exists = t(a_cnt), t(b_cnt), t(exists)
        self.after_a, self.after_b = t(after_a), t(after_b)
        self.n_alpha, self.n_beta = int(n_alpha), int(n_beta)
        self.alpha_qubit = t(np.arange(n) % 2 == 0)
        self.qudit_of = t(q_in)
        self._masks = {}

    def masks(self, hidden: int, channels: int):
        """The (n, h) and (h, Q D C) 0/1 connectivity masks."""
        if (hidden, channels) not in self._masks:
            self._masks[hidden, channels] = self._build_masks(hidden,
                                                              channels)
        return self._masks[hidden, channels]

    def _build_masks(self, hidden: int, channels: int):
        deg = np.arange(hidden) % max(self.q - 1, 1)
        q_out = np.repeat(np.arange(self.q), self.d * channels)
        m0 = (self.q_in[:, None] <= deg[None, :]).astype(np.float32)
        m1 = (deg[:, None] < q_out[None, :]).astype(np.float32)
        return (torch.as_tensor(m0, device=self.device),
                torch.as_tensor(m1, device=self.device))

    def made(self, p: Dict[str, torch.Tensor], prefix: str, x):
        """Raw (B, Q, D) outputs of one network on the +-1 inputs x."""
        w0, w1 = p[f"{prefix}.w0"], p[f"{prefix}.w1"]
        m0, m1 = self.masks(w0.shape[1], 1)
        h = torch.tanh(x @ (w0 * m0) + p[f"{prefix}.b0"])
        out = h @ (w1 * m1) + p[f"{prefix}.b1"]
        return out.reshape(x.shape[0], self.q, self.d)

    def allowed(self, bits):
        """(B, Q, D): continuations of each qudit that keep the prefix
        extendable into the sector."""
        alpha = (bits * self.alpha_qubit).to(torch.int64)
        beta = (bits * ~self.alpha_qubit).to(torch.int64)
        ca = torch.zeros(bits.shape[0], self.q, dtype=torch.int64,
                         device=bits.device)
        cb = torch.zeros_like(ca)
        ca.index_add_(1, self.qudit_of, alpha)
        cb.index_add_(1, self.qudit_of, beta)
        # Electrons before each qudit.
        pa = torch.cumsum(ca, 1) - ca
        pb = torch.cumsum(cb, 1) - cb
        na = pa[:, :, None] + self.a_cnt[None]
        nb = pb[:, :, None] + self.b_cnt[None]
        need_a = self.n_alpha - na
        need_b = self.n_beta - nb
        return (self.exists[None] & (need_a >= 0) & (need_b >= 0)
                & (need_a <= self.after_a[None, :, None])
                & (need_b <= self.after_b[None, :, None]))

    def values(self, bits):
        """(B, Q) qudit values: bit j of qudit q is qubit start + j."""
        out = []
        for s, w in zip(self.starts, self.widths):
            weights = torch.as_tensor([1 << j for j in range(w)],
                                      device=bits.device, dtype=torch.int64)
            out.append((bits[:, s:s + w].to(torch.int64) * weights).sum(1))
        return torch.stack(out, 1)

    def log_psi(self, p: Dict[str, torch.Tensor], bits):
        """(log|psi| (B,), phase (B,)) in float32 at parameters ``p``."""
        x = 1.0 - 2.0 * bits.to(torch.float32)
        raw = self.made(p, "main", x)
        if self.logit_cap:
            raw = self.logit_cap * torch.tanh(raw / self.logit_cap)
        raw = raw - raw.mean(-1, keepdim=True)
        cond = torch.where(self.allowed(bits), raw, NEG)
        cond = cond - 0.5 * torch.logsumexp(2.0 * cond, -1, keepdim=True)
        v = self.values(bits)[..., None]
        la = torch.gather(cond, -1, v)[..., 0].sum(-1)
        phase = math.pi * torch.gather(self.made(p, "aux", x), -1,
                                       v)[..., 0].sum(-1)
        return la, phase


def words_to_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """(B, W) 32-bit words (qubit i is bit i % 32 of word i // 32) -> (B, n)
    0/1 int64."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words[..., None].to(torch.int64) >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n]

