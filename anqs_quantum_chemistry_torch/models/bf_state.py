"""Brute-force dense quantum state: a 2^n table of (log|psi|, phase).

Counterpart of the JAX package's ``models/bf_state.py`` (reference
BFQuantumState, bf_quantum_state.py:9-41): exact amplitudes and exact
multinomial sampling over the whole basis for up to 20 qubits, the test
oracle for ansatz components. The tables live on ``device``; random draws
come from the caller's ``torch.Generator``, and ``sample_counts`` takes an
injectable count source, as the samplers take injectable uniforms.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..ops import bits as bitops

MAX_QUBITS = 20


class BFState:
    def __init__(self, qubit_num: int, device="cuda"):
        if qubit_num > MAX_QUBITS:
            raise ValueError(f"BFState holds <= {MAX_QUBITS} qubits")
        self.qubit_num = qubit_num
        self.dim = 2**qubit_num
        self.n_words = bitops.n_words(qubit_num)
        self.device = torch.device(device)

    def init(self, generator: torch.Generator,
             support=None) -> Dict[str, torch.Tensor]:
        """A random normalized state: normal log|psi| and pi-times-normal
        phases drawn from ``generator`` (on its device); with ``support``
        (basis indices) log|psi| is -inf elsewhere."""
        log_abs = torch.randn(self.dim, generator=generator,
                              device=generator.device).to(self.device)
        phase = math.pi * torch.randn(self.dim, generator=generator,
                                      device=generator.device).to(self.device)
        if support is not None:
            mask = torch.zeros(self.dim, dtype=torch.bool, device=self.device)
            mask[torch.as_tensor(support, device=self.device)] = True
            log_abs = torch.where(mask, log_abs, -torch.inf)
        log_abs = log_abs - 0.5 * torch.logsumexp(2.0 * log_abs, 0)
        return {"log_abs": log_abs, "phase": phase}

    def _flat_index(self, words):
        return words[..., 0] % self.dim

    def log_psi(self, params, words):
        """(B, W) words -> (log_abs (B,), phase (B,))."""
        idx = self._flat_index(words)
        return params["log_abs"][idx], params["phase"][idx]

    def probs(self, params):
        p = torch.exp(2.0 * params["log_abs"])
        return p / torch.sum(p)

    def basis_words(self):
        """(2^n, W) packed words of every basis state, in index order."""
        idx = torch.arange(self.dim, dtype=torch.int64, device=self.device)
        bits = (idx[:, None] >> torch.arange(
            self.qubit_num, device=self.device)[None, :]) & 1
        return bitops.pack(bits)

    def sample_counts(self, params, sample_num: int,
                      generator: Optional[torch.Generator] = None,
                      draw: Optional[Callable] = None):
        """Exact multinomial over the whole basis: (words (2^n, W), counts
        (2^n,) int64). ``draw(sample_num, probs)`` gives the counts (the
        tests pass JAX's); by default ``torch.multinomial`` draws
        ``sample_num`` states from ``generator``."""
        p = self.probs(params)
        if draw is None:
            picks = torch.multinomial(p, sample_num, replacement=True,
                                      generator=generator)
            counts = torch.bincount(picks, minlength=self.dim)
        else:
            counts = torch.as_tensor(draw(sample_num, p),
                                     device=self.device)
        return self.basis_words(), counts.to(torch.int64)
