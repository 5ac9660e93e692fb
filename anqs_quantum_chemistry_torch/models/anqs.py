"""Autoregressive neural quantum state over qudits.

Counterpart of the JAX package's ``models/anqs.py`` for ``net_type`` 'made',
'transformer' and 'nade' and the ``log_abs_phase`` head: amplitudes are real pairs
``(log|psi|, phase)``; conditionals come from one forward of the main net
per batch (optionally soft-capped, ``logit_cap``); symmetry masks
are per-qudit table lookups on the packed memo index; masked slots get NEG,
and normalization is a masked log-softmax of ``2 * log|psi|``.

``ANQS`` is an ``nn.Module`` whose ``forward`` is ``log_psi``, so
``torch.func.functional_call`` evaluates it at any parameter set (MinSR's
per-sample Jacobians, ``optim/sr.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import bits as bitops
from ..symmetries.grouping import QubitGrouping
from .made import MADE, MadeSpec
from .nade import NADE, NadeSpec
from .precision import check_precision
from .transformer import Transformer, TransformerSpec

NEG = -1e30
NET_TYPES = ("made", "transformer", "nade")


@dataclasses.dataclass(frozen=True)
class AnqsConfig:
    """The JAX ``AnqsConfig`` at its defaults (``log_abs_phase`` head, tanh
    MADE and NADE layers with biases and residuals, mean-subtracted
    conditionals), with the net type, the MADE and NADE widths, the
    transformer sizes, ``logit_cap`` and ``matmul_precision`` free, under
    JAX's names and defaults."""

    net_type: str = "made"  # 'made' | 'transformer' | 'nade'
    # MADE or NADE hidden widths of the main (log|psi|) and aux (phase) nets.
    hidden_widths: Tuple[int, ...] = (512,)
    aux_hidden_widths: Tuple[int, ...] = (512,)
    # Soft cap on the main net's raw conditionals, la -> cap tanh(la / cap),
    # before masking and normalization (None: off).
    logit_cap: Optional[float] = None
    # Multiply precision of every matmul of both nets (``precision.py``):
    # None, 'default', 'float32' and 'highest' are strict float32, on the
    # card and on the CPU alike; 'bfloat16' rounds each operand to bfloat16
    # and sums in float32. (JAX's None is the backend default: on the TPU,
    # bf16 multiplies.) Other values raise ValueError.
    matmul_precision: Optional[str] = None
    # Transformer sizes (net_type='transformer').
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256

    def __post_init__(self):
        check_precision(self.matmul_precision)


class ANQS(nn.Module):
    """Symmetry tables as buffers, the two nets as submodules (``main``:
    conditional log|psi|, ``aux``: conditional phase)."""

    def __init__(self, grouping: QubitGrouping, config: AnqsConfig = None,
                 generator: torch.Generator = None):
        super().__init__()
        self.config = config or AnqsConfig()
        self.grouping = grouping
        self.qubit_num = grouping.qubit_num
        self.n_words = bitops.n_words(self.qubit_num)
        self.qudit_num = grouping.qudit_num
        self.max_dim = grouping.max_qudit_dim
        self.qudit_starts = grouping.qudit_starts
        self.qudit_widths = grouping.qudit_widths
        self.max_width = int(max(grouping.qudit_widths))
        self.start_memo_idx = int(grouping.start_memo_idx)

        # (Q, S, D) memo transitions and continuation masks.
        self.register_buffer(
            "trans_tables",
            torch.from_numpy(grouping.trans_tables.astype(np.int64)),
            persistent=False,
        )
        self.register_buffer(
            "mask_tables", torch.from_numpy(grouping.mask_tables),
            persistent=False,
        )
        pad = np.zeros((self.qudit_num, self.max_dim), dtype=bool)
        for q, dim in enumerate(grouping.qudit_dims):
            pad[q, :dim] = True
        self.register_buffer("pad_masks", torch.from_numpy(pad),
                             persistent=False)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        spec_kwargs = dict(
            qubit_num=self.qubit_num,
            qudit_starts=grouping.qudit_starts,
            qudit_ends=grouping.qudit_ends,
            max_qudit_dim=self.max_dim,
            matmul_precision=check_precision(self.config.matmul_precision),
        )
        cfg = self.config
        if cfg.net_type == "made":
            self.main = MADE(
                MadeSpec(hidden_widths=tuple(cfg.hidden_widths),
                         **spec_kwargs),
                generator,
            )
            self.aux = MADE(
                MadeSpec(hidden_widths=tuple(cfg.aux_hidden_widths),
                         **spec_kwargs),
                generator,
            )
        elif cfg.net_type == "transformer":
            spec = TransformerSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                                   n_layers=cfg.n_layers, d_ff=cfg.d_ff,
                                   **spec_kwargs)
            self.main = Transformer(spec, generator)
            self.aux = Transformer(spec, generator)
        elif cfg.net_type == "nade":
            self.main = NADE(
                NadeSpec(hidden_widths=tuple(cfg.hidden_widths),
                         **spec_kwargs),
                generator,
            )
            self.aux = NADE(
                NadeSpec(hidden_widths=tuple(cfg.aux_hidden_widths),
                         **spec_kwargs),
                generator,
            )
        else:
            raise ValueError(f"net_type={cfg.net_type!r}: expected one of "
                             f"{NET_TYPES}")

    def reset_parameters(self, generator: torch.Generator):
        """Fresh Glorot weights from ``generator`` (main first, then aux)."""
        self.main.reset_parameters(generator)
        self.aux.reset_parameters(generator)

    # ------------------------------------------------------------------
    def normalize_cond(self, cond, mask):
        """Mask + normalize so sum_d exp(2*cond[d]) = 1 over valid slots."""
        cond = cond - torch.mean(cond, dim=-1, keepdim=True)
        cond = torch.where(mask, cond, NEG)
        norm = 0.5 * torch.logsumexp(2.0 * cond, dim=-1, keepdim=True)
        cond = cond - norm
        return torch.clamp(
            torch.nan_to_num(cond, nan=NEG, neginf=NEG), min=NEG
        )

    def memo_path(self, words):
        """Packed states (B, W) -> (memo entering each qudit (B, Q),
        continuation masks (B, Q, D))."""
        memo = torch.full((words.shape[0],), self.start_memo_idx,
                          dtype=torch.int64, device=words.device)
        memos, masks = [], []
        for q in range(self.qudit_num):
            memos.append(memo)
            masks.append(self.mask_tables[q][memo])
            v = bitops.get_bit_range(
                words, self.qudit_starts[q], self.qudit_widths[q]
            )
            memo = self.trans_tables[q][memo, v]
        return torch.stack(memos, 1), torch.stack(masks, 1)

    def qudit_values(self, words):
        """(B, W) -> (B, Q) qudit values."""
        return torch.stack(
            [
                bitops.get_bit_range(
                    words, self.qudit_starts[q], self.qudit_widths[q]
                )
                for q in range(self.qudit_num)
            ],
            1,
        )

    # ------------------------------------------------------------------
    def log_psi(self, words) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed states (B, W) -> (log_abs (B,), phase (B,))."""
        la_raw = self.main_log_abs_raw(words)
        _, masks = self.memo_path(words)
        cond = self.normalize_cond(la_raw, masks & self.pad_masks[None])
        vals = self.qudit_values(words)[..., None]
        la = torch.gather(cond, -1, vals)[..., 0]
        ph = torch.gather(self._phase_raw(words), -1, vals)[..., 0]
        return torch.clamp(torch.sum(la, -1), min=NEG), torch.sum(ph, -1)

    forward = log_psi

    def main_log_abs_raw(self, words):
        """Raw (B, Q, D) conditional log-abs of the main net, soft-capped
        by ``logit_cap``, before masking and normalization (the sampler
        skips the phase net)."""
        x = bitops.unpack(words, self.qubit_num, dtype=torch.float32)
        la = self.main(x)[..., 0]
        cap = self.config.logit_cap
        if cap:
            la = cap * torch.tanh(la / cap)
        return la

    def _phase_raw(self, words):
        """Raw per-continuation phases (B, Q, D) of ``words``."""
        x = bitops.unpack(words, self.qubit_num, dtype=torch.float32)
        return math.pi * self.aux(x)[..., 0]

    def cond_for_qudit_dyn(self, words, q: int, mask, alive=None):
        """Masked+normalized conditional log-abs of qudit ``q`` for prefix
        ``words`` (bits at qudits >= q are zero); ``alive`` (B,) gates the
        live frontier rows."""
        la_q = self.main_log_abs_raw(words)[:, q]
        if alive is not None:
            mask = mask & alive[:, None]
        return self.normalize_cond(la_q, mask & self.pad_masks[q][None])
