"""Autoregressive neural quantum state over qudits.

Counterpart of the JAX package's ``models/anqs.py``: amplitudes are real
pairs ``(log|psi|, phase)``; conditionals come from one forward of the main
net per batch (optionally soft-capped, ``logit_cap``); symmetry masks are
per-qudit table lookups on the packed memo index; masked slots get NEG, and
normalization is a masked log-softmax of ``2 * log|psi|``. Every option of
JAX's ``AnqsConfig``: the net ('made' | 'transformer' | 'nade') and its
per-layer patterns, the head ('log_abs_phase': a main net for log|psi| and
an aux net for the phase, times pi; 'log_psi': one 2-channel main net, the
phase its raw channel 1), mean subtraction, the compute dtype, the masking
pattern (the last ``masking_depth`` qudits, or all with 'unmasked', sample
and normalize without the symmetry mask), spin-flip symmetrization of
log|psi| and of the phase, and a fixed sign structure in place of the phase.

``ANQS`` is an ``nn.Module`` whose ``forward`` is ``log_psi``, so
``torch.func.functional_call`` evaluates it at any parameter set (MinSR's
per-sample Jacobians, ``optim/sr.py``; ensembles, ``models/ensemble.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import bits as bitops
from ..ops import keys
from ..symmetries.grouping import QubitGrouping
from ..utils import spans
from .made import MADE, MadeSpec
from .nade import NADE, NadeSpec
from .precision import check_compute_dtype, check_precision
from .transformer import Transformer, TransformerSpec

NEG = -1e30
NET_TYPES = ("made", "transformer", "nade")
HEAD_MODES = ("log_abs_phase", "log_psi")
MASKING_MODES = ("masked", "unmasked")
# A sign structure is a dense table over every basis state (JAX's limit).
SIGN_STRUCTURE_MAX_QUBITS = 24


@dataclasses.dataclass(frozen=True)
class AnqsConfig:
    """JAX's ``AnqsConfig``: its fields, names and defaults."""

    head_mode: str = "log_abs_phase"  # or 'log_psi' (one 2-channel net)
    net_type: str = "made"  # 'made' | 'transformer' | 'nade'
    # MADE or NADE hidden widths of the main (log|psi|) and aux (phase) nets.
    hidden_widths: Tuple[int, ...] = (512,)
    aux_hidden_widths: Tuple[int, ...] = (512,)
    # MADE and NADE per-layer patterns (reference mlp.py:13-70): one
    # activation name, a tuple of one a hidden layer, or 'sanqs_paper'
    # (tanh, then leaky_relu); bias a bool or a depth + 1 tuple (the output
    # layer last); residual adds where the widths match.
    activation: object = "tanh"
    bias: object = True
    residual: bool = True
    # Subtract each conditional's mean over its continuations before the
    # mask and normalization.
    subtract_mean: bool = True
    # 'float32' | 'bfloat16': the nets' operands and stored activations
    # (``precision.store``); the products stay strict float32.
    compute_dtype: str = "float32"
    # 'masked': every qudit masked except a tail of ``masking_depth``
    # qudits that sample and normalize unmasked (reference
    # LocalSamplingConfig, abstract_anqs.py:18-50); 'unmasked': all
    # qudits. Unmasked qudits can leave the symmetry sector.
    masking_mode: str = "masked"
    masking_depth: int = 0
    # Spin-flip (alpha <-> beta) symmetrization (reference
    # SpinFlipSymmetryConfig, abstract_anqs.py:53-67): ``spin_flip_abs``
    # averages each conditional log|psi| with the flip-reindexed
    # conditional of the flipped prefix, so |psi(flip x)| == |psi(x)|;
    # ``spin_flip_phase`` averages the phase with the flipped state's and
    # adds pi * ((n_open / 2) mod 2) on the non-canonical member of each
    # {x, flip x} orbit. Both need even qudit starts and widths.
    spin_flip_abs: bool = False
    spin_flip_phase: bool = False
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
        check_compute_dtype(self.compute_dtype)
        if self.head_mode not in HEAD_MODES:
            raise ValueError(f"head_mode={self.head_mode!r}: expected one "
                             f"of {HEAD_MODES}")
        if self.masking_mode not in MASKING_MODES:
            raise ValueError(f"masking_mode={self.masking_mode!r}: expected "
                             f"one of {MASKING_MODES}")


class ANQS(nn.Module):
    """Symmetry tables as buffers, the nets as submodules (``main``:
    conditional log|psi|, and its phase too under the 'log_psi' head;
    ``aux``: conditional phase under 'log_abs_phase').

    ``sign_structure``: an optional fixed phase a basis state (values in
    {0, pi}), a table of 2**qubit_num entries (qubit_num <= 24) indexed by
    the state's first word, that replaces the learned phase (reference
    ``use_sign_structure``, abstract_anqs.py:70-109). It is a buffer, so it
    moves with the module."""

    def __init__(self, grouping: QubitGrouping, config: AnqsConfig = None,
                 generator: torch.Generator = None, sign_structure=None):
        super().__init__()
        self.config = cfg = config or AnqsConfig()
        self.grouping = grouping
        self.qubit_num = grouping.qubit_num
        self.n_words = bitops.n_words(self.qubit_num)
        self.qudit_num = grouping.qudit_num
        self.max_dim = grouping.max_qudit_dim
        self.qudit_starts = grouping.qudit_starts
        self.qudit_widths = grouping.qudit_widths
        self.max_width = int(max(grouping.qudit_widths))
        self.start_memo_idx = int(grouping.start_memo_idx)
        self.spin_flip_abs = cfg.spin_flip_abs
        self.spin_flip_phase = cfg.spin_flip_phase

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
        self.register_buffer("mu_flags", torch.from_numpy(self._mu_flags()),
                             persistent=False)

        if self.spin_flip_abs or self.spin_flip_phase:
            if sign_structure is not None:
                raise ValueError("sign_structure replaces the learned phase; "
                                 "it cannot be combined with spin-flip "
                                 "symmetrization")
            if any(s % 2 or w % 2 for s, w in zip(self.qudit_starts,
                                                  self.qudit_widths)):
                raise ValueError("spin-flip symmetrization needs every qudit "
                                 "to hold whole (alpha, beta) spin-orbital "
                                 "pairs: use an even qubit_per_qudit")
            # Local continuation index under the alpha <-> beta bit swap.
            idx = torch.arange(self.max_dim, dtype=torch.int64)
            self.register_buffer(
                "sf_cont_idx",
                ((idx & 0x55555555) << 1) | ((idx & 0xAAAAAAAA) >> 1),
                persistent=False,
            )
        if sign_structure is not None:
            if self.qubit_num > SIGN_STRUCTURE_MAX_QUBITS:
                raise ValueError(f"sign_structure needs <= "
                                 f"{SIGN_STRUCTURE_MAX_QUBITS} qubits")
            table = torch.as_tensor(sign_structure, dtype=torch.float32)
            if tuple(table.shape) != (1 << self.qubit_num,):
                raise ValueError(f"sign_structure of shape "
                                 f"{tuple(table.shape)}: expected "
                                 f"({1 << self.qubit_num},)")
            sign_structure = table.clone()
        self.register_buffer("sign_structure", sign_structure,
                             persistent=False)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        n_ch = 2 if cfg.head_mode == "log_psi" else 1
        spec_kwargs = dict(
            qubit_num=self.qubit_num,
            qudit_starts=grouping.qudit_starts,
            qudit_ends=grouping.qudit_ends,
            max_qudit_dim=self.max_dim,
            matmul_precision=check_precision(cfg.matmul_precision),
            compute_dtype=cfg.compute_dtype,
        )
        if cfg.net_type == "transformer":
            spec = TransformerSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                                   n_layers=cfg.n_layers, d_ff=cfg.d_ff,
                                   **spec_kwargs)

            def make(widths, n_channels):
                return Transformer(
                    dataclasses.replace(spec, n_channels=n_channels),
                    generator)
        elif cfg.net_type in ("made", "nade"):
            net, net_spec = ((MADE, MadeSpec) if cfg.net_type == "made"
                             else (NADE, NadeSpec))

            def make(widths, n_channels):
                return net(net_spec(hidden_widths=tuple(widths),
                                    n_channels=n_channels,
                                    activation=cfg.activation, bias=cfg.bias,
                                    residual=cfg.residual, **spec_kwargs),
                           generator)
        else:
            raise ValueError(f"net_type={cfg.net_type!r}: expected one of "
                             f"{NET_TYPES}")
        self.main = make(cfg.hidden_widths, n_ch)
        self.aux = (make(cfg.aux_hidden_widths, 1)
                    if cfg.head_mode == "log_abs_phase" else None)

    def _mu_flags(self) -> np.ndarray:
        """(Q,) bool: True where a qudit samples and normalizes under the
        symmetry mask (JAX ``models/anqs.py:135-143``)."""
        cfg = self.config
        mu = np.ones(self.qudit_num, dtype=bool)
        if cfg.masking_mode == "unmasked":
            mu[:] = False
        elif cfg.masking_depth:
            if not 0 <= cfg.masking_depth <= self.qudit_num:
                raise ValueError(f"masking_depth={cfg.masking_depth}: "
                                 f"expected 0..{self.qudit_num}")
            mu[self.qudit_num - cfg.masking_depth:] = False
        return mu

    @property
    def leaves_sector(self) -> bool:
        """Whether some qudit samples without the symmetry mask, so that
        samples can fall outside the masker's sector."""
        return not bool(np.all(self._mu_flags()))

    def reset_parameters(self, generator: torch.Generator):
        """Fresh Glorot weights from ``generator`` (main first, then aux)."""
        self.main.reset_parameters(generator)
        if self.aux is not None:
            self.aux.reset_parameters(generator)

    # ------------------------------------------------------------------
    def normalize_cond(self, cond, mask):
        """Mask + normalize so sum_d exp(2*cond[d]) = 1 over valid slots."""
        if self.config.subtract_mean:
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
        masks = masks | ~self.mu_flags[None, :, None]  # unmasked qudits
        cond = self.normalize_cond(la_raw, masks & self.pad_masks[None])
        vals = self.qudit_values(words)[..., None]
        la = torch.gather(cond, -1, vals)[..., 0]
        phase = torch.sum(torch.gather(self._phase_raw(words), -1, vals)[
            ..., 0], -1)
        if self.spin_flip_phase:
            # The symmetrized phase, plus the fermionic reordering sign on
            # the non-canonical member of each {x, flip x} orbit: reversing
            # n_open open-shell electrons costs parity n_open (n_open - 1)
            # / 2 == n_open / 2 (mod 2) (JAX ``models/anqs.py:314-333``).
            flipped = bitops.interleave_swap(words, self.qubit_num)
            vals_f = self.qudit_values(flipped)[..., None]
            phase_f = torch.sum(torch.gather(
                self._phase_raw(flipped), -1, vals_f)[..., 0], -1)
            n_diff = bitops.popcount(words ^ flipped)
            pi_mult = ((n_diff // 4) % 2).to(torch.float32)
            is_cano = ~keys.lex_less(words, flipped)  # x >= flip(x)
            phase = 0.5 * (phase + phase_f) + math.pi * torch.where(
                is_cano, 0.0, pi_mult)
        if self.sign_structure is not None:
            flat = words[..., 0] & ((1 << self.qubit_num) - 1)
            phase = self.sign_structure[flat]
        return torch.clamp(torch.sum(la, -1), min=NEG), phase

    forward = log_psi

    def amplitude(self, words) -> Tuple[torch.Tensor, torch.Tensor]:
        """Complex amplitudes of ``words`` as a (re, im) pair of float32
        tensors (JAX ``models/anqs.py:341-345``)."""
        la, ph = self.log_psi(words)
        mag = torch.exp(la)
        return mag * torch.cos(ph), mag * torch.sin(ph)

    def main_log_abs_raw(self, words):
        """Raw (B, Q, D) conditional log-abs of the main net, soft-capped
        by ``logit_cap``, before masking and normalization (the sampler
        skips the phase net). With ``spin_flip_abs`` it is averaged with
        the flip-reindexed conditional of the flipped prefix,
        cond'(c|p) = (cond(c|p) + cond(flip c|flip p)) / 2 (JAX
        ``models/anqs.py:347-370``)."""
        x = bitops.unpack(words, self.qubit_num, dtype=torch.float32)
        la = self.main(x)[..., 0]
        if self.spin_flip_abs:
            xf = bitops.unpack(bitops.interleave_swap(words, self.qubit_num),
                               self.qubit_num, dtype=torch.float32)
            la_f = self.main(xf)[..., 0]
            la = 0.5 * (la + la_f[..., self.sf_cont_idx])
        return self._cap(la)

    def _cap(self, la):
        cap = self.config.logit_cap
        if cap:
            la = cap * torch.tanh(la / cap)
        return la

    def _phase_raw(self, words):
        """Raw per-continuation phases (B, Q, D) of ``words``: the main
        net's channel 1 under the 'log_psi' head, else pi times the aux
        net's output."""
        x = bitops.unpack(words, self.qubit_num, dtype=torch.float32)
        if self.aux is None:
            return self.main(x)[..., 1]
        return math.pi * self.aux(x)[..., 0]

    def cond_for_qudit(self, words, q: int, mask):
        """Masked+normalized conditional log-abs of qudit ``q`` for prefix
        ``words`` (JAX ``models/anqs.py:381-389``): ``cond_for_qudit_dyn``
        without the live-row gating."""
        return self.cond_for_qudit_dyn(words, q, mask)

    def cond_for_qudit_dyn(self, words, q: int, mask, alive=None):
        """Masked+normalized conditional log-abs of qudit ``q`` for prefix
        ``words`` (bits at qudits >= q are zero); ``alive`` (B,) gates the
        live frontier rows, and an unmasked qudit drops the symmetry mask
        but keeps that gating. With the transformer it counts
        ``tx_sample_positions`` (``utils/spans.py``): the positions the main
        net computes for this answer, every qudit's of every row."""
        if self.config.net_type == "transformer":
            spans.count("tx_sample_positions",
                        words.shape[0] * self.qudit_num
                        * (2 if self.spin_flip_abs else 1))
        return self._gated_cond(self.main_log_abs_raw(words)[:, q], q, mask,
                                alive)

    def _gated_cond(self, la_q, q: int, mask, alive):
        if alive is not None:
            mask = (mask | ~self.mu_flags[q]) & alive[:, None]
        return self.normalize_cond(la_q, mask & self.pad_masks[q][None])

    def decode_cache(self, rows: int):
        """A key/value cache for an ancestral draw of up to ``rows``
        frontier rows, where the main net decodes one position at a time
        (the transformer) and the conditional is not flip-averaged; else
        None, and the draw asks ``cond_for_qudit_dyn``."""
        if self.spin_flip_abs or not isinstance(self.main, Transformer):
            return None
        return self.main.decode_cache(rows, self.trans_tables.device)

    def cond_for_qudit_cached(self, cache, words, q: int, mask, alive):
        """``cond_for_qudit_dyn`` with the main net run at position ``q``
        alone, against ``cache`` (``decode_cache``), which holds the keys
        and values of positions < q of the rows of ``words`` (the caller
        reorders it with the frontier: ``DecodeCache.advance``). Counts one
        ``tx_sample_positions`` a row."""
        rows = words.shape[0]
        spans.count("tx_sample_positions", rows)
        prev = (bitops.get_bit_range(words, self.qudit_starts[q - 1],
                                     self.qudit_widths[q - 1])
                if q else words.new_zeros(rows))
        la_q = self._cap(self.main.decode(cache, prev, q)[..., 0])
        return self._gated_cond(la_q, q, mask, alive)
