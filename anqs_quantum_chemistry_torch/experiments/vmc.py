"""VMC energy optimization: the training step and its driver loop.

A slice of the JAX package's ``experiments/vmc.py``: Gumbel top-k sampling
of unique determinants -> amplitudes -> sample-aware local energies ->
Born-weighted float64 estimators -> REINFORCE surrogate loss -> gradient ->
MinSR -> global-norm clip -> Adam that skips non-finite updates. Membership
of the local energies' partners goes through the precomputed sector
connectivity where the (N_alpha, N_beta) sector is small enough (the N2
main path, ``main_path_vmc``), and otherwise through the engine's dynamic
membership over the canonically sorted sample set (the Li2O toy model,
``li2o_vmc``: hash membership at 30 qubits). The surrogate loss is

    loss = 2 sum_x f(x) [ log|psi(x)| Re(dE) + phase(x) Im(dE) ],

whose gradient equals the VMC energy gradient with f and E_loc held
constant: the local energies are computed without autograd.

Entry points: ``VMC(mol, VMCConfig(...), AnqsConfig(...))``,
``init_state()``, ``step(state)`` and ``run(state, n)``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..chem.fci import SECTOR_MAX_DETS, sector_determinants
from ..chem.molecule import Molecule
from ..models.anqs import ANQS, AnqsConfig
from ..observables.pauli import PauliEngine
from ..ops import bits as bitops
from ..ops import keys
from ..optim.sr import SRConfig, clip_grad_norm, sr_transform
from ..sampling.sampler import SamplingConfig, sample
from ..symmetries import QubitGrouping
from ..utils.config import Config
from .preparation import create_masker

# Sector membership is built up to these sizes (the JAX ``VMCConfig``
# defaults): sector determinants (``SECTOR_MAX_DETS``, shared with
# ``chem/fci.py``), and determinants x groups of the partner tables.
SECTOR_MAX_ENTRIES = 48_000_000
# A step that reports keys dropped by hash-bucket overflow doubles the
# bucket count and rebuilds the engine, at most this many times; then the
# trainer raises (the JAX ``VMCConfig.max_overflow_escalations`` default).
MAX_OVERFLOW_ESCALATIONS = 6


@dataclasses.dataclass
class VMCConfig(Config):
    """The fields of the JAX ``VMCConfig`` that the ported path reads, and
    the engine's membership (JAX ``engine_overrides["membership"]``)."""

    sample_num: int = 2000
    sampling_mode: str = "gumbel"
    symmetry_level: str = "e_num_spin"
    qubit_per_qudit: int = 6
    lr: float = 1e-3
    sr: Optional[SRConfig] = None
    grad_clip_norm: Optional[float] = None
    # T > 1 weights the surrogate loss by |psi|^(2/T) (the estimators stay
    # Born); 1.0 = plain Born weights.
    grad_weight_temperature: float = 1.0
    seed: int = 0
    # The engine's dynamic membership ('auto' | 'table' | 'hash'). With
    # 'auto' the step uses the precomputed partner connectivity of the
    # (N_alpha, N_beta) sector where it fits the limits above; otherwise
    # (and with any named membership) it sorts the sample set and the
    # engine resolves partners from the set itself.
    membership: str = "auto"


class FiniteGuardAdam:
    """``optax.apply_if_finite(optax.adam(lr), max_consecutive_errors)``:
    an update whose gradients hold a NaN or an Inf is skipped (parameters
    and Adam moments untouched) until more than ``max_consecutive_errors``
    such updates come in a row; then it is applied anyway."""

    def __init__(self, params, lr: float, max_consecutive_errors: int = 100):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.total_notfinite = 0

    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Apply ``grads`` (one per parameter); returns whether applied."""
        finite = bool(
            torch.stack([torch.isfinite(g).all() for g in grads]).all()
        )
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
            if self.notfinite_count <= self.max_consecutive_errors:
                return False
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        return True


class TrainState(NamedTuple):
    opt: FiniteGuardAdam
    generator: torch.Generator  # sampler noise


class VMC:
    """The full stack for one molecule: masker, grouping, ansatz, Pauli
    engine and the static sector tables."""

    def __init__(self, mol: Molecule, config: VMCConfig = None,
                 anqs_config: AnqsConfig = None, device="cuda"):
        self.mol = mol
        self.config = config or VMCConfig()
        self.device = torch.device(device)
        if self.config.sampling_mode != "gumbel":
            raise NotImplementedError(
                f"sampling_mode={self.config.sampling_mode!r} is not ported"
            )
        self.ham = mol.qubit_ham
        n = self.ham.qubit_num
        self.masker = create_masker(mol, self.config.symmetry_level)
        self.grouping = QubitGrouping.create(
            self.masker, qubit_per_qudit=self.config.qubit_per_qudit
        )
        self.anqs = ANQS(
            self.grouping, anqs_config or AnqsConfig(),
            torch.Generator().manual_seed(self.config.seed),
        ).to(self.device)
        self._overflow_escalations = 0
        self.engine = PauliEngine(self.ham, device=self.device,
                                  membership=self.config.membership)
        self.sampling_config = SamplingConfig(
            sample_num=self.config.sample_num, mode="gumbel"
        )
        hf_bits = torch.tensor([[(mol.hf_det >> i) & 1 for i in range(n)]])
        self.hf_words = bitops.pack(hf_bits).to(self.device)

        self.sector_words = None
        self.sector_pos = None
        if not self._want_sector_membership(mol):
            return
        dets, words_packed, _, n_real = self._enumerate_sector(mol, n)
        idx, pf = self._sector_partner_tables(dets, n_real)
        self.sector_words = words_packed
        self.sector_partner_idx = idx
        self.sector_partner_found = pf
        if n <= PauliEngine.MAX_TABLE_QUBITS:
            # Direct-address sample -> sector-index map: one gather per
            # sample and no canonical sort of the sample set (JAX
            # ``vmc.py:359``). Above the limit the sorted sample set is
            # searched in the sector, all W words compared.
            pos = np.full(1 << n, -1, dtype=np.int64)
            pos[dets.astype(np.int64)] = np.arange(n_real, dtype=np.int64)
            self.sector_pos = torch.from_numpy(pos).to(self.device)

    def _want_sector_membership(self, mol) -> bool:
        """JAX ``vmc.py:425-443`` in its 'auto' mode, whatever the engine's
        dynamic membership resolved to."""
        if self.config.membership != "auto" or self.ham.qubit_num > 64:
            return False  # a named dynamic membership is used as named
        ndet = int(mol.fci_ndet)
        return (ndet <= SECTOR_MAX_DETS
                and ndet * self.ham.n_groups <= SECTOR_MAX_ENTRIES)

    def _enumerate_sector(self, mol, n):
        """Sorted sector (uint64 dets), packed words padded with all-ones
        sentinel rows to a multiple of 64, valid mask, real count."""
        dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
        bits = ((dets[:, None] >> np.arange(n, dtype=np.uint64)[None, :])
                & np.uint64(1)).astype(np.int64)
        n_real = len(dets)
        pad = (-n_real) % 64
        if pad:
            bits = np.concatenate([bits, np.ones((pad, n), dtype=np.int64)])
        words_packed = bitops.pack(torch.from_numpy(bits)).to(self.device)
        valid = torch.arange(n_real + pad, device=self.device) < n_real
        return dets, words_packed, valid, n_real

    def _sector_partner_tables(self, dets, n_real):
        """Host-side searchsorted of every det's M connected partners into
        the sorted sector: (N_padded, M) indices + found mask."""
        a_np = np.asarray(self.ham.a_masks).astype(np.uint64)
        a_ints = a_np[:, 0]
        if a_np.shape[1] > 1:
            a_ints = a_ints | (a_np[:, 1] << np.uint64(32))
        partner = dets[:, None] ^ a_ints[None, :]
        idx = np.clip(np.searchsorted(dets, partner), 0, n_real - 1)
        pf = dets[idx] == partner
        pad = (-n_real) % 64
        if pad:
            idx = np.concatenate(
                [idx, np.zeros((pad, len(a_ints)), idx.dtype)]
            )
            pf = np.concatenate([pf, np.zeros((pad, len(a_ints)), bool)])
        return (torch.from_numpy(idx.astype(np.int64)).to(self.device),
                torch.from_numpy(pf).to(self.device))

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Fresh ansatz weights, Adam state and sampler generator, all from
        ``config.seed``."""
        seed = self.config.seed
        self.anqs.reset_parameters(torch.Generator().manual_seed(seed))
        opt = FiniteGuardAdam(self.anqs.parameters(), self.config.lr)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(opt=opt, generator=gen)

    def _support_and_eloc(self, state: TrainState, uniforms=None):
        """Sample the unique-determinant support, evaluate amplitudes and
        sample-aware local energies (no autograd)."""
        with torch.no_grad():
            words, weights, valid, stats = sample(
                self.anqs, self.sampling_config, state.generator, uniforms
            )
            # Invalid rows become all-ones sentinels that never match.
            words = torch.where(valid[:, None], words, bitops.MASK32)
            if self.sector_pos is None:
                # Canonical order (JAX ``vmc.py:955-966``; Gumbel samples
                # are unique, so no dedup). Only the sector path's position
                # map needs no sort.
                words, _, weights, valid = keys.sort_words(words, weights,
                                                           valid)
            la, ph = self.anqs.log_psi(words)
            if self.sector_words is None:
                e = self.engine.local_energy_proxy(words, la, ph, valid)
            else:
                e = self.engine.local_energy_sector(
                    words, la, ph, valid, self.sector_words,
                    self.sector_partner_idx, self.sector_partner_found,
                    sector_pos=self.sector_pos,
                )
        return words, weights, valid, stats, la, ph, e

    def _grads_and_metrics(self, state: TrainState, uniforms=None):
        """Everything of a step before the optimizer: (metrics as device
        scalars, preconditioned and clipped gradients by parameter name)."""
        cfg = self.config
        words, weights, valid, stats, la, ph, e = self._support_and_eloc(
            state, uniforms
        )
        # Born weights; float64 estimators in the overflow-free numerator
        # form (p_x E_x = a_x t_x; p_x |E_x|^2 = |t_x|^2). At |E| ~ 100 Ha
        # the float32 cancellation in sum|t|^2 - |mean|^2 is ~1e-3 Ha^2.
        theor = torch.where(valid, torch.exp(2.0 * la), 0.0)
        freqs = theor / torch.clamp(torch.sum(theor), min=1e-30)
        a_x = torch.where(valid, torch.exp(la), 0.0).to(torch.float64)
        t_re = e.t_re.to(torch.float64)
        t_im = e.t_im.to(torch.float64)
        denom = torch.clamp(torch.sum(a_x**2), min=1e-300)
        mean_re64 = torch.sum(a_x * t_re) / denom
        mean_im64 = torch.sum(a_x * t_im) / denom
        var = (torch.sum(t_re**2 + t_im**2) / denom
               - mean_re64**2 - mean_im64**2).to(torch.float32)
        mean_re = mean_re64.to(torch.float32)
        mean_im = mean_im64.to(torch.float32)
        d_re = torch.where(valid, e.e_re - mean_re, 0.0)
        d_im = torch.where(valid, e.e_im - mean_im, 0.0)

        temp = cfg.grad_weight_temperature
        if temp != 1.0:
            la_max = torch.max(torch.where(valid, la, -torch.inf))
            tempered = torch.where(
                valid, torch.exp((2.0 / temp) * (la - la_max)), 0.0
            )
            grad_freqs = tempered / torch.clamp(torch.sum(tempered),
                                                min=1e-30)
        else:
            grad_freqs = freqs

        params = dict(self.anqs.named_parameters())
        la_g, ph_g = self.anqs.log_psi(words)
        la_g = torch.where(valid, la_g, 0.0)
        ph_g = torch.where(valid, ph_g, 0.0)
        loss = 2.0 * torch.sum(grad_freqs * (la_g * d_re + ph_g * d_im))
        grads = dict(
            zip(params, torch.autograd.grad(loss, list(params.values())))
        )

        if cfg.sr is not None:
            grads = sr_transform(self.anqs, params, grads, words, grad_freqs,
                                 cfg.sr)
        if cfg.grad_clip_norm is not None:
            grads, _ = clip_grad_norm(grads, cfg.grad_clip_norm)

        # HF-projected local energy: E_loc at the HF row if it was sampled.
        hf_match = torch.all(words == self.hf_words[0][None, :], dim=1) & valid
        hf_e = torch.where(
            torch.any(hf_match),
            torch.sum(torch.where(hf_match, e.e_re, 0.0)),
            torch.nan,
        )
        n_valid = torch.sum(valid)
        metrics = {
            "energy": mean_re,
            "energy_imag": mean_im,
            "energy_var": var,
            "unique_num": n_valid,
            "sampled_prob": torch.sum(theor),
            "found_pairs": e.found_pairs,
            "hf_proj_energy": hf_e,
            "grad_norm": torch.linalg.vector_norm(
                torch.cat([g.reshape(-1) for g in grads.values()])
            ),
            "max_log_abs": torch.max(torch.where(valid, la, -torch.inf)),
            "ipr": torch.sum(freqs**2),
            "dropped": torch.tensor(stats["dropped"]),
            "min_log_abs": torch.min(torch.where(valid, la, torch.inf)),
            "found_ratio": e.found_pairs
            / torch.clamp(n_valid * self.engine.n_groups, min=1),
            "table_overflow": torch.as_tensor(e.table_overflow),
        }
        return metrics, grads

    def step(self, state: TrainState, uniforms=None) -> dict:
        """One training step; returns the metrics as Python floats.
        ``uniforms`` (tests) replaces the sampler's own noise."""
        metrics, grads = self._grads_and_metrics(state, uniforms)
        state.opt.step(list(grads.values()))
        with torch.no_grad():
            metrics["hf_log_abs"] = self.anqs.log_psi(self.hf_words)[0][0]
        names = list(metrics)
        values = torch.stack(
            [metrics[k].to(device="cpu", dtype=torch.float64) for k in names]
        ).tolist()
        return dict(zip(names, values))

    def run(self, state: TrainState, n_steps: int) -> List[dict]:
        """``n_steps`` training steps, each followed by the overflow check;
        returns one metrics row per step."""
        rows = []
        for _ in range(n_steps):
            rows.append(self.step(state))
            self._handle_overflow(rows[-1])
        return rows

    def _handle_overflow(self, row: dict):
        """Act on a step's hash-bucket overflow (JAX ``vmc.py:820-871``,
        policy 'escalate', threshold 0): double the bucket count and rebuild
        the engine, and raise once ``MAX_OVERFLOW_ESCALATIONS`` did not
        suffice, since dropped keys bias E_loc low."""
        dropped = int(row.get("table_overflow", 0))
        if dropped == 0:
            return
        msg = f"membership overflow: table_overflow={dropped}"
        if self._overflow_escalations >= MAX_OVERFLOW_ESCALATIONS:
            raise RuntimeError(
                msg + " (escalation cap reached); E_loc would be silently "
                "biased low"
            )
        self._overflow_escalations += 1
        extra_bits = self.engine.hash_extra_bits + 1
        logging.warning("%s -> escalation #%d: rebuilding engine with "
                        "hash_extra_bits=%d", msg,
                        self._overflow_escalations, extra_bits)
        self.engine = PauliEngine(self.ham, device=self.device,
                                  membership=self.engine.membership,
                                  hash_extra_bits=extra_bits)


def it_targets(la, ph, e_re, e_im, valid, tau: float):
    """Imaginary-time target amplitudes from a sample's local energies.

    |phi> = (1 - tau (H - E_born)) |psi> restricted to the support, in the
    scale-free ratio form, float64 throughout (tail |E_loc| can reach ~1e28
    and |f|^2 overflows float32). Returns (la_target, ph_target, E_born_re)
    with invalid rows zeroed (JAX ``vmc.py:1666-1695``)."""
    la64 = la.to(torch.float64)
    a = torch.where(valid, torch.exp(la64), 0.0)
    er = e_re.to(torch.float64)
    ei = e_im.to(torch.float64)
    denom = torch.clamp(torch.sum(a * a), min=1e-300)
    m_re = torch.sum(a * a * er) / denom
    m_im = torch.sum(a * a * ei) / denom
    f_re = 1.0 - tau * (er - m_re)
    f_im = -tau * (ei - m_im)
    mag2 = f_re * f_re + f_im * f_im
    la_t = la64 + 0.5 * torch.log(torch.clamp(mag2, min=1e-300))
    ph_t = ph.to(torch.float64) + torch.atan2(f_im, f_re)
    la_t = torch.where(valid, la_t, 0.0).to(torch.float32)
    ph_t = torch.where(valid, ph_t, 0.0).to(torch.float32)
    return la_t, ph_t, m_re


def main_path_vmc(device="cuda", hidden_width: int = 512) -> VMC:
    """The main-path workload (JAX ``bench.py:build_vmc("gumbel")``,
    ``examples/n2_convergence.py``): N2/STO-3G, MADE ``hidden_width``,
    qubit_per_qudit 10, Gumbel top-k over the whole 14400-determinant
    sector (14464 rows), sector membership, MinSR top-50, clip 1.0, Adam
    1e-3, seed 0."""
    from ..chem.molecule import load_n2

    return VMC(
        load_n2(),
        VMCConfig(
            sample_num=14464, sampling_mode="gumbel", qubit_per_qudit=10,
            lr=1e-3, grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
            seed=0,
        ),
        AnqsConfig(hidden_widths=(hidden_width,),
                   aux_hidden_widths=(hidden_width,)),
        device=device,
    )


def li2o_vmc(device="cuda", hidden_width: int = 512) -> VMC:
    """The reference's documented toy workload (its Colab notebook, JAX
    ``examples/li2o_toy_model.py``): Li2O/STO-3G, 30 qubits, MADE
    ``hidden_width``, qubit_per_qudit 6, Gumbel top-k over 8192 unique
    determinants, hash membership (the example's docstring names it; the
    41.4M-determinant sector is far beyond sector membership), MinSR
    top-50, clip 1.0, Adam 3e-3 (the example's schedule holds 3e-3 for its
    first 1200 steps), seed 0."""
    from ..chem.molecule import load_li2o

    return VMC(
        load_li2o(),
        VMCConfig(
            sample_num=8192, sampling_mode="gumbel", qubit_per_qudit=6,
            lr=3e-3, grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
            membership="hash", seed=0,
        ),
        AnqsConfig(hidden_widths=(hidden_width,),
                   aux_hidden_widths=(hidden_width,)),
        device=device,
    )
