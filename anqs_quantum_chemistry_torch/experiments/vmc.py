"""VMC energy optimization: the training step and its driver loop.

Counterpart of the JAX package's ``experiments/vmc.py``: the support
(Gumbel top-k or multinomial samples of unique determinants, or the whole
enumerated sector in exact summation) -> amplitudes -> sample-aware local
energies -> float64 estimators -> REINFORCE surrogate loss -> gradient ->
MinSR -> global-norm clip (and renormalization) -> Adam or SGD that skips
non-finite updates. Membership of the local energies' partners goes through
partner tables built once where the basis is fixed (exact summation,
``local_energy_static``) or the (N_alpha, N_beta) sector is small enough
(the N2 main path, ``main_path_vmc``), and otherwise through the engine's
dynamic membership over the canonically sorted sample set (the Li2O toy
model, ``li2o_vmc``: hash membership at 30 qubits; the Li2O NADE campaign,
``li2o_nade_vmc``: prefilter membership). The surrogate loss is

    loss = 2 sum_x f(x) [ log|psi(x)| Re(dE) + phase(x) Im(dE) ],

whose gradient equals the VMC energy gradient with f and E_loc held
constant: the local energies are computed without autograd.

Entry points: ``VMC(mol, VMCConfig(...), AnqsConfig(...), run_dir=...)``,
then ``run(iter_num, ...)``, the driver loop: iteration-keyed schedules,
the adaptive multinomial budget, the periodic unbiased full energy, the
overflow policy, ``result.csv``, ``best_energy.npy``, checkpoints and
resume, and every ``distill_period`` iterations a distillation cycle
(``distill_cycle``: supervised Adam steps toward the imaginary-time target
the step's own local energies define). ``init_state()`` and
``step(state)`` take single steps; ``init_ensemble_state(n_rep)`` and
``_multi_step_ensemble(n_steps, n_rep)`` advance replicas seeded ``seed +
r``, each as a run of its own would.

The measurement surface that JAX's benchmark and profiling tools call:
``_multi_step(n_steps)`` (a window of steps returning stacked metrics),
``step_cost_analysis()`` (the counted flops, transcendentals and bytes of
one step, ``utils/cost.py``) and ``profile_stages(reps)`` (ms of each stage
of a step, each alone). ``VMCConfig.sector_membership`` switches the
sector path 'auto', 'on' or 'off', with JAX's limits.

Data parallel (``VMC(..., mesh=...)``, JAX ``vmc.py:203-248,971-975``): one
process a rank of a ``parallel.mesh.Mesh``, every rank running the same
program. The support is sampled (the Gumbel frontier sharded over the
ranks), augmented and sorted replicated, every rank's generator seeded
alike; then each rank takes its row block (``shard_rows``): log psi, kernel
#1 and the local energies run on it, the engine resolving membership from
the set gathered whole or, under 'hash_dist', from its bucket-sharded table.
The estimators all-reduce numerators and denominators (never per-rank
means), the maxima and minima of log|psi| reduce by MAX and MIN, the loss
gradient is the sum of the ranks' gradients, and MinSR runs replicated on
the gathered set, so every rank takes the same optimizer step (checked
after each step). Rank 0 writes the run's files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..chem.fci import sector_determinants
from ..chem.jw import permute_det, permute_qubits_hamiltonian
from ..chem.molecule import Molecule
from ..models.anqs import ANQS, AnqsConfig
from ..models.ensemble import ensemble_init, preserved_parameters
from ..observables.pauli import PauliEngine, mc_estimate
from ..ops import bits as bitops
from ..ops import keys
from ..optim.adam import FlatAdam
from ..optim.pretrain import pack_dets
from ..optim.sr import SRConfig, clip_grad_norm, sr_transform
from ..parallel.mesh import (all_gather_rows, all_reduce, replicate,
                             shard_rows)
from ..sampling.sampler import SamplingConfig, sample
from ..symmetries import QubitGrouping
from ..utils import cost, spans
from ..utils.config import Config, Schedule
from .preparation import create_masker

# ``VMCConfig.sector_membership``'s values (JAX ``vmc.py:425-443``), and
# the largest sector that 'on' builds tables for (JAX asserts it).
SECTOR_MODES = ("auto", "on", "off", True, False)
SECTOR_ON_MAX_DETS = 1 << 20
# Exact summation enumerates at most this many determinants (JAX
# ``vmc.py:326``).
EXACT_MAX_DETS = 1 << 20
OVERFLOW_POLICIES = ("escalate", "raise", "ignore")
# The one file of a checkpoint directory.
CHECKPOINT_FILE = "checkpoint.pt"
# The best-model cascade saves at most once in this many seconds.
BEST_SAVE_INTERVAL_S = 10.0
# The JAX engine's keyword arguments that the port's ``PauliEngine`` takes,
# and so the keys ``VMCConfig.engine_overrides`` may hold.
ENGINE_OVERRIDE_KEYS = ("prefilter_row_capacity", "prefilter_dense_rows",
                        "pf_row_chunk", "hash_extra_bits", "membership",
                        "weights_matmul", "me_chunk", "hash_epb",
                        "dist_entry_slack", "dist_query_slack")
DISTILL_LOSSES = ("ce", "logmse")
# The cycle's metrics, in the order JAX's ``run`` appends them to a row.
DISTILL_COLUMNS = ("distill_loss_first", "distill_loss_last",
                   "distill_energy")


@dataclasses.dataclass
class VMCConfig(Config):
    """The fields of the JAX ``VMCConfig``, with JAX's names and
    defaults."""

    sample_num: int = 2000
    # 'gumbel' | 'multinomial' | 'exact' ('exact' enumerates the whole
    # symmetry sector once and sums over it; sample_num is ignored).
    sampling_mode: str = "gumbel"
    # The samplers' top-k: 'lax' or 'bisect' (``ops.topk.exact_top_k``).
    topk_impl: str = "lax"
    multinomial_budget: Optional[int] = None
    # Adaptive multinomial budget (reference sample_precisely,
    # calculations/sample.py:62-75): rescale the budget between iterations
    # toward ``target_unique`` distinct states (default sample_num // 2),
    # within [sample_num, max_multinomial_budget].
    sample_precisely: bool = False
    target_unique: Optional[int] = None
    max_multinomial_budget: int = 1 << 27
    symmetry_level: str = "e_num_spin"
    qubit_per_qudit: int = 6
    opt_type: str = "adam"  # 'adam' | 'sgd'
    lr: float = 1e-3
    # Piecewise-constant learning rate ((start_iter, lr), ...), keyed on
    # the count of applied updates, as optax's schedule is.
    lr_schedule: Optional[tuple] = None
    sr: Optional[SRConfig] = None
    grad_clip_norm: Optional[float] = None
    grad_renorm: bool = False  # grad <- grad/||grad|| (process_grad.py:66-70)
    # Every this many iterations, the unbiased full energy of the step's
    # own sample (``PauliEngine.local_energy_full``).
    full_energy_period: Optional[int] = None
    use_theor_freqs: bool = True  # Born |psi|^2 weights vs sampled weights
    # T > 1 weights the surrogate loss by |psi|^(2/T) (the estimators stay
    # Born); 1.0 = plain Born weights.
    grad_weight_temperature: float = 1.0
    # Exact summation: resolve membership once at set-up (the basis is
    # fixed), so a step needs no sort and no membership search (off when a
    # coupling below augments the set).
    exact_static_membership: bool = True
    # Sampled-mode sector membership ('auto' | 'on' | 'off', or True /
    # False; JAX ``vmc.py:116-126``): partner sector indices of every
    # (sector det, group) pair built at set-up, so that a step's membership
    # is a lookup of each sample in the (N_alpha, N_beta) sector. 'auto'
    # builds them where the sector holds at most
    # ``sector_membership_max_dets`` determinants and the tables at most
    # ``sector_membership_max_entries`` (dets x groups) entries, unless a
    # dynamic membership is named (``engine_overrides``)
    # or the ansatz can sample outside the sector; 'on' always builds them
    # (``ValueError`` above ``SECTOR_ON_MAX_DETS`` determinants or with an
    # ansatz that leaves the sector); 'off' never. Never above 64 qubits.
    sector_membership: str = "auto"
    sector_membership_max_dets: int = 1 << 16
    sector_membership_max_entries: int = 48_000_000
    # Couplings: determinants added to every step's set with zero sample
    # weight (Born weights supply |psi|^2), before the canonical sort, with
    # duplicates dropped after it (JAX ``vmc.py:901-971``): the
    # alpha <-> beta spin flip of every row (``couple_spin_flip``); the K =
    # ``couple_ref_dets`` partners HF ^ A_m with the largest
    # |<HF ^ A_m|H|HF>| (the pinned HF neighbourhood); the top
    # ``couple_support_k`` determinants by |coef| (or the first k) of an
    # npz file with ``dets`` (uint64) and optionally ``coef``.
    couple_spin_flip: bool = False
    couple_ref_dets: int = 0
    couple_support_file: Optional[str] = None
    couple_support_k: int = 8192
    # Qubit relabelling (reference HilbertSpace perm/inv_perm,
    # hilbert_space.py:97-104): new qubit i carries spin-orbital
    # qubit_perm[i], in the Hamiltonian, the masker, the HF determinant and
    # the enumerated sector alike. The spin-flip options assume the
    # interleaved order and raise beside it.
    qubit_perm: Optional[Tuple[int, ...]] = None
    seed: int = 0
    iter_num: int = 500
    # Iteration-keyed config schedules ((start_iter, {field: value}), ...):
    # the active entry is the last with start_iter <= iter (reference
    # energy_opt_exp.py:221-305,483-501).
    opt_schedule: Optional[tuple] = None  # lr, grad_*, sr
    sampling_schedule: Optional[tuple] = None  # sample_num, sampling_mode
    proc_grad_schedule: Optional[tuple] = None  # sr, grad_clip_norm, ...
    # Initial-weights cache shared by runs of one (ansatz, seed).
    init_weights_cache: Optional[str] = None
    # On a new best energy, checkpoint under <run_dir>/best_model and each
    # extra dir (reference energy_opt_exp.py:414-481,648-675).
    save_best_model: bool = False
    extra_best_dirs: Tuple[str, ...] = ()
    # ``PauliEngine`` keywords (JAX's field): any of
    # ``ENGINE_OVERRIDE_KEYS`` (another key raises), the engine's default
    # where absent. ``membership`` names the dynamic membership ('auto' |
    # 'table' | 'hash' | 'prefilter' | 'search' | 'hash_dist'): where
    # sector membership is off the step sorts the sample set and the
    # engine resolves partners from the set itself, and a named one turns
    # 'auto' sector membership off (JAX ``vmc.py:436``). ``weights_matmul``
    # names the group order ('auto' | 'split' | 'grouped'). The overflow
    # policy escalates from these capacities.
    engine_overrides: Optional[dict] = None
    # Membership overflow (table_overflow + pf_dropped_rows above the
    # threshold): 'escalate' doubles the hash bucket count (and, under
    # prefilter membership, both prefilter capacities; under hash_dist,
    # both routing slacks) and rebuilds the
    # engine, at most max_overflow_escalations times, then raises;
    # 'raise' raises; 'ignore' logs nothing and goes on.
    overflow_policy: str = "escalate"
    overflow_threshold: int = 0
    max_overflow_escalations: int = 6
    # Distillation-interleaved VMC (JAX ``vmc.py:168-191``): every
    # ``distill_period`` iterations (0 = off) one cycle of
    # ``distill_steps`` Adam steps at ``distill_lr`` toward the
    # imaginary-time target (1 - distill_tau (H - E)) |psi> on the step's
    # own support, with the cross-entropy ('ce') or the offset-free
    # weighted log|psi| regression ('logmse', weights |phi|^(2 /
    # distill_temperature)), plus ``distill_phase_weight`` times the phase
    # MSE.
    distill_period: int = 0
    distill_steps: int = 100
    distill_tau: float = 0.05
    distill_lr: float = 1e-3
    distill_loss: str = "ce"
    distill_temperature: float = 1.0
    distill_phase_weight: float = 1.0


def _engine_kwargs(cfg: VMCConfig) -> dict:
    """The ``PauliEngine`` keywords of ``cfg``: its ``engine_overrides``
    (JAX ``vmc.py:245-251``). Raises ``ValueError`` on a key the port's
    engine lacks."""
    overrides = dict(cfg.engine_overrides or {})
    unknown = sorted(set(overrides) - set(ENGINE_OVERRIDE_KEYS))
    if unknown:
        raise ValueError(f"engine_overrides {unknown}: the port's "
                         f"PauliEngine takes only {ENGINE_OVERRIDE_KEYS}")
    return overrides


def _lr_at(cfg: VMCConfig, count: int) -> float:
    """The learning rate of the ``count``-th applied update: ``cfg.lr``, or
    ``optax.piecewise_constant_schedule`` of ``cfg.lr_schedule`` as the JAX
    ``_make_opt`` builds it (the first entry's rate, times each boundary's
    scale new/old once ``count`` reaches it; float64, as the JAX package
    runs with 64-bit types enabled)."""
    if not cfg.lr_schedule:
        return cfg.lr
    entries = sorted(cfg.lr_schedule)
    value = float(entries[0][1])
    for (_, old), (start, new) in zip(entries[:-1], entries[1:]):
        if count >= int(start):
            value *= new / old
    return value


class FiniteGuardOptimizer:
    """``optax.apply_if_finite(optax.adam(lr) | optax.sgd(lr),
    max_consecutive_errors)``: an update whose gradients hold a NaN or an
    Inf is skipped (parameters, moments and the count of applied updates
    untouched) until more than ``max_consecutive_errors`` such updates come
    in a row; then it is applied anyway. The learning rate is set before
    each applied update from the step's config (``_lr_at``)."""

    def __init__(self, params, opt_type: str = "adam",
                 max_consecutive_errors: int = 100):
        self.params = list(params)
        if opt_type == "adam":
            self.inner = torch.optim.Adam(self.params, lr=1.0,
                                          betas=(0.9, 0.999), eps=1e-8)
        elif opt_type == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=1.0)
        else:
            raise ValueError(f"opt_type={opt_type!r}: expected 'adam' or "
                             "'sgd'")
        self.opt_type = opt_type
        self.max_consecutive_errors = max_consecutive_errors
        self.count = 0  # applied updates: the learning-rate schedule's step
        self.notfinite_count = 0
        self.total_notfinite = 0
        self.last_lr = None

    def step(self, grads, cfg: VMCConfig) -> bool:
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
        self.last_lr = _lr_at(cfg, self.count)
        for group in self.inner.param_groups:
            group["lr"] = self.last_lr
        for p, g in zip(self.params, grads):
            p.grad = g
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"opt_type": self.opt_type, "inner": self.inner.state_dict(),
                "count": self.count, "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict):
        """Raises ``ValueError`` (or ``KeyError``) where ``state`` is of
        another optimizer or parameter layout."""
        if state["opt_type"] != self.opt_type:
            raise ValueError(f"saved optimizer {state['opt_type']!r}, this "
                             f"one {self.opt_type!r}")
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])


class TrainState(NamedTuple):
    opt: FiniteGuardOptimizer
    generator: torch.Generator  # sampler noise


class EnsembleState(NamedTuple):
    """Replicas of one trainer: every parameter stacked along a leading
    replica axis (``models/ensemble.py``'s layout), and each replica's
    optimizer (over the ansatz's own parameter tensors) and generator."""

    params: Dict[str, torch.Tensor]
    opts: Tuple[FiniteGuardOptimizer, ...]
    generators: Tuple[torch.Generator, ...]


class VMC:
    """The full stack for one molecule, or for an explicit Hamiltonian:
    masker, grouping, ansatz, Pauli engine and the static tables of the
    exact or sector paths.

    ``mesh``: the rank's ``parallel.mesh.Mesh`` for data-parallel training
    (module docstring); the trainer then runs on ``mesh.device``.

    Pass a ``Molecule``, or ``ham`` (a ``PauliHamiltonian``), ``masker``
    and optionally ``ref_det`` (the reference determinant as an int,
    default 0) without one: the spin chains of
    ``applications/spin_systems.py`` (JAX ``vmc.py:199-240``). Without a
    molecule there is no sector to enumerate: ``sampling_mode='exact'``
    raises, sector membership is off and the step's membership is the
    engine's dynamic one; ``qubit_perm`` raises too (it relabels a
    molecule's Hamiltonian, masker and sector together: relabel an
    explicit Hamiltonian before passing it). ``sign_structure``: the
    ansatz's fixed phase table (``ANQS``), indexed in the trainer's qubit
    order."""

    def __init__(self, mol: Optional[Molecule] = None,
                 config: VMCConfig = None, anqs_config: AnqsConfig = None,
                 device="cuda", run_dir: Optional[str] = None,
                 sign_structure=None, ham=None, masker=None,
                 ref_det: Optional[int] = None, mesh=None):
        self.mol = mol
        self.config = config or VMCConfig()
        anqs_config = anqs_config or AnqsConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(
            device)
        perm = self.config.qubit_perm
        if mol is None:
            if ham is None or masker is None:
                raise ValueError("VMC needs a Molecule, or an explicit "
                                 "ham and masker")
            if self.config.sampling_mode == "exact":
                raise ValueError("sampling_mode='exact' needs a Molecule "
                                 "(sector enumeration)")
            if perm is not None:
                raise ValueError("qubit_perm relabels a Molecule's "
                                 "Hamiltonian and sector; permute an "
                                 "explicit Hamiltonian before passing it")
        elif ham is not None or masker is not None:
            raise ValueError("pass a Molecule or an explicit ham and "
                             "masker, not both")
        if perm is not None and (self.config.couple_spin_flip
                                 or anqs_config.spin_flip_abs
                                 or anqs_config.spin_flip_phase):
            raise ValueError("spin-flip coupling assumes the interleaved "
                             "qubit order; it cannot be combined with "
                             "qubit_perm")
        if self.config.overflow_policy not in OVERFLOW_POLICIES:
            raise ValueError(f"overflow_policy="
                             f"{self.config.overflow_policy!r}: expected one "
                             f"of {OVERFLOW_POLICIES}")
        if self.config.sector_membership not in SECTOR_MODES:
            raise ValueError(f"sector_membership="
                             f"{self.config.sector_membership!r}: expected "
                             f"one of {SECTOR_MODES}")
        if self.config.distill_loss not in DISTILL_LOSSES:
            raise ValueError(f"distill_loss={self.config.distill_loss!r}: "
                             f"expected one of {DISTILL_LOSSES}")
        if mol is not None:
            ham = mol.qubit_ham
            masker = create_masker(mol, self.config.symmetry_level, perm)
            ref_det = mol.hf_det if ref_det is None else ref_det
            if perm is not None:
                ham = permute_qubits_hamiltonian(ham, perm)
                ref_det = permute_det(ref_det, perm)
        ref_det = 0 if ref_det is None else int(ref_det)
        self.ham = ham
        n = self.ham.qubit_num
        self.masker = masker
        self.grouping = QubitGrouping.create(
            self.masker, qubit_per_qudit=self.config.qubit_per_qudit
        )
        self.anqs = ANQS(
            self.grouping, anqs_config,
            torch.Generator().manual_seed(self.config.seed),
            sign_structure=sign_structure,
        ).to(self.device)
        self._overflow_escalations = 0
        self._mult_budget = None
        self.engine = PauliEngine(self.ham, device=self.device, mesh=mesh,
                                  **_engine_kwargs(self.config))
        self.sampling_config = self._step_configs()[1]
        self._schedules = tuple(
            Schedule([(int(s), dict(d)) for s, d in sched])
            for sched in (self.config.opt_schedule,
                          self.config.sampling_schedule,
                          self.config.proc_grad_schedule)
            if sched
        )
        hf_bits = torch.tensor([[(ref_det >> i) & 1 for i in range(n)]])
        self.hf_words = bitops.pack(hf_bits).to(self.device)
        self.ref_neighbor_words = self._ref_neighbors()
        self.coupled_words = self._support_words()

        self.run_dir = run_dir
        if run_dir and self._writer:
            os.makedirs(run_dir, exist_ok=True)
            # JAX's keys, and the ansatz's config (``matmul_precision``
            # with it) under "anqs".
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump({**self.config.to_dict(),
                           "anqs": dataclasses.asdict(self.anqs.config)},
                          f, indent=2, sort_keys=True, default=str)

        self.exact_words = None
        self.exact_valid = None
        self.exact_partner_idx = None
        self.exact_partner_found = None
        self.sector_words = None
        self.sector_pos = None
        if self.config.sampling_mode == "exact":
            # Exact summation over the whole sorted sector (JAX
            # ``vmc.py:317-346``); sentinel rows pad it to a multiple of 64.
            dets, words_packed, valid, n_real = self._enumerate_sector(
                mol, n, perm)
            if n_real > EXACT_MAX_DETS:
                raise ValueError(f"sector too large for exact summation "
                                 f"({n_real} > {EXACT_MAX_DETS})")
            self.exact_words = words_packed
            self.exact_valid = valid
            if (self.config.exact_static_membership and n <= 64
                    and not self._couples()):
                idx, pf = self._sector_partner_tables(dets, n_real)
                self.exact_partner_idx = idx
                self.exact_partner_found = pf
            return
        if mol is None or not self._want_sector_membership(mol):
            return
        dets, words_packed, _, n_real = self._enumerate_sector(mol, n, perm)
        idx, pf = self._sector_partner_tables(dets, n_real)
        self.sector_words = words_packed
        self.sector_partner_idx = idx
        self.sector_partner_found = pf
        if n <= PauliEngine.MAX_TABLE_QUBITS:
            # Direct-address sample -> sector-index map: one gather per
            # sample and no canonical sort of a Gumbel sample set (JAX
            # ``vmc.py:359``). Above the limit the sorted sample set is
            # searched in the sector, all W words compared.
            pos = np.full(1 << n, -1, dtype=np.int64)
            pos[dets.astype(np.int64)] = np.arange(n_real, dtype=np.int64)
            self.sector_pos = torch.from_numpy(pos).to(self.device)

    @property
    def _writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _barrier(self):
        if self._sharded:
            self.mesh.barrier()

    def _psum(self, x):
        return all_reduce(x, self.mesh)

    def _couples(self, cfg: VMCConfig = None) -> bool:
        """Whether a coupling augments each step's determinant set."""
        cfg = cfg or self.config
        return bool(cfg.couple_spin_flip or cfg.couple_ref_dets
                    or cfg.couple_support_file)

    def _ref_neighbors(self):
        """The pinned HF neighbourhood (JAX ``vmc.py:298-307``): the K =
        min(``couple_ref_dets``, M) partners HF ^ A_m with the largest
        |<HF ^ A_m|H|HF>|, from one matrix-element row, ranked by numpy's
        ``argsort(-|row|)`` as JAX ranks them (ties in the order of the
        engine's groups). None when off."""
        k = int(self.config.couple_ref_dets)
        if not k:
            return None
        with torch.no_grad():
            me_row = self.engine.matrix_elements(self.hf_words)[0]
        top = np.argsort(-np.abs(me_row.cpu().numpy()))[:k]
        return self.hf_words ^ self.engine.a_words[
            torch.from_numpy(top).to(self.device)]

    def _support_words(self):
        """The pinned support of ``couple_support_file`` (JAX
        ``vmc.py:284-296``), packed; None when off."""
        path = self.config.couple_support_file
        if not path:
            return None
        k = self.config.couple_support_k
        with np.load(path) as data:
            dets = np.asarray(data["dets"], np.uint64)
            if "coef" in data and k < len(dets):
                dets = dets[np.argsort(-np.abs(np.asarray(data["coef"])))[:k]]
            else:
                dets = dets[:k]
        return pack_dets(dets, self.ham.qubit_num).to(self.device)

    def _augment(self, cfg: VMCConfig, words, weights, valid):
        """Append each coupling's rows (JAX ``vmc.py:901-931``): zero
        sample weight; flipped rows keep their source's validity, pinned
        rows are valid."""
        parts = [(words, weights, valid)]
        if cfg.couple_spin_flip:
            flipped = bitops.interleave_swap(words, self.ham.qubit_num)
            parts.append((flipped, torch.zeros_like(weights), valid))
        for pinned, on in ((self.ref_neighbor_words, cfg.couple_ref_dets),
                           (self.coupled_words, cfg.couple_support_file)):
            if on and pinned is not None:
                k = pinned.shape[0]
                parts.append((pinned, weights.new_zeros(k),
                              torch.ones(k, dtype=torch.bool,
                                         device=valid.device)))
        if len(parts) == 1:
            return words, weights, valid
        return tuple(torch.cat(p) for p in zip(*parts))

    def _want_sector_membership(self, mol) -> bool:
        """``config.sector_membership`` as JAX ``vmc.py:425-443`` reads it,
        with one guard more: where the ansatz samples some qudit unmasked
        (``masking_depth``, 'unmasked'), its samples can leave the sector,
        which has no row for them, so 'auto' is off there and 'on' raises
        ``ValueError`` (JAX keeps the sector path and loses every pair of
        such a sample, its diagonal included: ROADMAP section 3). 'on'
        also raises above ``SECTOR_ON_MAX_DETS`` determinants."""
        cfg = self.config
        mode = cfg.sector_membership
        if mode in ("off", False) or self.ham.qubit_num > 64:
            return False
        ndet = int(mol.fci_ndet)
        if mode in ("on", True):
            if self.anqs.leaves_sector:
                raise ValueError(
                    "sector_membership='on' with an ansatz that samples "
                    "outside the sector (masking_depth or 'unmasked')")
            if ndet > SECTOR_ON_MAX_DETS:
                raise ValueError(f"sector too large for sector membership "
                                 f"({ndet} > {SECTOR_ON_MAX_DETS})")
            return True
        if ("membership" in (cfg.engine_overrides or {})
                or self.anqs.leaves_sector):
            return False  # a named dynamic membership is used as named
        return (ndet <= cfg.sector_membership_max_dets
                and ndet * self.ham.n_groups
                <= cfg.sector_membership_max_entries)

    def _enumerate_sector(self, mol, n, perm=None):
        """Sorted sector (uint64 dets) in the qubit order of ``perm``,
        packed words padded with all-ones sentinel rows to a multiple of
        64, valid mask, real count."""
        dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
        if perm is not None:
            permuted = np.zeros_like(dets)
            for i, p in enumerate(perm):
                permuted |= ((dets >> np.uint64(p)) & np.uint64(1)) << (
                    np.uint64(i))
            dets = np.sort(permuted)
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
        a_np = self.engine.a_words.cpu().numpy().astype(np.uint64)
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
    # Config schedules (JAX ``vmc.py:532-577``)
    # ------------------------------------------------------------------
    def _schedule_overrides(self, it: int) -> dict:
        """Merged override dict active at iteration ``it``."""
        ov = {}
        for sched in self._schedules:
            ov.update(sched.at(it))
        return ov

    def _next_boundary(self, it: int) -> float:
        """The next iteration after ``it`` at which a schedule changes."""
        nb = float("inf")
        for sched in self._schedules:
            for start in sched.starts:
                if start > it:
                    nb = min(nb, start)
        return nb

    def _step_configs(self, overrides: Optional[dict] = None):
        """(effective config, sampling config) under ``overrides``."""
        eff = self.config.replace(**overrides) if overrides else self.config
        samp = SamplingConfig(sample_num=eff.sample_num,
                              mode=eff.sampling_mode,
                              budget=eff.multinomial_budget,
                              topk_impl=eff.topk_impl)
        return eff, samp

    # ------------------------------------------------------------------
    def _make_opt(self) -> FiniteGuardOptimizer:
        return FiniteGuardOptimizer(self.anqs.parameters(),
                                    self.config.opt_type)

    def init_state(self) -> TrainState:
        """Fresh (or cached) ansatz weights, optimizer state and sampler
        generator, all from ``config.seed``."""
        seed = self.config.seed
        self.anqs.reset_parameters(torch.Generator().manual_seed(seed))
        self._init_params_cached()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(opt=self._make_opt(), generator=gen)

    def _init_params_cached(self):
        """Share initial weights through ``config.init_weights_cache``, one
        file per (ansatz config, qubit count, qudit widths, seed), keyed as
        the JAX package keys its cache (``vmc.py:752-783``): a cached file
        of the same layout replaces the fresh weights, else they are
        written."""
        cache_dir = self.config.init_weights_cache
        if not cache_dir:
            return
        sig = json.dumps(
            [
                dataclasses.asdict(self.anqs.config),
                self.ham.qubit_num,
                list(map(int, self.grouping.qudit_widths)),
                self.config.seed,
            ],
            sort_keys=True,
            default=str,
        )
        tag = hashlib.sha256(sig.encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"init_{tag}.pt")
        fresh = self.anqs.state_dict()
        cached = None
        if os.path.exists(path):
            cached = torch.load(path, map_location="cpu", weights_only=True)
        # Every rank has read (or seeded alike) before rank 0 writes.
        self._barrier()
        if cached is not None and _layout(cached) == _layout(fresh):
            self.anqs.load_state_dict(cached)
        elif self._writer:
            os.makedirs(cache_dir, exist_ok=True)
            torch.save({k: v.cpu() for k, v in fresh.items()}, path)
        self._barrier()

    def _multi_step(self, n_steps: int, overrides: Optional[dict] = None):
        """A callable that advances a ``TrainState`` by ``n_steps`` steps
        under the schedule ``overrides`` and returns (state, metrics),
        every metric an (n_steps,) float64 array (JAX ``vmc.py:643-684``:
        its names, stacked over the window). The steps are ``step`` calls,
        so a window equals that many ``step`` calls bit for bit, each
        reading its metrics back."""
        if n_steps < 1:
            raise ValueError(f"n_steps={n_steps}: expected >= 1")

        def run(state: TrainState):
            rows = [self.step(state, overrides=overrides)
                    for _ in range(n_steps)]
            return state, {k: np.array([row[k] for row in rows])
                           for k in rows[0]}

        return run

    # ------------------------------------------------------------------
    # Replica ensembles (JAX ``vmc.py:681-743``)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_ensemble_state(self, n_rep: int) -> EnsembleState:
        """``n_rep`` independent replicas, replica r seeded ``seed + r``
        as ``init_state`` seeds a trainer of that seed (the reference's
        multi-seed series, ``experiments/series.py``): its fresh weights,
        optimizer and sampler generator. The ansatz keeps its own
        parameters."""
        seeds = [self.config.seed + r for r in range(n_rep)]
        stacked = ensemble_init(
            self.anqs, [torch.Generator().manual_seed(s) for s in seeds])
        return EnsembleState(
            params=stacked, opts=tuple(self._make_opt() for _ in seeds),
            generators=tuple(torch.Generator(device=self.device)
                             .manual_seed(s) for s in seeds))

    def _multi_step_ensemble(self, n_steps: int, n_rep: int,
                             overrides: Optional[dict] = None):
        """A callable that advances an ``EnsembleState`` of ``n_rep``
        replicas by ``n_steps`` steps each (under the schedule
        ``overrides``) and returns (state, metrics), every metric an
        (n_rep, n_steps) float64 array (JAX's name and layout). Each
        replica steps as a standalone trainer of its seed would: its
        parameters are loaded into the ansatz, its optimizer and generator
        drive ``_multi_step``, and the updated parameters go back into the
        stack.
        The kernels are called through ``ctypes`` and cannot be vmapped,
        so the replicas take their steps in turn. The ansatz keeps its own
        parameters."""
        window = self._multi_step(n_steps, overrides)

        def call(state: EnsembleState):
            if len(state.opts) != n_rep:
                raise ValueError(f"ensemble of {len(state.opts)} replicas, "
                                 f"expected {n_rep}")
            reps = []
            with preserved_parameters(self.anqs) as params:
                for r in range(n_rep):
                    with torch.no_grad():
                        for n, p in params.items():
                            p.copy_(state.params[n][r])
                    reps.append(window(TrainState(
                        opt=state.opts[r], generator=state.generators[r]))[1])
                    with torch.no_grad():
                        for n, p in params.items():
                            state.params[n][r].copy_(p)
            return state, {k: np.stack([m[k] for m in reps])
                           for k in reps[0]}

        return call

    # ------------------------------------------------------------------
    # Multinomial budget and overflow policy (JAX ``vmc.py:794-871``)
    # ------------------------------------------------------------------
    def _current_budget(self, cfg: VMCConfig) -> int:
        """The multinomial budget (adapted by ``sample_precisely``)."""
        if self._mult_budget is None:
            self._mult_budget = int(cfg.multinomial_budget or cfg.sample_num)
        return self._mult_budget

    def _adapt_budget(self, cfg: VMCConfig, unique_num: float):
        """Reference sample_precisely (calculations/sample.py:62-75):
        rescale the budget toward the unique-count target between
        iterations, by a factor in [0.25, 4]."""
        if not (cfg.sample_precisely and cfg.sampling_mode == "multinomial"):
            return
        target = cfg.target_unique or cfg.sample_num // 2
        u = max(1.0, float(unique_num))
        scale = min(4.0, max(0.25, target / u))
        self._mult_budget = int(min(
            max(self._current_budget(cfg) * scale, cfg.sample_num),
            cfg.max_multinomial_budget,
        ))

    def _handle_overflow(self, row: dict):
        """Act on an iteration's membership overflow by
        ``config.overflow_policy``, since dropped keys bias E_loc low:
        'escalate' doubles the hash bucket count and rebuilds the engine,
        and raises once ``max_overflow_escalations`` did not suffice."""
        cfg = self.config
        table = int(row.get("table_overflow", 0))
        pf = int(row.get("pf_dropped_rows", 0))
        if table + pf <= cfg.overflow_threshold or (
                cfg.overflow_policy == "ignore"):
            return
        msg = (f"membership overflow at iter {row.get('iter_idx', '?')}: "
               f"table_overflow={table} pf_dropped_rows={pf}")
        if (cfg.overflow_policy == "raise"
                or self._overflow_escalations >= cfg.max_overflow_escalations):
            raise RuntimeError(
                msg + " (policy=raise or escalation cap reached); E_loc "
                "would be silently biased low"
            )
        self._overflow_escalations += 1
        eng = self.engine
        caps = {}
        if eng.membership == "prefilter":
            caps["prefilter_row_capacity"] = 2 * eng.prefilter_row_capacity
            caps["prefilter_dense_rows"] = 2 * eng.prefilter_dense_rows
        if eng.membership == "hash_dist":
            # JAX vmc.py:856-859.
            caps["dist_entry_slack"] = 2.0 * eng.dist_entry_slack
            caps["dist_query_slack"] = 2.0 * eng.dist_query_slack
        if eng.membership in ("hash", "prefilter", "hash_dist"):
            caps["hash_extra_bits"] = eng.hash_extra_bits + 1
        logging.warning("%s -> escalation #%d: rebuilding engine with %s",
                        msg, self._overflow_escalations, caps)
        # Only capacities change: the rebuilt engine shares the device
        # tables (kernel #1's cut of the terms is not redone).
        self.engine = eng.with_capacities(**caps)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _support(self, generator: torch.Generator, cfg: VMCConfig = None,
                 samp: SamplingConfig = None, uniforms=None, draw=None):
        """Sample (or take the enumerated sector as) the unique-determinant
        support, add the couplings' rows, and order it as its membership
        needs: (words, weights, valid, stats), this rank's rows under a
        mesh. Launches no kernel."""
        cfg = cfg or self.config
        samp = samp or self.sampling_config
        if samp.mode == "exact":
            words, valid = self.exact_words, self.exact_valid
            n_real = torch.sum(valid)
            weights = torch.where(valid, 1.0, 0.0) / n_real
            stats = {"unique_num": n_real, "dropped": 0}
        else:
            budget = (self._current_budget(cfg)
                      if samp.mode == "multinomial" else None)
            with spans.span("vmc.sample"):
                words, weights, valid, stats = sample(
                    self.anqs, samp, generator, uniforms, budget=budget,
                    draw=draw, mesh=self.mesh,
                )
        couples = self._couples(cfg)
        words, weights, valid = self._augment(cfg, words, weights, valid)
        if not self._use_static(samp):
            # Invalid rows become all-ones sentinels that never match.
            words = torch.where(valid[:, None], words, bitops.MASK32)
        if not self._use_static(samp) and not (
                self.sector_pos is not None and samp.mode == "gumbel"
                and not couples):
            # Canonical order (JAX ``vmc.py:941-966``): only Gumbel samples
            # on the sector position map skip it; their rows are unique,
            # and the map needs no sorted set. A coupling may repeat a row:
            # the sort's first copy stays valid.
            words, _, weights, valid = keys.sort_words(words, weights, valid)
            if couples:
                valid = valid & keys.unique_mask(words)
        # This rank's rows (JAX ``vmc.py:971-975``).
        return (*shard_rows((words, weights, valid), self.mesh), stats)

    def _use_static(self, samp: SamplingConfig) -> bool:
        return samp.mode == "exact" and self.exact_partner_idx is not None

    def _support_and_eloc(self, state: TrainState, cfg: VMCConfig = None,
                          samp: SamplingConfig = None, uniforms=None,
                          draw=None):
        """The support (``_support``), its amplitudes and sample-aware
        local energies (no autograd). Returns (words, weights, valid,
        stats, la, ph, e)."""
        samp = samp or self.sampling_config
        with spans.span("vmc.support"):
            words, weights, valid, stats = self._support(
                state.generator, cfg, samp, uniforms, draw)
        with torch.no_grad(), spans.span("vmc.log_psi"):
            la, ph = self.anqs.log_psi(words)
        with torch.no_grad(), spans.span("vmc.local_energy"):
            if self._use_static(samp):
                e = self.engine.local_energy_static(
                    words, la, ph, valid, *shard_rows(
                        (self.exact_partner_idx, self.exact_partner_found),
                        self.mesh),
                )
            elif self.sector_words is not None:
                e = self.engine.local_energy_sector(
                    words, la, ph, valid, self.sector_words,
                    self.sector_partner_idx, self.sector_partner_found,
                    sector_pos=self.sector_pos,
                )
            else:
                e = self.engine.local_energy_proxy(words, la, ph, valid)
        return words, weights, valid, stats, la, ph, e

    def _grads_and_metrics(self, state: TrainState, uniforms=None,
                           cfg: VMCConfig = None, samp: SamplingConfig = None,
                           draw=None, full_energy: bool = False):
        """Everything of a step before the optimizer: (metrics as device
        scalars, preconditioned and clipped gradients by parameter name).
        With ``full_energy``, the metrics also hold the unbiased full energy
        of the step's sample at the pre-update weights."""
        cfg = cfg or self.config
        words, weights, valid, stats, la, ph, e = self._support_and_eloc(
            state, cfg, samp, uniforms, draw
        )
        with spans.span("vmc.estimators"):
            psum = self._psum
            theor = torch.where(valid, torch.exp(2.0 * la), 0.0)
            theor_sum = psum(torch.sum(theor))
            if cfg.use_theor_freqs:
                # Born weights; float64 estimators in the overflow-free
                # numerator form (p_x E_x = a_x t_x; p_x |E_x|^2 = |t_x|^2).
                # At |E| ~ 100 Ha the float32 cancellation in sum|t|^2 -
                # |mean|^2 is ~1e-3 Ha^2. Under a mesh the sums are
                # all-reduced, never the ranks' means.
                freqs = theor / torch.clamp(theor_sum, min=1e-30)
                a_x = torch.where(valid, torch.exp(la),
                                  0.0).to(torch.float64)
                t_re = e.t_re.to(torch.float64)
                t_im = e.t_im.to(torch.float64)
                sums = psum(torch.stack([
                    torch.sum(a_x**2), torch.sum(a_x * t_re),
                    torch.sum(a_x * t_im), torch.sum(t_re**2 + t_im**2)]))
                denom = torch.clamp(sums[0], min=1e-300)
                mean_re64 = sums[1] / denom
                mean_im64 = sums[2] / denom
                var = (sums[3] / denom
                       - mean_re64**2 - mean_im64**2).to(torch.float32)
                mean_re = mean_re64.to(torch.float32)
                mean_im = mean_im64.to(torch.float32)
            else:
                # The sampler's own weights (multinomial: counts / total).
                freqs = weights / torch.clamp(psum(torch.sum(weights)),
                                              min=1e-30)
                mean_re, mean_im, var = mc_estimate(e.e_re, e.e_im, freqs,
                                                    self.mesh)
            d_re = torch.where(valid, e.e_re - mean_re, 0.0)
            d_im = torch.where(valid, e.e_im - mean_im, 0.0)

            # max and -min of log|psi| in one MAX reduction.
            la_max, neg_la_min = all_reduce(torch.stack([
                torch.max(torch.where(valid, la, -torch.inf)),
                -torch.min(torch.where(valid, la, torch.inf))]), self.mesh,
                "max")
            temp = cfg.grad_weight_temperature
            if cfg.use_theor_freqs and temp != 1.0:
                tempered = torch.where(
                    valid, torch.exp((2.0 / temp) * (la - la_max)), 0.0
                )
                grad_freqs = tempered / torch.clamp(
                    psum(torch.sum(tempered)), min=1e-30)
            else:
                grad_freqs = freqs

        metrics = {}
        if full_energy:
            with spans.span("vmc.full_energy"):
                metrics["full_energy"], _, metrics["full_energy_var"] = (
                    self._full_energy(words, la, ph, valid))

        with spans.span("vmc.grad"):
            params = dict(self.anqs.named_parameters())
            la_g, ph_g = self.anqs.log_psi(words)
            la_g = torch.where(valid, la_g, 0.0)
            ph_g = torch.where(valid, ph_g, 0.0)
            loss = 2.0 * torch.sum(grad_freqs * (la_g * d_re + ph_g * d_im))
            grads = _grad(loss, list(params.values()))
            if self._sharded:
                # The loss gradient: the sum of the ranks' gradients.
                flat = psum(torch.cat([g.reshape(-1) for g in grads]))
                grads = list(torch.split(flat, [g.numel() for g in grads]))
                grads = [g.reshape(p.shape)
                         for g, p in zip(grads, params.values())]
            grads = dict(zip(params, grads))

        if cfg.sr is not None:
            # MinSR runs replicated on the whole set.
            with spans.span("vmc.sr"):
                sr_words, sr_freqs = replicate((words, grad_freqs),
                                               self.mesh)
                grads = sr_transform(self.anqs, params, grads, sr_words,
                                     sr_freqs, cfg.sr)
        # The update (clip, the metrics) goes on in ``step``.
        with spans.span("vmc.update"):
            if cfg.grad_clip_norm is not None:
                grads, _ = clip_grad_norm(grads, cfg.grad_clip_norm)
            if cfg.grad_renorm:
                # grad <- grad / ||grad|| (reference process_grad.py:66-70).
                norm = torch.linalg.vector_norm(
                    torch.cat([g.reshape(-1) for g in grads.values()]))
                grads = {n: g / torch.clamp(norm, min=1e-30)
                         for n, g in grads.items()}

            # HF-projected local energy: E_loc at the HF row if it was
            # sampled; the set size and ipr beside it in one reduction.
            hf_match = torch.all(words == self.hf_words[0][None, :],
                                 dim=1) & valid
            counts = psum(torch.stack([
                torch.sum(torch.where(hf_match, e.e_re,
                                      0.0)).to(torch.float64),
                torch.sum(hf_match).to(torch.float64),
                torch.sum(valid).to(torch.float64),
                torch.sum(freqs**2).to(torch.float64)]))
            hf_e = torch.where(counts[1] > 0, counts[0].to(torch.float32),
                               torch.nan)
            n_valid = counts[2].to(torch.int64)
            metrics.update({
                "energy": mean_re,
                "energy_imag": mean_im,
                "energy_var": var,
                "unique_num": n_valid,
                "sampled_prob": theor_sum,
                "found_pairs": e.found_pairs,
                "hf_proj_energy": hf_e,
                "grad_norm": torch.linalg.vector_norm(
                    torch.cat([g.reshape(-1) for g in grads.values()])
                ),
                "max_log_abs": la_max,
                "ipr": counts[3].to(torch.float32),
                "dropped": torch.as_tensor(stats["dropped"]),
                "min_log_abs": -neg_la_min,
                "found_ratio": e.found_pairs
                / torch.clamp(n_valid * self.engine.n_groups, min=1),
                "table_overflow": torch.as_tensor(e.table_overflow),
                "pf_dropped_rows": torch.as_tensor(e.pf_dropped_rows),
            })
        return metrics, grads

    def _full_energy(self, words, la, ph, valid):
        """The unbiased full energy of a sample (mean, imaginary part,
        variance) under its Born weights, at the weights that gave (la, ph)
        (JAX ``vmc.py:1232-1253``); on this rank's rows under a mesh."""
        e = self.engine.local_energy_full(self.anqs, words, la, ph, valid)
        theor = torch.where(valid, torch.exp(2.0 * la), 0.0)
        freqs = theor / torch.clamp(self._psum(torch.sum(theor)), min=1e-30)
        return mc_estimate(e.e_re, e.e_im, freqs, self.mesh)

    def check_replicas(self):
        """Raise ``RuntimeError`` unless every rank of the mesh holds the
        same parameters (a no-op without one). One all-gather of a 16-byte
        checksum a rank: the int64 sums of the parameters' float32 bit
        patterns, plain and weighted by position (wrapping). Entries that
        differ at one position always change the weighted sum."""
        if not self._sharded:
            return
        bits = torch.cat([p.detach().float().reshape(-1).view(torch.int32)
                          for p in self.anqs.parameters()]).to(torch.int64)
        pos = torch.arange(1, bits.numel() + 1, device=bits.device)
        sums = torch.stack([torch.sum(bits), torch.sum(bits * pos)])
        every = all_gather_rows(sums[None], self.mesh, self.mesh.size)
        if not bool(torch.all(every == every[0])):
            raise RuntimeError(
                f"parameters differ across the {self.mesh.size} ranks: "
                f"checksums {every.tolist()}")

    def step(self, state: TrainState, uniforms=None, overrides=None,
             draw=None, full_energy: bool = False) -> dict:
        """One training step under the schedule ``overrides``; returns the
        metrics as Python floats (JAX's metric names, sorted as JAX returns
        them). ``uniforms`` / ``draw`` (tests) replace the sampler's own
        noise; ``full_energy`` adds ``full_energy`` / ``full_energy_var``.

        The step is the span ``vmc.step`` (``utils/spans.py``), and its
        stages partition it: ``vmc.support`` (``vmc.sample`` inside, where
        the step samples), ``vmc.log_psi``, ``vmc.local_energy``,
        ``vmc.estimators``, ``vmc.full_energy`` (with ``full_energy``),
        ``vmc.grad`` (the loss's forward and backward), ``vmc.sr`` (with
        MinSR) and ``vmc.update`` (clip or renorm and the metrics, then the
        optimizer, log psi of HF and the read-back: two spans of the
        name)."""
        with spans.span("vmc.step"):
            cfg, samp = self._step_configs(overrides)
            metrics, grads = self._grads_and_metrics(
                state, uniforms, cfg, samp, draw, full_energy)
            with spans.span("vmc.update"):
                state.opt.step(list(grads.values()), cfg)
                self.check_replicas()
                with torch.no_grad():
                    metrics["hf_log_abs"] = self.anqs.log_psi(
                        self.hf_words)[0][0]
                names = sorted(metrics)
                values = torch.stack(
                    [metrics[k].to(device="cpu", dtype=torch.float64)
                     for k in names]).tolist()
        return dict(zip(names, values))

    # ------------------------------------------------------------------
    # The measurement surface (JAX ``vmc.py:610-641,1255-1393``)
    # ------------------------------------------------------------------
    def step_cost_analysis(self, overrides: Optional[dict] = None) -> dict:
        """The work of one training step under the schedule
        ``overrides``, counted op by op (``utils/cost.py``: XLA's
        conventions; the kernels by their own counts, alike on the card
        and the CPU).

        JAX compiles its step without running it and reads XLA's counts of
        the compiled program; this runs one step under a
        ``cost.WorkCounter`` and counts the work the port's step executes,
        as XLA's counts JAX's compiled step. Whether a benchmark divides by
        it, or by a count of the algorithm's own work, is the benchmark's
        decision: MinSR's Jacobians, filed under 'minsr_jacobians/', take k
        times the backward work of JAX's per-row form (``optim/sr.py``).
        The step runs on a fresh optimizer and a generator seeded
        ``config.seed``, as ``init_state`` makes them but at the ansatz's
        current weights; the weights, the multinomial budget and the
        engine (its overflow escalations) are restored after it, so the
        caller's training does not advance.

        Returns {'flops', 'transcendentals', 'bytes accessed'} (JAX's key
        names), 'by_source' ({source: counts}, the most flops first: aten
        ops by name, the kernels as 'fused_matrix_elements', 'hash_tags'
        and 'hash_lookup') and 'device'."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed)
        counter = cost.WorkCounter()
        saved = (self._mult_budget, self.engine, self._overflow_escalations)
        with preserved_parameters(self.anqs):
            try:
                with counter:
                    self.step(TrainState(opt=self._make_opt(), generator=gen),
                              overrides=overrides)
            finally:
                (self._mult_budget, self.engine,
                 self._overflow_escalations) = saved
        return {**counter.totals(), "by_source": counter.by_source(),
                "device": str(self.device)}

    def profile_stages(self, reps: int = 10) -> dict:
        """Milliseconds of each stage of a training step, each stage run
        alone (JAX ``vmc.py:1255-1393``: its stages, keys and branches):
        ``sample_ms`` (not in exact mode), ``sort_ms``, ``log_psi_ms``,
        ``matrix_elements_ms``, ``local_energy_ms`` (by the static, sector
        or proxy path, as the step takes it), ``grad_ms`` (log psi forward
        and backward under the Born weights) and, with ``sr``, ``sr_ms``;
        and ``device``. JAX's protocol: a warm-up call, then ``reps``
        calls, call i on the batch rolled by i + 1 where the stage takes
        one; the mean of the ``reps``, timed with CUDA events on a CUDA
        device and with the host clock on the CPU. The batch is the
        exact sector, or one canonically sorted sample of the current
        weights drawn from a generator seeded ``seed + 1`` (JAX draws it
        from ``PRNGKey(1)`` at fresh weights). Nothing of the trainer
        changes. Raises ``ValueError`` under a mesh of several ranks (a
        stage runs on one process's rows)."""
        if self._sharded:
            raise ValueError("profile_stages times one process's stages: "
                             "not under a mesh of several ranks")
        anqs, engine, cfg = self.anqs, self.engine, self.config
        samp = self.sampling_config
        timed = _stage_timer(self.device, reps)
        res = {}
        with torch.no_grad():
            if samp.mode == "exact":
                sw, sv = self.exact_words, self.exact_valid
            else:
                gen = torch.Generator(device=self.device).manual_seed(
                    cfg.seed + 1)
                budget = (self._mult_budget
                          or int(cfg.multinomial_budget or cfg.sample_num)
                          if samp.mode == "multinomial" else None)

                def draw(i=0):
                    return sample(anqs, samp, gen, budget=budget)

                res["sample_ms"] = timed(draw)
                words, _, valid, _ = draw()
                words = torch.where(valid[:, None], words, bitops.MASK32)
                sw, _, sv = keys.sort_words(words, valid)
            la, ph = anqs.log_psi(sw)

            def rolled(i):
                return torch.roll(sw, i + 1, 0)

            res["sort_ms"] = timed(lambda i: keys.sort_words(rolled(i), sv))
            res["log_psi_ms"] = timed(lambda i: anqs.log_psi(rolled(i)))
            res["matrix_elements_ms"] = timed(
                lambda i: engine.matrix_elements(rolled(i)))
            if self.exact_partner_idx is not None:
                def eloc(i):
                    return engine.local_energy_static(
                        sw, la, ph, sv, self.exact_partner_idx,
                        self.exact_partner_found)
            elif self.sector_words is not None:
                def eloc(i):
                    return engine.local_energy_sector(
                        sw, la, ph, sv, self.sector_words,
                        self.sector_partner_idx, self.sector_partner_found,
                        sector_pos=self.sector_pos)
            else:
                def eloc(i):
                    return engine.local_energy_proxy(sw, la, ph, sv)
            res["local_energy_ms"] = timed(eloc)
            freqs = torch.where(sv, torch.exp(2.0 * la), 0.0)
            freqs = freqs / torch.clamp(torch.sum(freqs), min=1e-30)
        params = dict(anqs.named_parameters())

        def grad(i):
            la2, ph2 = anqs.log_psi(sw)
            return _grad(torch.sum(freqs * (la2 + ph2)), list(params.values()))

        res["grad_ms"] = timed(grad)
        if cfg.sr is not None:
            g0 = dict(zip(params, _grad(torch.sum(freqs * anqs.log_psi(sw)[0]),
                                        list(params.values()))))
            res["sr_ms"] = timed(lambda i: sr_transform(
                anqs, params, g0, sw, freqs, cfg.sr))
        res["device"] = str(self.device)
        return res

    # ------------------------------------------------------------------
    # Distillation-interleaved VMC (JAX ``vmc.py:1123-1230``)
    # ------------------------------------------------------------------
    def make_distill_opt(self) -> FlatAdam:
        """The cycle's optimizer, ``optax.apply_if_finite(optax.adam,
        max_consecutive_errors=100)``, on the ansatz's parameters; its
        state persists across the cycles of one ``run`` and is not
        checkpointed (JAX ``vmc.py:1527-1588``)."""
        return FlatAdam(self.anqs.parameters(), max_consecutive_errors=100)

    def distill_cycle(self, state: TrainState, dopt: FlatAdam,
                      cfg: VMCConfig = None, samp: SamplingConfig = None,
                      uniforms=None, draw=None) -> dict:
        """One distillation cycle (JAX ``_distill_body``): the step's
        support and local energies (``_support_and_eloc``, drawing from
        ``state.generator`` as a step does), the imaginary-time targets
        (``it_targets`` at ``distill_tau``), then ``distill_steps`` Adam
        steps of ``dopt`` at ``distill_lr`` on the supervised loss, each
        keeping the pre-update parameters of the lowest loss, and one
        evaluation of the final parameters. The ansatz ends holding the
        best of them. Returns ``distill_loss_first``, ``distill_loss_last``
        (the lowest loss) and ``distill_energy`` (the support's Born energy)
        as device scalars: the cycle reads nothing back to the host. Under
        a mesh the cycle runs replicated on the set gathered whole."""
        cfg = cfg or self.config
        words, _, valid, _, la, ph, e = self._support_and_eloc(
            state, cfg, samp, uniforms, draw)
        words, valid, la, ph, e_re, e_im = replicate(
            (words, valid, la, ph, e.e_re, e.e_im), self.mesh)
        la_t, ph_t, m_re = it_targets(la, ph, e_re, e_im, valid,
                                      cfg.distill_tau)

        def soft(logits):
            z = torch.where(valid, logits, -torch.inf)
            u = torch.where(valid, torch.exp(z - torch.max(z)), 0.0)
            return u / torch.clamp(torch.sum(u), min=1e-30)

        use_ce = cfg.distill_loss == "ce"
        p_t = soft(2.0 * la_t)
        w_l = p_t if use_ce else soft(
            2.0 * la_t / (cfg.distill_temperature or 1.0))
        params = list(self.anqs.parameters())

        def sup_loss():
            la_g, ph_g = self.anqs.log_psi(words)
            la_g = torch.where(valid, la_g, 0.0)
            if use_ce:
                amp = -2.0 * torch.sum(p_t * la_g)
            else:
                d = torch.where(valid, la_g - la_t, 0.0)
                c = torch.sum(w_l * d)  # w_l sums to 1
                amp = torch.sum(w_l * (d - c) ** 2)
            dph = torch.where(valid, ph_g - ph_t, 0.0)
            return amp + cfg.distill_phase_weight * torch.sum(w_l * dph * dph)

        best_l = torch.full((), torch.inf, device=self.device)
        best_p = dopt.flat_params()
        first = None
        for _ in range(cfg.distill_steps):
            loss = sup_loss()
            grads = _grad(loss, params)
            loss = loss.detach()
            first = loss if first is None else first
            better = loss < best_l
            best_l = torch.where(better, loss, best_l)
            best_p = torch.where(better, dopt.flat_params(), best_p)
            dopt.step(grads, cfg.distill_lr)
        # The final parameters' own loss closes the snapshot.
        with torch.no_grad():
            loss_f = sup_loss()
        dopt.load(torch.where(loss_f < best_l, dopt.flat_params(), best_p))
        return {"distill_loss_first": first,
                "distill_loss_last": torch.minimum(loss_f, best_l),
                "distill_energy": m_re.to(torch.float32)}

    # ------------------------------------------------------------------
    # Checkpoints (JAX ``vmc.py:1396-1468``), one ``torch.save`` file
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, state: TrainState, it: int):
        """Write (parameters, the ansatz's config, optimizer and guard
        state, sampler generator, iteration, multinomial budget) to
        ``path/checkpoint.pt``."""
        os.makedirs(path, exist_ok=True)
        payload = {
            "params": {k: v.detach().cpu()
                       for k, v in self.anqs.state_dict().items()},
            "anqs_config": dataclasses.asdict(self.anqs.config),
            "opt": state.opt.state_dict(),
            "generator": state.generator.get_state(),
            "iter": int(it),
            "multinomial_budget": self._mult_budget,
        }
        target = os.path.join(path, CHECKPOINT_FILE)
        torch.save(payload, target + ".tmp")
        os.replace(target + ".tmp", target)

    def load_checkpoint(self, path: str) -> Tuple[TrainState, int]:
        """Restore a checkpoint into this trainer; returns (state, iter).
        Parameters of another layout raise ``ValueError``; optimizer state
        of another layout (e.g. another ``opt_type``) is dropped with a
        warning and the optimizer starts fresh."""
        ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE),
                          map_location="cpu", weights_only=True)
        want, got = _layout(self.anqs.state_dict()), _layout(ckpt["params"])
        if want != got:
            raise ValueError(f"checkpoint {path} param tree does not match "
                             f"this model: {got} vs expected {want}")
        self.anqs.load_state_dict(ckpt["params"])
        opt = self._make_opt()
        try:
            opt.load_state_dict(ckpt["opt"])
        except (ValueError, KeyError) as exc:
            logging.warning(
                "load_checkpoint(%s): optimizer state structure mismatch "
                "(%s); starting the optimizer FRESH -- Adam moments are lost "
                "and the resumed trajectory will differ.", path, exc,
            )
            opt = self._make_opt()
        gen = torch.Generator(device=self.device)
        gen.set_state(ckpt["generator"])
        self._mult_budget = ckpt["multinomial_budget"]
        return TrainState(opt=opt, generator=gen), int(ckpt["iter"])

    # ------------------------------------------------------------------
    # The driver loop (JAX ``vmc.py:1470-1663``)
    # ------------------------------------------------------------------
    def run(self, iter_num: Optional[int] = None, *, log_every: int = 50,
            on_iter=None, checkpoint_every: Optional[int] = 1000,
            resume_from: Optional[str] = None,
            profile_iters: Optional[tuple] = None, steps_per_call: int = 1,
            init_params=None):
        """Train to ``iter_num`` (default ``config.iter_num``); returns
        (state, history, best).

        Each row goes to ``history``, ``<run_dir>/result.csv`` (JAX's
        columns: the sorted metric names, then ``iter_idx``, ``wall_time``,
        ``full_energy``, ``full_energy_var``) and ``on_iter(it, row)``; a
        new best energy to ``<run_dir>/best_energy.npy`` and, with
        ``save_best_model``, the best-model cascade. Every
        ``checkpoint_every`` iterations a checkpoint ``<run_dir>/ckpt_<it>``
        is written, ``resume_from`` one of them continues. Steps run in
        windows of up to ``steps_per_call``, split at schedule boundaries
        and full-energy iterations and distillation cycles; the budget
        adaptation and the overflow policy act on each window's last row.
        With ``distill_period``, a cycle (``distill_cycle``) runs before
        the step of each iteration ``it > 0`` that the period divides; its
        metrics ride on that row, NaN on every other (and, after JAX's
        columns, in ``result.csv``). ``log_every``: a log line
        every that many iterations. ``profile_iters=(start, stop)``: a
        ``torch.profiler`` trace of those iterations in
        ``<run_dir>/profile``. ``init_params``: a state dict to start from
        (fresh optimizer). Under a mesh every rank trains and reads the
        resume, and rank 0 alone writes the files and logs, every rank
        waiting at a barrier after each row's writes."""
        iter_num = iter_num or self.config.iter_num
        start_iter = 0
        if resume_from:
            state, start_iter = self.load_checkpoint(resume_from)
        else:
            state = self.init_state()
            if init_params is not None:
                self.anqs.load_state_dict(init_params)
                state = TrainState(opt=self._make_opt(),
                                   generator=state.generator)
        history = []
        csv_path = (os.path.join(self.run_dir, "result.csv")
                    if self.run_dir else None)
        best = {"energy": np.inf, "iter": -1, "last_save": -np.inf}
        t0 = time.perf_counter()
        distill_on = bool(self.config.distill_period)
        dopt = None
        dpend = {}

        def save_best_model(it):
            now = time.perf_counter()
            if now - best["last_save"] < BEST_SAVE_INTERVAL_S:
                return
            best["last_save"] = now
            dirs = []
            if self.run_dir:
                dirs.append(os.path.join(self.run_dir, "best_model"))
            dirs.extend(self.config.extra_best_dirs)
            for d in dirs:
                self.save_checkpoint(d, state, it)
                np.save(os.path.join(d, "best_energy.npy"),
                        np.array([best["energy"], best["iter"]]))

        def handle_row(it, row):
            row["iter_idx"] = it
            row["wall_time"] = time.perf_counter() - t0
            row.setdefault("full_energy", float("nan"))
            row.setdefault("full_energy_var", float("nan"))
            if distill_on:
                for k in DISTILL_COLUMNS:
                    row.setdefault(k, dpend.pop(k, float("nan")))
            row = {k: row[k] for k in _csv_columns(row)}
            history.append(row)
            new_best = row["energy"] < best["energy"]
            if new_best:
                best.update({"energy": row["energy"], "iter": it})
            if self._writer:
                write_row(it, row, new_best)
            self._barrier()  # the other ranks wait for rank 0's files
            if on_iter is not None:
                on_iter(it, row)

        def write_row(it, row, new_best):
            if new_best:
                if self.run_dir:
                    np.save(os.path.join(self.run_dir, "best_energy.npy"),
                            np.array([best["energy"], best["iter"]]))
                if self.config.save_best_model:
                    save_best_model(it)
            if csv_path:
                write_header = not os.path.exists(csv_path)
                with open(csv_path, "a") as f:
                    if write_header:
                        f.write(",".join(row) + "\n")
                    f.write(",".join(str(v) for v in row.values()) + "\n")
            if (checkpoint_every and self.run_dir
                    and (it + 1) % checkpoint_every == 0):
                self.save_checkpoint(
                    os.path.join(self.run_dir, f"ckpt_{it + 1}"), state,
                    it + 1,
                )
            if log_every and it % log_every == 0:
                logging.info("iter %d energy %.6f unique_num %d", it,
                             row["energy"], int(row["unique_num"]))

        period = self.config.full_energy_period
        profiler = None
        it = start_iter
        while it < iter_num:
            if (profile_iters and profiler is None and self.run_dir
                    and self._writer
                    and profile_iters[0] <= it <= profile_iters[1]):
                profiler = _start_profiler(self.device)
            overrides = self._schedule_overrides(it)
            boundary = self._next_boundary(it)
            eff, samp = self._step_configs(overrides)
            dp = eff.distill_period or 0
            if dp and it > 0 and it % dp == 0:
                dopt = dopt or self.make_distill_opt()
                dmet = self.distill_cycle(state, dopt, eff, samp)
                # The cycle's one read-back.
                dpend.update(zip(dmet, torch.stack(
                    [v.to(torch.float64) for v in dmet.values()]).tolist()))
            fe_now = bool(period) and it > 0 and it % period == 0
            k_steps = 1
            if steps_per_call > 1 and not fe_now:
                k_steps = int(min(steps_per_call, iter_num - it,
                                  boundary - it))
                if period:
                    k_steps = min(k_steps, (it // period + 1) * period - it)
                if dp:
                    # No window swallows a cycle's iteration.
                    k_steps = min(k_steps, (it // dp + 1) * dp - it)
            for j in range(k_steps):
                row = self.step(state, overrides=overrides,
                                full_energy=fe_now)
                handle_row(it + j, row)
            self._adapt_budget(eff, row["unique_num"])
            self._handle_overflow({**row, "iter_idx": it + k_steps - 1})
            it += k_steps
            if profiler is not None and it > profile_iters[1]:
                _stop_profiler(profiler, self.device,
                               os.path.join(self.run_dir, "profile"))
                profiler, profile_iters = None, None
        if profiler is not None:
            _stop_profiler(profiler, self.device,
                           os.path.join(self.run_dir, "profile"))
        return state, history, best


def _grad(loss, params):
    """d loss / d params, zeros for a parameter the loss does not reach
    (the aux net under a ``sign_structure``), as JAX's grad gives."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _stage_timer(device, reps: int):
    """``timed(fn)``: ``fn(0)`` once, then the mean ms of ``fn(i)`` for i
    in range(``reps``) -- by CUDA events on a CUDA device, by the host
    clock on the CPU."""
    if reps < 1:
        raise ValueError(f"reps={reps}: expected >= 1")

    def timed(fn) -> float:
        fn(0)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(reps):
                fn(i)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / reps
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        return (time.perf_counter() - t0) * 1e3 / reps

    return timed


def _layout(state_dict) -> dict:
    """{name: (shape, dtype)} of a state dict."""
    return {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()}


def _csv_columns(row: dict):
    """JAX's result.csv columns: the step's metric names, sorted (the
    order of a JAX dict pytree), then the driver's own four, then the
    distillation cycle's three where the run has them."""
    tail = ("iter_idx", "wall_time", "full_energy", "full_energy_var") + (
        DISTILL_COLUMNS if DISTILL_COLUMNS[0] in row else ())
    return sorted(k for k in row if k not in tail) + list(tail)


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof, device, out_dir):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


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


def main_path_vmc(device="cuda", hidden_width: int = 512,
                  run_dir: Optional[str] = None,
                  anqs_options: Optional[dict] = None, sign_structure=None,
                  mesh=None, **overrides) -> VMC:
    """The main-path workload (JAX ``bench.py:build_vmc("gumbel")``,
    ``examples/n2_convergence.py``): N2/STO-3G, MADE ``hidden_width``,
    qubit_per_qudit 10, Gumbel top-k over the whole 14400-determinant
    sector (14464 rows), sector membership, MinSR top-50, clip 1.0, Adam
    1e-3, seed 0. ``anqs_options``: other ``AnqsConfig`` fields;
    ``sign_structure``: ``VMC``'s; ``overrides``: other ``VMCConfig``
    fields; ``mesh``: ``VMC``'s."""
    from ..chem.molecule import load_n2

    cfg = dict(sample_num=14464, sampling_mode="gumbel", qubit_per_qudit=10,
               lr=1e-3, grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
               seed=0)
    return VMC(
        load_n2(),
        VMCConfig(**{**cfg, **overrides}),
        AnqsConfig(**{"hidden_widths": (hidden_width,),
                      "aux_hidden_widths": (hidden_width,),
                      **(anqs_options or {})}),
        device=device,
        run_dir=run_dir,
        sign_structure=sign_structure,
        mesh=mesh,
    )


# The Li2O toy model with the reference's per-layer patterns, the log_psi
# head, masking depth, bfloat16 activations (``li2o_vmc(anqs_options=...)``;
# ``chip_smoke.py``'s options leg (d)).
LI2O_OPTIONS = dict(head_mode="log_psi", activation="sanqs_paper",
                    hidden_widths=(512, 512), bias=(True, True, False),
                    masking_depth=1, compute_dtype="bfloat16")


def li2o_vmc(device="cuda", hidden_width: int = 512,
             run_dir: Optional[str] = None,
             anqs_options: Optional[dict] = None, mesh=None,
             **overrides) -> VMC:
    """The reference's documented toy workload (its Colab notebook, JAX
    ``examples/li2o_toy_model.py``): Li2O/STO-3G, 30 qubits, MADE
    ``hidden_width``, qubit_per_qudit 6, Gumbel top-k over 8192 unique
    determinants, hash membership (the example's docstring names it; the
    41.4M-determinant sector is far beyond sector membership), MinSR
    top-50, clip 1.0, Adam 3e-3 (the example's schedule holds 3e-3 for its
    first 1200 steps), seed 0. ``anqs_options``: other ``AnqsConfig``
    fields; ``mesh``: ``VMC``'s; ``overrides``: other ``VMCConfig``
    fields."""
    from ..chem.molecule import load_li2o

    cfg = dict(sample_num=8192, sampling_mode="gumbel", qubit_per_qudit=6,
               lr=3e-3, grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
               engine_overrides={"membership": "hash"}, seed=0)
    return VMC(
        load_li2o(),
        VMCConfig(**{**cfg, **overrides}),
        AnqsConfig(**{"hidden_widths": (hidden_width,),
                      "aux_hidden_widths": (hidden_width,),
                      **(anqs_options or {})}),
        device=device,
        run_dir=run_dir,
        mesh=mesh,
    )


# The C2H4/6-31G trainer's two nets (JAX ``examples/c2h4_transformer.py``):
# the transformer ANQS with the logit soft-cap and a warm-up schedule, or
# MADE 512 with the Li2O-style schedule; each with its gradient clip.
C2H4_NETS = {
    "transformer": (
        AnqsConfig(net_type="transformer", d_model=128, n_layers=3,
                   n_heads=4, d_ff=512, logit_cap=4.0),
        ((0, 3e-5), (400, 1e-4), (1500, 3e-4)), 0.25),
    "made": (AnqsConfig(hidden_widths=(512,)),
             ((0, 1e-3), (1500, 3e-4)), 0.5),
}


def c2h4_vmc(device="cuda", net: str = "transformer", sample_num: int = 4096,
             run_dir: Optional[str] = None, **overrides) -> VMC:
    """The top rung of the reference ladder (JAX
    ``examples/c2h4_transformer.py``): C2H4/6-31G, 52 qubits (two words a
    determinant), 104278 terms in 20776 groups; ``net`` 'transformer'
    (d_model 128, 3 layers, 4 heads, d_ff 512, logit_cap 4) or 'made'
    (MADE 512), qubit_per_qudit 4 (13 qudits), ``sample_num`` Gumbel
    samples plus the 2048 pinned HF neighbours (``couple_ref_dets``:
    without them a 4096-state sample has no H-connected pairs), prefilter
    membership and the 'grouped' group order (both the engine's 'auto'),
    MinSR top-50, Adam on the net's learning-rate schedule and clip, seed
    0. ``overrides``: other ``VMCConfig`` fields."""
    from ..chem.molecule import load_c2h4

    anqs_config, lr_schedule, clip = C2H4_NETS[net]
    cfg = dict(sample_num=sample_num, sampling_mode="gumbel",
               qubit_per_qudit=4, lr=lr_schedule[0][1],
               lr_schedule=lr_schedule, grad_clip_norm=clip,
               sr=SRConfig(max_indices_num=50), couple_ref_dets=2048, seed=0)
    return VMC(load_c2h4(), VMCConfig(**{**cfg, **overrides}), anqs_config,
               device=device, run_dir=run_dir)


# The Li2O NADE campaign (JAX ``examples/cisd_pretrain_vmc.py`` with Li2O
# and 'nade', ``examples/li2o_closure.py``, ``li2o_distill_closure.py``):
# NADE-(128, 128) nets and the prefilter capacities its densely
# self-connected, CISD-pretrained sample sets need.
LI2O_NADE = AnqsConfig(net_type="nade", hidden_widths=(128, 128),
                       aux_hidden_widths=(128, 128))
LI2O_PREFILTER = {"prefilter_row_capacity": 768, "prefilter_dense_rows": 4096}
# JAX ``examples/cisd_pretrain_vmc.py``'s VMC settings for MADE and NADE
# (the closure legs change only the learning rates and add distillation).
CISD_VMC_CONFIG = dict(
    sample_num=8192, sampling_mode="gumbel", lr=3e-4,
    lr_schedule=((0, 3e-4), (1500, 1e-4), (3000, 3e-5)), grad_clip_norm=0.5,
    sr=SRConfig(max_indices_num=50), engine_overrides=LI2O_PREFILTER, seed=0)
# The examples' Li2O/STO-3G reference: the JAX package's in-tree direct-CI
# energy (``runs/li2o_fci_summary.json``; the molecule file holds no FCI).
LI2O_FCI_ENERGY = -88.705450


def li2o_nade_vmc(device="cuda", run_dir: Optional[str] = None,
                  **overrides) -> VMC:
    """The trainer of the Li2O NADE campaign at the examples' full width:
    Li2O/STO-3G, 30 qubits, NADE with hidden widths (128, 128) for both
    nets, qubit_per_qudit 6 (5 qudits), 8192 Gumbel samples, prefilter
    membership (the engine's 'auto' at 30 qubits) at capacities (768,
    4096), MinSR top-50, clip 0.5, gradient weights |psi|^(2/2), seed 0,
    and the first leg's Adam schedule (3e-4, 1e-4 from 1500, 3e-5 from
    3000). ``overrides``: other ``VMCConfig`` fields (each leg's learning
    rates, full-energy period and distillation)."""
    from ..chem.molecule import load_li2o

    cfg = dict(CISD_VMC_CONFIG, qubit_per_qudit=6,
               grad_weight_temperature=2.0)
    return VMC(load_li2o(), VMCConfig(**{**cfg, **overrides}), LI2O_NADE,
               device=device, run_dir=run_dir)


def li2o_nade_closure_params():
    """The JAX package's NADE-(128, 128) Li2O state after the closure leg
    (``runs/li2o_closure/ckpt_16000`` of ``examples/li2o_closure.py``,
    written by ``tools/export_jax_params.py`` into the port's data), as a
    state dict of ``li2o_nade_vmc``'s ansatz."""
    from ..chem.molecule import DATA_DIR
    from ..convert import load_params_npz

    return load_params_npz(os.path.join(DATA_DIR, "li2o_nade_closure.npz"))


# Cr2/SV at 84 qubits (JAX ``examples/cr2_step.py`` and ``cr2_train.py``):
# MADE 1024 with the logit cap, the pinned HF neighbourhood, and the
# engine's capacities and row blocks, which keep every (rows, M = 471,774)
# intermediate of the prefilter at 128 rows.
CR2_ANQS = AnqsConfig(hidden_widths=(1024,), logit_cap=8.0)
CR2_ENGINE = {"me_chunk": 128, "pf_row_chunk": 128,
              "prefilter_row_capacity": 1024, "prefilter_dense_rows": 64}
CR2_CKPT1000 = "cr2_train_ckpt1000.npz"


def cr2_config(sample_num: int = 1024, **overrides) -> VMCConfig:
    """The examples' Cr2/SV settings (``cr2_vmc``); ``overrides``: other
    ``VMCConfig`` fields."""
    cfg = dict(sample_num=sample_num, sampling_mode="gumbel",
               qubit_per_qudit=6, seed=0, couple_ref_dets=64,
               grad_clip_norm=1.0, sr=SRConfig(max_indices_num=50),
               engine_overrides=dict(CR2_ENGINE))
    return VMCConfig(**{**cfg, **overrides})


def cr2_vmc(device="cuda", sample_num: int = 1024,
            run_dir: Optional[str] = None, **overrides) -> VMC:
    """The examples' Cr2/SV trainer at full width: 84 qubits (three words a
    determinant), 2,240,694 terms in 471,774 groups (``load_cr2``), MADE
    1024 with logit_cap 8, qubit_per_qudit 6 (14 qudits), ``sample_num``
    Gumbel samples plus the 64 pinned HF neighbours, prefilter membership
    and the 'grouped' group order (both the engine's 'auto') at
    ``CR2_ENGINE``, MinSR top 50, clip 1.0, Adam 1e-3, seed 0
    (``cr2_config``). ``overrides``: other ``VMCConfig`` fields."""
    from ..chem.molecule import load_cr2

    return VMC(load_cr2(), cr2_config(sample_num, **overrides), CR2_ANQS,
               device=device, run_dir=run_dir)


def cr2_ckpt1000_params():
    """The JAX package's Cr2/SV state after 1000 iterations
    (``runs/cr2_train/ckpt_1000`` of ``examples/cr2_train.py``, written by
    ``tools/export_jax_params.py`` into the port's data), as a state dict
    of ``cr2_vmc``'s ansatz."""
    from ..chem.molecule import DATA_DIR
    from ..convert import load_params_npz

    return load_params_npz(os.path.join(DATA_DIR, CR2_CKPT1000))


def latest_checkpoint(run_dir: Optional[str]) -> Optional[str]:
    """The ``ckpt_<it>`` directory of ``run_dir`` with the largest ``it``,
    or None."""
    if not run_dir or not os.path.isdir(run_dir):
        return None
    found = [d for d in os.listdir(run_dir)
             if d.startswith("ckpt_") and d[5:].isdigit()]
    if not found:
        return None
    return os.path.join(run_dir, max(found, key=lambda d: int(d[5:])))
