"""Support-CI closure on one card: enrich -> distill -> polish -> measure.

Counterpart of the JAX package's ``experiments/support_ci.py``. An ANQS
trained by top-k-sampled VMC is close to the ground state of H restricted
to the determinants its sampler proposes; the energy it still misses lives
in determinants it gives almost no weight. The closure:

1. enrich (host): selected CI from a seed support, e.g. the state's own
   sample (``sample_support``, ``chem/selected_ci.py``);
2. distill: minibatched cross-entropy pretraining onto the selected-CI
   vector (``distill``, ``optim/pretrain.py``);
3. polish: a deterministic fit over the whole support (``polish``) of the
   cross-entropy, a tempered offset-free regression of log|psi| on the
   target's, the phase MSE and a penalty on the probability mass that
   leaks off the support;
4. measure: the sampled full energy (``sampled_full_energy``: every
   connected amplitude of a fresh Gumbel sample through the network).

``support_vmc`` and ``support_vmc_lbfgs`` minimise the exact Rayleigh
quotient of the network restricted to the support (Adam with optional
MinSR, or L-BFGS); ``support_rayleigh`` evaluates it.

Where the JAX package maps chunks under ``jax.checkpoint`` (its TPU had 16
GB) and splits its optimizer scans into windows (its TPU's watchdog), the
port runs the support as one batch by default; ``chunk`` cuts it into row
slices, each recomputed in the backward pass
(``torch.utils.checkpoint``), which changes the peak memory and not the
result. Slices need no padding rows. The host does the float64 work (the
sparse matvec with H, the energies and the surrogate weights), the device
the network and its gradients, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..chem import fci as fci_mod
from ..chem.jw import words_to_ints
from ..ops import keys
from ..optim.adam import FlatAdam
from ..optim.pretrain import amplitude_targets_from_coefs, pack_dets, pretrain
from ..optim.sr import SRConfig, clip_grad_norm, sr_transform
from ..sampling.sampler import gumbel_top_k_sample

POLISH_KINDS = ("lin", "log", "quad")
OBJECTIVES = ("rq", "overlap", "refit", "rq_refit")
SELECTS = ("rq", "loss", "last")
# log|psi| is clamped here before exp(2 la): a transient spike above ~44
# overflows float32 and poisons the run with NaN (JAX's clamp).
LA_CLAMP = 20.0


def sample_support(vmc, generator: torch.Generator, sample_num: int,
                   passes: int = 3) -> list:
    """Sorted union of the determinants of ``passes`` Gumbel top-k samples
    of ``vmc.anqs`` (draws from ``generator``)."""
    out = set()
    for _ in range(passes):
        s = gumbel_top_k_sample(vmc.anqs, sample_num, generator)
        out.update(words_to_ints(s.words[s.valid].cpu().numpy()).tolist())
    return sorted(out)


def make_target(dets: Sequence[int], coef: np.ndarray, qubit_num: int,
                device="cuda") -> dict:
    """The distillation and polish target of a CI vector: ``dets`` (Python
    ints), packed ``words``, Born weights ``p`` and phases ``ph`` (float32,
    ``amplitude_targets_from_coefs``) and ``la`` = log sqrt(p), on
    ``device``. p is clamped at 1e-30 under the log (JAX's clamp: 1e-38 is
    denormal in float32 and flushes to zero)."""
    probs, phases = amplitude_targets_from_coefs(coef)
    p = torch.from_numpy(probs).to(device)
    return {
        "dets": [int(x) for x in dets],
        "words": pack_dets(dets, qubit_num).to(device),
        "p": p,
        "la": 0.5 * torch.log(torch.clamp(p, min=1e-30)),
        "ph": torch.from_numpy(phases).to(device),
    }


def distill(anqs, target: dict, generator: Optional[torch.Generator],
            stages, batch: int = 8192, on_log: Optional[Callable] = None,
            log_every: int = 200) -> Dict[str, torch.Tensor]:
    """Minibatched cross-entropy distillation (``optim.pretrain``) over the
    ``(iters, lr)`` stages; the ansatz ends holding, and this returns, the
    last stage's best-loss parameters."""
    params = None
    for iters, lr in stages:
        params, _ = pretrain(anqs, target["words"], target["p"], target["ph"],
                             generator, iters=iters, lr=lr, batch=batch,
                             on_log=on_log, log_every=log_every)
    return params


def snapshot(anqs) -> Dict[str, torch.Tensor]:
    """A copy of the ansatz's parameters by name."""
    return {n: p.detach().clone() for n, p in anqs.named_parameters()}


@torch.no_grad()
def restore(anqs, params: Dict[str, torch.Tensor]):
    for n, p in anqs.named_parameters():
        p.copy_(params[n])


def row_sums(anqs, words, fn: Callable, cols=(),
             chunk: Optional[int] = None) -> torch.Tensor:
    """Sum over row slices of ``torch.stack(fn(la, ph, *cols_slice))`` with
    (la, ph) = ``anqs.log_psi`` of the slice's words: the whole set as one
    batch (``chunk`` None), or slices of ``chunk`` rows, each recomputed in
    the backward pass when gradients are on."""
    n = words.shape[0]
    step = n if chunk is None else int(chunk)

    def part(w, *xs):
        la, ph = anqs.log_psi(w)
        return torch.stack(tuple(fn(la, ph, *xs)))

    total = None
    for s in range(0, n, step):
        args = (words[s:s + step],) + tuple(c[s:s + step] for c in cols)
        if chunk is not None and torch.is_grad_enabled():
            out = checkpoint(part, *args, use_reentrant=False)
        else:
            out = part(*args)
        total = out if total is None else total + out
    return total


def log_psi_rows(anqs, words, chunk: Optional[int] = None):
    """(la, ph) of every row, no autograd, in slices of ``chunk`` rows."""
    n = words.shape[0]
    step = n if chunk is None else int(chunk)
    with torch.no_grad():
        parts = [anqs.log_psi(words[s:s + step]) for s in range(0, n, step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _clip(grads, max_norm: float):
    """Global-norm clipping of a gradient list (optax
    ``clip_by_global_norm``)."""
    return list(clip_grad_norm(dict(enumerate(grads)), max_norm)[0].values())


def fit_stage(anqs, loss_fn: Callable[[], torch.Tensor], lr: float,
              steps: int, clip: Optional[float] = None):
    """``steps`` Adam steps at ``lr`` (after a global-norm clip at
    ``clip``, when given) on ``loss_fn()``, keeping on the device the
    parameters that produced the lowest loss (each step's loss belongs to
    its pre-update parameters; the final parameters are evaluated once
    more). The ansatz ends holding the best. Returns (best loss, first
    loss) as floats."""
    params = list(anqs.parameters())
    opt = FlatAdam(params)
    best_l = torch.full((), torch.inf, device=params[0].device)
    best_p = opt.flat_params()
    first = None
    for _ in range(steps):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, params)
        loss = loss.detach()
        first = loss if first is None else first
        better = loss < best_l
        best_l = torch.where(better, loss, best_l)
        best_p = torch.where(better, opt.flat_params(), best_p)
        if clip is not None:
            grads = _clip(grads, clip)
        opt.step(grads, lr)
    with torch.no_grad():
        loss_f = loss_fn()
    better = loss_f < best_l
    opt.load(torch.where(better, opt.flat_params(), best_p))
    first = loss_f if first is None else first
    return float(torch.minimum(loss_f, best_l)), float(first)


def polish_terms(anqs, target: dict, temp: float,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """The five sums of ``polish``'s loss over the target: sum p la, sum
    w dd, sum w dd^2, sum w dph^2 and the on-support mass sum exp(2 min(la,
    20)), with w = p^(1/temp) normalised and dd = la - la_t, dph = ph -
    ph_t on the rows of positive w (others selected out, as JAX's masks
    do). The sums are taken in float64: in float32 the mass of 131,072
    rows carries ~2e-7 of rounding, 7e-6 of the loss at lam 30."""
    w_l = target["p"] ** (1.0 / temp)
    w_l = w_l / torch.sum(w_l)

    def fn(la, ph, p, la_t, ph_t, wl):
        la, ph = la.double(), ph.double()
        keep = wl > 0
        dd = torch.where(keep, la - la_t, 0.0)
        dph = torch.where(keep, ph - ph_t, 0.0)
        return (torch.sum(p * la), torch.sum(wl * dd),
                torch.sum(wl * dd * dd), torch.sum(wl * dph * dph),
                torch.sum(torch.exp(2.0 * torch.clamp(la, max=LA_CLAMP))))

    return row_sums(anqs, target["words"], fn,
                    (target["p"], target["la"], target["ph"], w_l), chunk)


def polish_loss(anqs, target: dict, temp: float = 2.0, lam: float = 30.0,
                kind: str = "lin", chunk: Optional[int] = None):
    """``polish``'s (loss, mass): the cross-entropy -2 sum p la, the
    offset-free tempered regression sum w dd^2 - (sum w dd)^2, the tempered
    phase MSE and the mass penalty of ``kind``: 'lin' lam (1 - m), 'log'
    -lam log max(m, 1e-6), 'quad' lam (1 - m)^2."""
    if kind not in POLISH_KINDS:
        raise ValueError(f"kind={kind!r}: expected one of {POLISH_KINDS}")
    s = polish_terms(anqs, target, temp, chunk)
    m = s[4]
    if kind == "lin":
        pen = lam * (1.0 - m)
    elif kind == "log":
        pen = -lam * torch.log(torch.clamp(m, min=1e-6))
    else:
        pen = lam * (1.0 - m) ** 2
    return -2.0 * s[0] + s[2] - s[1] * s[1] + s[3] + pen, m


def _accept(accept_fn, anqs, row, best):
    """Stage acceptance (JAX ``polish``/``support_vmc``): measure the
    stage's parameters; keep them if their energy beats the best so far,
    else roll the ansatz back to the best. ``best`` = [energy, params]."""
    e_stage = float(accept_fn(snapshot(anqs)))
    row["energy"] = e_stage
    if best[0] is None or e_stage < best[0]:
        best[0], best[1] = e_stage, snapshot(anqs)
        row["accepted"] = True
    else:
        restore(anqs, best[1])
        row["accepted"] = False


def polish(anqs, target: dict, *, temp: float = 2.0, lam: float = 30.0,
           kind: str = "lin", lrs=(1e-4, 3e-5, 1e-5, 3e-6),
           steps: int = 2000, chunk: Optional[int] = None,
           on_stage: Optional[Callable] = None,
           accept_fn: Optional[Callable] = None):
    """Full-support deterministic fit of ``polish_loss`` (default: the
    linear mass penalty at lam 30, temperature 2): for each learning rate
    a stage of ``steps`` Adam steps after a global-norm clip at 10,
    keeping the best-loss parameters. Returns (params, info), one info row
    a stage (``stage``, ``lr``, ``loss``, ``mass``); ``on_stage(row,
    params)`` after each.

    ``accept_fn(params) -> energy`` guards the stages: the input state is
    candidate 0, a stage whose energy is not below the best so far is
    rolled back before the next stage starts, and the best accepted
    parameters are returned."""
    if kind not in POLISH_KINDS:
        raise ValueError(f"kind={kind!r}: expected one of {POLISH_KINDS}")
    info = []
    best = [None, None]
    if accept_fn is not None:
        best = [float(accept_fn(snapshot(anqs))), snapshot(anqs)]
    for si, lr in enumerate(lrs):
        bl, _ = fit_stage(
            anqs, lambda: polish_loss(anqs, target, temp, lam, kind,
                                      chunk)[0],
            lr, steps, clip=10.0)
        with torch.no_grad():
            m = float(polish_loss(anqs, target, temp, lam, kind, chunk)[1])
        row = {"stage": si, "lr": lr, "loss": bl, "mass": m}
        if accept_fn is not None:
            _accept(accept_fn, anqs, row, best)
        info.append(row)
        if on_stage is not None:
            on_stage(row, snapshot(anqs))
    if best[1] is not None:
        restore(anqs, best[1])
    return snapshot(anqs), info


def sampled_full_energy(vmc, generator: Optional[torch.Generator] = None,
                        sample_num: int = 16384,
                        row_chunk: Optional[int] = None, uniforms=None):
    """The unbiased sampled full energy: a fresh Gumbel sample of
    ``sample_num`` unique determinants (from ``generator``, or the given
    ``uniforms``), canonically sorted, every connected amplitude through
    the network (``PauliEngine.local_energy_full``), Born-weighted.
    Returns (energy, variance) as floats. With ``row_chunk`` the rows go
    through in blocks whose local energies are combined in float64 on the
    host (JAX's form for a device too small for the whole sample)."""
    s = gumbel_top_k_sample(vmc.anqs, sample_num, generator, uniforms)
    if not bool(torch.all(s.valid)):
        raise ValueError("sample not full; shrink sample_num")
    sw = keys.sort_words(s.words)[0]
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(sw)
        valid = torch.ones(sw.shape[0], dtype=torch.bool, device=sw.device)
        if row_chunk is None:
            e_re, _, var = vmc._full_energy(sw, la, ph, valid)
            return float(e_re), float(var)
        n = sw.shape[0]
        if n % row_chunk:
            raise ValueError(f"row_chunk {row_chunk} does not divide {n}")
        e_rows = np.concatenate([
            vmc.engine.local_energy_full(
                vmc.anqs, sw[i:i + row_chunk], la[i:i + row_chunk],
                ph[i:i + row_chunk], valid[i:i + row_chunk],
            ).e_re.cpu().numpy().astype(np.float64)
            for i in range(0, n, row_chunk)
        ])
    la64 = la.cpu().numpy().astype(np.float64)
    w = np.exp(2.0 * (la64 - la64.max()))
    w = w / w.sum()
    e = float(w @ e_rows)
    return e, float(w @ (e_rows - e) ** 2)


def _restricted_energy(h64, la, ph, e_nuc: float):
    """Host float64 quantities of the amplitudes (la, ph) over the support:
    (c, norm, e_loc = (H c) / c, Born p, real energy without e_nuc, rq)."""
    la64 = la.cpu().numpy().astype(np.float64)
    ph64 = ph.cpu().numpy().astype(np.float64)
    c = np.exp(la64 - la64.max()) * (np.cos(ph64) + 1j * np.sin(ph64))
    nrm = float(np.vdot(c, c).real)
    e_loc = (h64 @ c) / c
    p = (c.conj() * c).real / nrm
    e_r = float(p @ e_loc.real)
    return la64, ph64, c, nrm, e_loc, p, e_r, e_r + e_nuc


def support_vmc(anqs, target: dict, h_csr, e_nuc: float, *,
                lrs=(3e-4, 1e-4, 3e-5), steps_per_stage: int = 600,
                chunk: Optional[int] = None, mass_lam: float = 0.0,
                grad_clip: float = 10.0, log_every: int = 25, sr_k: int = 0,
                sr_eps: float = 1e-4, objective: str = "rq",
                refit_temp: float = 2.0, refit_phase_weight: float = 1.0,
                refit_clip: float = 3.0, refit_beta: float = 1.0,
                target_coef: Optional[np.ndarray] = None,
                select: Optional[str] = None,
                accept_baseline: Optional[float] = None,
                on_log: Optional[Callable] = None,
                on_stage: Optional[Callable] = None,
                accept_fn: Optional[Callable] = None):
    """Support-restricted deterministic VMC: Adam (after a global-norm clip
    at ``grad_clip``; with ``sr_k`` > 0, MinSR over the top-``sr_k``
    support rows by Born weight first) on the exact Rayleigh quotient of
    the network over the target's support. Each step: the device computes
    (la, ph) of every row; the host forms c = exp(la + i ph), e_loc = (H_S
    c) / c with the float64 CSR ``h_csr`` (no e_nuc on its diagonal), the
    exact quotient rq and float32 surrogate weights (g, h); the device
    takes the gradient of 2 sum (g la + h ph) (plus ``mass_lam`` (1 -
    mass), the linear on-support mass penalty). ``objective``:

    - 'rq': g = p (Re e_loc - E), h = p Im e_loc, the energy gradient;
    - 'overlap': the gradient of -log |<t|psi>|^2 + log <psi|psi> against
      the target vector t (``target_coef``, else rebuilt from the target's
      p and ph);
    - 'refit': a tempered (weights |t|^(2/refit_temp)) offset-free
      regression of la on log|t|, residuals clipped at ``refit_clip``,
      plus ``refit_phase_weight`` times the circular phase loss about the
      optimal global phase;
    - 'rq_refit': the 'rq' weights plus ``refit_beta`` times the refit's.

    ``select`` picks the stage's end point: 'rq' (the lowest exact rq; the
    default for 'rq' and 'overlap'), 'loss' (the lowest refit loss; the
    default for the refit objectives) or 'last'. 'loss' with a non-refit
    objective raises ``ValueError``: it has no loss to select by.
    ``accept_fn`` (the sampled full energy of the parameters) guards the
    stages as in ``polish``, against ``accept_baseline`` when given, else
    against the input state. Returns (params, info)."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    refit = objective in ("refit", "rq_refit")
    if select is None:
        select = "loss" if refit else "rq"
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}")
    if select == "loss" and not refit:
        raise ValueError(f"select='loss' needs a refit objective, not "
                         f"{objective!r}: it would select nothing")
    words = target["words"]
    n_rows = words.shape[0]
    h64 = h_csr
    t_c = None
    if objective != "rq":
        if target_coef is not None:
            t_c = np.asarray(target_coef, np.float64)
        else:
            t_c = (np.sqrt(target["p"].cpu().numpy().astype(np.float64))
                   * np.cos(target["ph"].cpu().numpy().astype(np.float64)))
        t_c = t_c / np.linalg.norm(t_c)
    if refit:
        w_ref = np.abs(t_c) ** (2.0 / refit_temp)
        w_ref = w_ref / w_ref.sum()
        la_t = np.log(np.maximum(np.abs(t_c), 1e-300))
        ph_t = np.where(t_c < 0, np.pi, 0.0)
    sr_cfg = SRConfig(max_indices_num=sr_k, reg_eps=sr_eps) if sr_k else None
    names = [n for n, _ in anqs.named_parameters()]
    params = list(anqs.parameters())
    device = params[0].device

    def loss_fn(g_t, h_t):
        s = row_sums(
            anqs, words,
            lambda la, ph, g, h: (
                torch.sum(g * la + h * ph),
                torch.sum(torch.exp(2.0 * torch.clamp(la, max=LA_CLAMP)))),
            (g_t, h_t), chunk)
        loss = 2.0 * s[0]
        if mass_lam:
            loss = loss + mass_lam * (1.0 - s[1])
        return loss, s[1].detach()

    info = []
    best = [None, None]
    if accept_baseline is not None:
        best = [float(accept_baseline), snapshot(anqs)]
    elif accept_fn is not None:
        best = [float(accept_fn(snapshot(anqs))), snapshot(anqs)]

    for si, lr in enumerate(lrs):
        opt = FlatAdam(params)
        best_rq, best_rq_params = np.inf, snapshot(anqs)
        best_loss, best_loss_params = np.inf, snapshot(anqs)
        for it in range(steps_per_stage):
            la, ph = log_psi_rows(anqs, words, chunk)
            la64, ph64, c, nrm, e_loc, p, e_r, rq = _restricted_energy(
                h64, la, ph, e_nuc)
            if rq < best_rq:
                best_rq, best_rq_params = rq, snapshot(anqs)
            if objective == "overlap":
                w_ov = t_c * c / np.sqrt(nrm)
                z = w_ov.sum()
                n_ov = (z.conj() * z).real
                zw = (np.conj(z) * w_ov) / max(n_ov, 1e-300)
                g = p - zw.real
                h = zw.imag
            elif refit:
                dla = la64 - la_t
                mu = float(w_ref @ dla)
                # The starved tail sits at dla ~ -13..-25: unclipped, its
                # pull wrecks the top amplitudes (JAX's clamp).
                r_la = np.clip(dla - mu, -refit_clip, refit_clip)
                g = 2.0 * w_ref * r_la
                dph = ph64 - ph_t
                theta = np.angle(complex(w_ref @ np.exp(1j * dph)))
                h = refit_phase_weight * w_ref * np.sin(dph - theta)
                refit_loss = float(
                    w_ref @ (dla - mu) ** 2 + refit_phase_weight
                    * (w_ref @ (1.0 - np.cos(dph - theta))))
                if refit_loss < best_loss:
                    best_loss, best_loss_params = refit_loss, snapshot(anqs)
                if objective == "rq_refit":
                    g = p * (e_loc.real - e_r) + refit_beta * g
                    h = p * e_loc.imag + refit_beta * h
            else:
                g = p * (e_loc.real - e_r)
                h = p * e_loc.imag
            g_t = torch.from_numpy(g.astype(np.float32)).to(device)
            h_t = torch.from_numpy(h.astype(np.float32)).to(device)
            loss, m = loss_fn(g_t, h_t)
            grads = torch.autograd.grad(loss, params)
            if sr_cfg is not None:
                k_eff = min(sr_k, n_rows)
                idx = np.argpartition(-p, k_eff - 1)[:k_eff]
                top_f = (p[idx] / p[idx].sum()).astype(np.float32)
                grads = list(sr_transform(
                    anqs, dict(anqs.named_parameters()),
                    dict(zip(names, grads)),
                    words[torch.from_numpy(idx).to(device)],
                    torch.from_numpy(top_f).to(device), sr_cfg).values())
            opt.step(_clip(grads, grad_clip), lr)
            if on_log is not None and (it % log_every == 0
                                       or it == steps_per_stage - 1):
                row_log = {"stage": si, "iter": it, "rq": rq,
                           "mass": float(m), "best_rq": best_rq}
                if objective == "overlap":
                    row_log["fid"] = n_ov
                elif refit:
                    row_log["refit_loss"] = refit_loss
                on_log(row_log)
        if select == "rq":
            restore(anqs, best_rq_params)
        elif select == "loss":
            restore(anqs, best_loss_params)
        row = {"stage": si, "lr": lr, "best_rq": best_rq}
        if select == "loss":
            row["best_loss"] = best_loss
        if accept_fn is not None:
            _accept(accept_fn, anqs, row, best)
        info.append(row)
        if on_stage is not None:
            on_stage(row, snapshot(anqs))
    if accept_fn is not None and best[1] is not None:
        restore(anqs, best[1])
    return snapshot(anqs), info


def flat_names(anqs) -> list:
    """Parameter names in the order of JAX's ``ravel_pytree`` over the
    nested parameter dict: sorted by their dotted path."""
    return sorted((n for n, _ in anqs.named_parameters()),
                  key=lambda n: n.split("."))


def support_vmc_lbfgs(anqs, target: dict, h_csr, e_nuc: float, *,
                      maxiter: int = 2000, segment: int = 200,
                      chunk: Optional[int] = None, mass_lam: float = 3.0,
                      mass_floor: Optional[float] = None,
                      mass_width: float = 2e-4, mass_slack: float = 0.0,
                      history: int = 20, log_every: int = 25,
                      on_log: Optional[Callable] = None,
                      on_stage: Optional[Callable] = None,
                      accept_fn: Optional[Callable] = None):
    """Quasi-Newton support-restricted VMC: scipy's L-BFGS-B over the
    parameters as one float64 vector (in ``flat_names`` order, JAX's
    ``ravel_pytree``), on the exact restricted Rayleigh quotient plus a
    smooth hinge on the on-support mass, mass_lam * w * softplus((floor -
    mass) / w) with w = ``mass_width``: no force above the floor
    (``mass_floor``, default the first evaluation's mass less
    ``mass_slack``). The gradient is the ``support_vmc`` surrogate's with
    g less sigmoid((floor - mass) / w) mass_lam q (q = exp(2 la)).

    Runs in restarts of ``segment`` evaluations up to ``maxiter``; each
    ends with the best exact rq among evaluations whose mass held the
    floor (within 2 w), an optional ``accept_fn`` measurement (as in
    ``support_vmc``, without rollback) and ``on_stage``; a segment that
    gains less than 1 uHa stops the run. Returns (params, info)."""
    import scipy.optimize

    words = target["words"]
    names = flat_names(anqs)
    by_name = dict(anqs.named_parameters())
    ordered = [by_name[n] for n in names]
    sizes = [p.numel() for p in ordered]
    device = ordered[0].device

    @torch.no_grad()
    def load_flat(x):
        flat = torch.from_numpy(np.asarray(x, np.float32)).to(device)
        for p, part in zip(ordered, flat.split(sizes)):
            p.copy_(part.view_as(p))

    def flatten(tensors):
        return torch.cat([t.detach().reshape(-1) for t in tensors]).cpu(
        ).numpy().astype(np.float64)

    state = {"evals": 0, "best_rq": np.inf, "best_x": None,
             "floor": mass_floor}

    def f_and_g(x):
        state["evals"] += 1
        load_flat(x)
        la, ph = log_psi_rows(anqs, words, chunk)
        la64, _, _, _, e_loc, p, e_r, rq = _restricted_energy(
            h_csr, la, ph, e_nuc)
        q = np.exp(2.0 * np.minimum(la64, LA_CLAMP))
        mass = float(np.sum(q))
        if state["floor"] is None:
            state["floor"] = mass - mass_slack
        m0, w = state["floor"], mass_width
        u = (m0 - mass) / w
        pen = mass_lam * w * np.logaddexp(0.0, u)
        sig = mass_lam / (1.0 + np.exp(-u))
        if rq < state["best_rq"] and mass >= m0 - 2.0 * w:
            state["best_rq"], state["best_x"] = rq, np.array(x)
        g = (p * (e_loc.real - e_r)).astype(np.float32)
        if mass_lam:
            g = g - (sig * q).astype(np.float32)
        hh = (p * e_loc.imag).astype(np.float32)
        g_t = torch.from_numpy(g).to(device)
        h_t = torch.from_numpy(hh).to(device)
        s = row_sums(anqs, words,
                     lambda la_, ph_, g_, h_: (torch.sum(g_ * la_
                                                         + h_ * ph_),),
                     (g_t, h_t), chunk)
        grads = torch.autograd.grad(2.0 * s[0], ordered)
        if on_log is not None and state["evals"] % log_every == 0:
            on_log({"eval": state["evals"], "rq": rq, "mass": mass,
                    "best_rq": state["best_rq"]})
        return rq + pen, flatten(grads)

    info = []
    best_e, best_params = None, None
    if accept_fn is not None:
        best_e, best_params = float(accept_fn(snapshot(anqs))), snapshot(
            anqs)
    x = flatten(ordered)
    prev_best = np.inf
    for si in range(max(1, -(-maxiter // segment))):
        state["best_rq"], state["best_x"] = np.inf, None
        res = scipy.optimize.minimize(
            f_and_g, x, jac=True, method="L-BFGS-B",
            options={"maxiter": segment, "maxcor": history, "ftol": 1e-15,
                     "gtol": 1e-12})
        x = state["best_x"] if state["best_x"] is not None else res.x
        load_flat(x)
        row = {"stage": si, "lr": 0.0, "best_rq": state["best_rq"],
               "evals": state["evals"], "scipy_msg": str(res.message)}
        if accept_fn is not None:
            e_stage = float(accept_fn(snapshot(anqs)))
            row["energy"] = e_stage
            row["accepted"] = best_e is None or e_stage < best_e
            if row["accepted"]:
                best_e, best_params = e_stage, snapshot(anqs)
        info.append(row)
        if on_stage is not None:
            on_stage(row, snapshot(anqs))
        # Only a measured stagnation stops the run: scipy's own early
        # exits (line-search failures on float32 roughness) are restarts.
        if np.isfinite(prev_best) and prev_best - state["best_rq"] < 1e-6:
            break
        prev_best = min(prev_best, state["best_rq"])
    if best_params is not None:
        restore(anqs, best_params)
    return snapshot(anqs), info


def support_rayleigh(mol, target: dict, anqs, h=None) -> float:
    """Exact host Rayleigh quotient of the network's real part restricted
    to the target support: c = exp(la - max la) cos(ph), c H c / c c +
    e_nuc. H is ``h`` when given (its callers build it once), else built
    from the molecule's integrals (``fci.sparse_hamiltonian``)."""
    if h is None:
        h = fci_mod.sparse_hamiltonian(target["dets"], mol.h1, mol.v)
    la, ph = log_psi_rows(anqs, target["words"])
    la = la.cpu().numpy().astype(np.float64)
    c = np.exp(la - la.max()) * np.cos(ph.cpu().numpy().astype(np.float64))
    return float(c @ (h @ c) / (c @ c)) + mol.e_nuc
