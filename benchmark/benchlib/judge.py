"""The comparison that decides ``correct``.

The reference (``benchmark/reference``, its network the one the
configuration's ansatz file names) follows the program's first
``FOLLOWED_STEPS`` steps from the same initial weights, on the sets the
program sampled (the one stage it cannot redraw: the sampler's noise is
the program's), and the numbers compared are:

- ``set_errors``: rows of those sets that the sector forbids, duplicates,
  rows short of the sample count (or of the sector, where that is
  smaller or the sum is exact: then every sector determinant missing
  counts) and pinned HF neighbours missing (limit 0);
- ``log_psi_gap``: the largest gap of log|psi| or phase over the first
  step's set, where both sides hold the same weights;
- ``local_energy_gap``: the largest gap of a row's local-energy numerator
  t(x) = |psi(x)| E_loc(x), over the largest |t|, the reference working it
  out from the program's own log|psi| and phase of the set (so that it
  judges the matrix elements, the membership and the sums alone);
- ``energy_gap_ha``: the largest gap between the program's energy of a
  step and the reference's;
- ``grad_gap``: the gradient of the first update as the optimizer got it
  (Adam's first moment over 1 - beta1) against the reference's, by the
  worst leaf: the gap of their norms over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over the steps followed, by the
  worst leaf alike, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference.ansatz import words_to_bits
from reference.hamiltonian import GroupedPauliHamiltonian
from reference.vmc import UpdateConfig, follow

# Steps of the first window that the reference follows.
FOLLOWED_STEPS = 3
# A leaf whose reference gradient norm is under this share of the median
# leaf's is left out of ``change_gap``.
QUIET_LEAF = 1e-3


def reference_parts(config: dict, device):
    from .inputs import molecule_path
    from .manifest import ansatz_of

    ham = GroupedPauliHamiltonian(molecule_path(config), device)
    net = ansatz_of(config).reference(
        config, {"qubit_num": ham.qubit_num, "n_alpha": ham.n_alpha,
                 "n_beta": ham.n_beta}, device)
    cfg = UpdateConfig(lr=config["vmc"]["lr"],
                       clip=config["vmc"]["grad_clip_norm"],
                       sr_k=config["sr"]["max_indices_num"],
                       sr_eps=config["sr"]["reg_eps"])
    return net, ham, cfg


def set_errors(config: dict, cell: dict, ham, words: torch.Tensor) -> int:
    """Faults of one step's set of valid rows ``words`` (module doc)."""
    n = ham.qubit_num
    bits = words_to_bits(words, n)
    na = bits[:, 0::2].sum(1)
    nb = bits[:, 1::2].sum(1)
    bad = int(((na != ham.n_alpha) | (nb != ham.n_beta)).sum())
    uniq = torch.unique(words, dim=0)
    bad += words.shape[0] - uniq.shape[0]
    sector = math.comb((n + 1) // 2, ham.n_alpha) * math.comb(n // 2,
                                                            ham.n_beta)
    vmc = {**config["vmc"], **cell.get("vmc", {})}
    if vmc.get("sampling_mode", "gumbel") == "gumbel":
        sector = min(sector, int(vmc["sample_num"]))
    bad += max(0, sector - uniq.shape[0])
    k = int(config["vmc"].get("couple_ref_dets", 0))
    if k:
        pinned, values = ham.hf_neighbours(k)
        strong = values > values[-1] * (1.0 + 1e-6)
        bad += int(strong.sum()) - _present(pinned[strong], uniq)
    return bad


def _present(rows: torch.Tensor, among: torch.Tensor) -> int:
    both = torch.unique(torch.cat([among, rows]), dim=0)
    return among.shape[0] + rows.shape[0] - both.shape[0]


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep=None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm(ref)), over the leaves ``keep`` (default all)."""
    keep = list(ref) if keep is None else keep
    p = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keep}
    r = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    med = float(torch.tensor(list(r.values())).median())
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-300) for k in keep)


def readings(config: dict, cell: dict, params0, sets: List[torch.Tensor],
             energies: List[float], grad1: Dict[str, torch.Tensor],
             params_n: Dict[str, torch.Tensor], rows: List[tuple], device,
             parts=None, ref=None) -> dict:
    """The numbers compared for one run (module doc). ``sets``: each
    followed step's valid rows; ``rows``: each step's (log|psi|, phase,
    t_re, t_im) of those rows; ``energies``, ``grad1``, ``params_n``: the
    program's (or, for the control and the planted faults, a reference's
    put in its place). ``ref``: the float32 reference's ``follow`` of the
    program's sets, where already computed."""
    net, ham, cfg = parts or reference_parts(config, device)
    if ref is None:
        ref = follow(net, ham, params0, sets, cfg)
    r_grad = {k: v.to(device) for k, v in ref["grad1"].items()}
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in r_grad.items()}
    med = float(torch.tensor(list(norms.values())).median())
    moving = [k for k, v in norms.items() if v >= QUIET_LEAF * med]
    # An update that never came (the guard skipped it, or a fault) reads as
    # no gradient and no change.
    grad1 = {k: grad1.get(k, torch.zeros_like(v)) for k, v in r_grad.items()}
    params_n = {k: params_n.get(k, params0[k]) for k in params0}
    change_p = {k: params_n[k].to(device) - params0[k] for k in moving}
    change_r = {k: ref["params"][k].to(device) - params0[k] for k in moving}
    return {
        "set_errors": sum(set_errors(config, cell, ham, s) for s in sets),
        "energy_gap_ha": max(abs(a - b) if math.isfinite(a - b) else math.inf
                             for a, b in zip(energies, ref["energies"])),
        "grad_gap": leaf_gap({k: v.to(device) for k, v in grad1.items()},
                             r_grad),
        "change_gap": leaf_gap(change_p, change_r),
        "log_psi_gap": _log_psi_gap(net, params0, sets[0], rows[0]),
        "local_energy_gap": max(_t_gap(ham, s, r) for s, r in
                                zip(sets, rows)),
    }, ref


def _log_psi_gap(net, params0, words, row) -> float:
    with torch.no_grad():
        la, ph = net.log_psi(params0, words_to_bits(words, net.n))
    return max(float((row[0].double() - la.double()).abs().max()),
               float((row[1].double() - ph.double()).abs().max()))


def _t_gap(ham, words, row) -> float:
    la, ph, t_re, t_im = row
    r_re, r_im = ham.local_energy_numerators(words, la, ph)
    gap = torch.hypot(t_re.double() - r_re, t_im.double() - r_im)
    return float(gap.max() / torch.hypot(r_re, r_im).max())


def verdict(values: dict, limits: dict) -> bool:
    return all(values[k] <= limits[k] for k in limits)
