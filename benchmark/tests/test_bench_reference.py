"""The plain reference against the port on the CPU at a cut N2 size: log
psi (with and without the logit cap), the sample-aware local energies, both
ways of finding a pair's group, and one followed step."""

import pytest
import torch

from benchlib import inputs, judge, program
from reference.ansatz import MadeAnqs, words_to_bits
from reference.hamiltonian import GroupedPauliHamiltonian
from reference.vmc import follow

CPU = torch.device("cpu")


def sector_words(n: int, n_alpha: int, n_beta: int) -> torch.Tensor:
    """(N, W) words of every determinant with n_alpha electrons on the even
    qubits and n_beta on the odd ones, in increasing order."""
    from itertools import combinations

    alphas = [sum(1 << q for q in c)
              for c in combinations(range(0, n, 2), n_alpha)]
    betas = [sum(1 << q for q in c)
             for c in combinations(range(1, n, 2), n_beta)]
    dets = sorted(a | b for a in alphas for b in betas)
    w = -(-n // 32)
    return torch.tensor([[(d >> (32 * j)) & 0xFFFFFFFF for j in range(w)]
                         for d in dets], dtype=torch.int64)


@pytest.fixture(scope="module")
def tiny_cell():
    from conftest import TINY_DIR
    from benchlib.manifest import Manifest
    import os

    man = Manifest(os.path.join(TINY_DIR, "manifest.json"),
                   os.path.join(TINY_DIR, "workloads"))
    cell = man.cell("tiny.sampled")
    return cell, man.config(cell["config"])


@pytest.mark.parametrize("cap", [None, 8.0])
def test_log_psi_matches_the_port(tiny_cell, cap):
    cell, config = tiny_cell
    config = {**config, "ansatz": {**config["ansatz"], "logit_cap": cap}}
    vmc, _, params = program.build(config, cell, 11, CPU)
    ham = GroupedPauliHamiltonian(inputs.molecule_path(config))
    net = MadeAnqs(ham.qubit_num, ham.n_alpha, ham.n_beta,
                   config["vmc"]["qubit_per_qudit"], cap)
    words = sector_words(ham.qubit_num, ham.n_alpha, ham.n_beta)[::7]
    with torch.no_grad():
        la_p, ph_p = vmc.anqs.log_psi(words)
        la_r, ph_r = net.log_psi(params, words_to_bits(words, ham.qubit_num))
    assert torch.allclose(la_r, la_p, atol=2e-5, rtol=0)
    assert torch.allclose(ph_r, ph_p, atol=2e-5, rtol=0)
    # Normalised over the sector: sum |psi|^2 = 1.
    all_words = sector_words(ham.qubit_num, ham.n_alpha, ham.n_beta)
    with torch.no_grad():
        la_all, _ = net.log_psi(params, words_to_bits(all_words,
                                                      ham.qubit_num))
    assert float(torch.exp(2 * la_all.double()).sum()) == pytest.approx(
        1.0, abs=1e-4)


def test_local_energies_match_the_port(tiny_cell):
    cell, config = tiny_cell
    vmc, state, params = program.build(config, cell, 12, CPU)
    words, _, valid, _, la, ph, e = vmc._support_and_eloc(state)
    ham = GroupedPauliHamiltonian(inputs.molecule_path(config))
    t_re, t_im = ham.local_energy_numerators(words[valid], la[valid],
                                             ph[valid])
    scale = float(t_re.abs().max())
    assert torch.allclose(t_re, e.t_re[valid].double(), atol=1e-5 * scale)
    assert torch.allclose(t_im, e.t_im[valid].double(), atol=1e-5 * scale)


def test_pair_search_by_key_and_by_rows_agree(tiny_cell):
    _, config = tiny_cell
    ham = GroupedPauliHamiltonian(inputs.molecule_path(config))
    words = sector_words(ham.qubit_num, ham.n_alpha, ham.n_beta)[::9]
    keyed = ham.pairs(words)
    ham.keyed = False
    by_rows = ham.pairs(words)

    def canon(p):
        i, j, h = p
        order = torch.argsort(i * words.shape[0] + j)
        return i[order], j[order], h[order]

    for a, b in zip(canon(keyed), canon(by_rows)):
        assert torch.equal(a, b)
    assert keyed[0].numel() > words.shape[0]  # more than the diagonal


def test_one_followed_step_matches_the_program(tiny_cell):
    cell, config = tiny_cell
    vmc, state, params0 = program.build(config, cell, 13, CPU)
    first = program.FirstSteps(vmc, state, 3)
    _, warm = vmc._multi_step(3)(state)
    first.close()
    sets = [step[0][step[1]] for step in first.sets]
    rows = [tuple(t[step[1]] for t in step[2:]) for step in first.sets]
    values, ref = judge.readings(config, cell, params0, sets,
                                 list(warm["energy"]), first.grad1,
                                 first.params_n, rows, CPU)
    assert values["set_errors"] == 0
    assert abs(ref["energies"][0] - warm["energy"][0]) < 1e-4
    assert values["grad_gap"] < 1e-4
    assert values["change_gap"] < 5e-2
    assert values["log_psi_gap"] < 1e-4
    assert values["local_energy_gap"] < 1e-5
    # The reference moves from the initial weights as the program does.
    again = follow(*judge.reference_parts(config, CPU)[:2], params0, sets,
                   judge.reference_parts(config, CPU)[2])
    assert again["energies"] == ref["energies"]
