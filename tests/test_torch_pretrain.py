"""CISD targets and supervised pretraining of the PyTorch port against the
JAX package.

``cisd_ground_state`` is built from the Pauli Hamiltonian of the molecule
file and held against JAX's Slater-Condon CISD from the integrals: the same
determinants, the energy and the signed coefficients (up to one global
sign) -- and, for Li2O, against the JAX campaign's saved vector.
``pretrain`` is held step for step against JAX's on the full-batch path
and on the minibatch path fed JAX's own indices; ``keep_best`` rolls a
divergent stage back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem import fci as jax_fci
from anqs_quantum_chemistry_tpu.optim import pretrain as jax_pretrain
from anqs_quantum_chemistry_torch.chem import fci
from anqs_quantum_chemistry_torch.chem.molecule import load_li2o
from anqs_quantum_chemistry_torch.optim.pretrain import (
    amplitude_targets_from_coefs,
    pack_dets,
    pretrain,
)
from torch_port_common import ROOT, build_pair, molecules, to_np

LI2O_CISD = os.path.join(ROOT, "runs", "li2o_cisd_vector.npz")
NADE_KW = dict(net_type="nade", hidden_widths=(16, 16),
               aux_hidden_widths=(16, 16))


def assert_same_state(coef, want, atol):
    """Coefficients equal up to one global sign, each sign held."""
    sign = np.sign(np.dot(coef, want))
    np.testing.assert_allclose(sign * coef, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["LiH", "H2O", "N2"])
def test_cisd_ground_state_matches_jax(name):
    jmol, mol = molecules(name)
    hf_det = int(np.asarray(jmol.hf_det).ravel()[0])
    assert hf_det == mol.hf_det
    excitations = fci.excitations_in_sector(mol.hf_det, mol.qubit_num)
    np.testing.assert_array_equal(
        excitations,
        np.asarray(jax_fci._excitations_in_sector(hf_det, jmol.qubit_num),
                   np.uint64))
    e_j, dets_j, coef_j = jax_fci.cisd_ground_state(jmol.h1, jmol.v, hf_det,
                                                    jmol.e_nuc)
    e, dets, coef = fci.cisd_ground_state(mol.qubit_ham, mol.hf_det)
    assert dets.dtype == np.uint64
    np.testing.assert_array_equal(dets, np.asarray(dets_j, np.uint64))
    assert abs(e - e_j) < 1e-8
    assert_same_state(coef, np.asarray(coef_j), 1e-6)


@pytest.mark.skipif(not os.path.exists(LI2O_CISD),
                    reason="runs/li2o_cisd_vector.npz is not present")
def test_li2o_cisd_matches_jax_campaign_vector():
    """The packaged Li2O file's CISD against the JAX campaign's saved
    vector (``examples/cisd_pretrain_vmc.py``): 4425 determinants, E =
    -88.691153 Ha."""
    want = np.load(LI2O_CISD)
    e, dets, coef = fci.cisd_ground_state(load_li2o().qubit_ham,
                                          load_li2o().hf_det)
    assert len(dets) == 4425
    np.testing.assert_array_equal(dets, want["dets"])
    assert abs(e - float(want["e_cisd"])) < 1e-7
    assert_same_state(coef, want["coef"], 1e-5)


def test_targets_and_packing_match_jax():
    rng = np.random.default_rng(3)
    coef = rng.normal(size=50)
    coef[17] = -9.0  # the largest |c| is negative: the sign flips
    probs, phases = amplitude_targets_from_coefs(coef)
    jp, jph = jax_pretrain.amplitude_targets_from_coefs(coef)
    assert probs.dtype == phases.dtype == np.float32
    np.testing.assert_array_equal(probs, jp)
    np.testing.assert_array_equal(phases, jph)
    assert phases[17] == 0.0
    for qubits in (12, 40):
        dets = rng.integers(0, 1 << qubits, size=30, dtype=np.uint64)
        got = pack_dets(dets, qubits)
        want = np.asarray(jax_pretrain.pack_dets([int(d) for d in dets],
                                                 qubits))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def lih_targets():
    _, mol = molecules("LiH")
    _, dets, coef = fci.cisd_ground_state(mol.qubit_ham, mol.hf_det)
    probs, phases = amplitude_targets_from_coefs(coef)
    return dets, probs, phases


def run_both(iters, lr, batch, draws=None):
    """The same LiH start through JAX's and the port's ``pretrain``, every
    step logged; returns (JAX params, JAX history, port params, port
    history)."""
    mol, jax_anqs, params, anqs = build_pair("LiH", 2, **NADE_KW)
    dets, probs, phases = lih_targets()
    jwords = jax_pretrain.pack_dets([int(d) for d in dets], mol.qubit_num)
    jparams, jhist = jax_pretrain.pretrain(
        jax_anqs, params, jwords, probs, phases, jax.random.PRNGKey(0),
        iters=iters, lr=lr, batch=batch, log_every=1)
    draw = None if draws is None else (lambda it: draws[it])
    out, hist = pretrain(anqs, pack_dets(dets, mol.qubit_num), probs,
                         phases, iters=iters, lr=lr, batch=batch,
                         log_every=1, draw=draw)
    return jparams, jhist, out, hist


def assert_histories_close(hist, jhist):
    assert len(hist) == len(jhist)
    for row, jrow in zip(hist, jhist):
        assert row["iter"] == jrow["iter"]
        for k in ("loss", "cross_entropy", "phase_mse", "best_loss"):
            assert abs(row[k] - jrow[k]) <= 1e-5 * abs(jrow[k]) + 1e-7, (
                row, jrow)


def test_full_batch_pretrain_matches_jax():
    """50 full-batch steps on LiH's 92-determinant CISD support: the
    losses to 1e-5 relative and the returned parameters to 1e-5."""
    jparams, jhist, out, hist = run_both(50, 1e-3, 8192)
    assert_histories_close(hist, jhist)
    want = {f"{net}.{q}.{k}": v for net, tree in to_np(jparams).items()
            for q, sub in tree.items() for k, v in sub.items()}
    assert sorted(out) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(out[k].numpy(), v, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_minibatch_pretrain_matches_jax_draws():
    """Above ``batch`` determinants each step draws indices by
    probability; fed JAX's ``jax.random.choice`` draws (its key split once
    a step), the port's losses equal JAX's."""
    iters, batch = 20, 32
    _, probs, _ = lih_targets()
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.asarray(jax.random.choice(
            sub, len(probs), shape=(batch,), p=jnp.asarray(probs),
            replace=True)).astype(np.int64)))
    _, jhist, _, hist = run_both(iters, 1e-3, batch, draws)
    assert_histories_close(hist, jhist)


def test_minibatch_pretrain_own_draws():
    """With its own generator the minibatch path is reproducible from the
    seed and lowers the loss."""
    dets, probs, phases = lih_targets()
    _, mol = molecules("LiH")
    runs = []
    for _ in range(2):
        _, _, _, anqs = build_pair("LiH", 2, **NADE_KW)
        runs.append(pretrain(anqs, pack_dets(dets, mol.qubit_num), probs,
                             phases, torch.Generator().manual_seed(4),
                             iters=60, lr=3e-3, batch=32, log_every=10)[1])
    assert runs[0] == runs[1]
    assert runs[0][-1]["best_loss"] < runs[0][0]["loss"]


def test_keep_best_rolls_back_divergence():
    """A divergent stage (lr 50) returns the best snapshot, not the blown
    up final parameters (JAX ``tests/test_pretrain.py``); ``keep_best=
    False`` returns the final ones."""
    _, mol = molecules("LiH")
    dets, probs, phases = lih_targets()
    words = pack_dets(dets, mol.qubit_num)
    _, _, _, anqs = build_pair("LiH", 2, **NADE_KW)

    def loss_of():
        with torch.no_grad():
            la, ph = anqs.log_psi(words)
        tp = torch.from_numpy(probs).double()
        ce = -2.0 * float(torch.sum(tp * la.double()))
        dph = ph.double() - torch.from_numpy(phases).double()
        return ce + float(torch.sum(tp * dph * dph))

    _, hist1 = pretrain(anqs, words, probs, phases, iters=150, lr=3e-3)
    start = {k: v.detach().clone() for k, v in anqs.state_dict().items()}
    _, hist2 = pretrain(anqs, words, probs, phases, iters=50, lr=50.0)
    returned = loss_of()
    assert returned <= hist2[-1]["best_loss"] + 1e-3
    assert returned <= hist1[-1]["best_loss"] + 1e-3
    anqs.load_state_dict(start)
    pretrain(anqs, words, probs, phases, iters=50, lr=50.0,
             keep_best=False)
    assert loss_of() > returned + 0.1
