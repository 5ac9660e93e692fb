"""Ansatz ensembles and replica-ensemble training of the PyTorch port
against the JAX package (``models/ensemble.py``; ``VMC.init_ensemble_state``
and ``_multi_step_ensemble``, JAX ``tests/test_ensemble_step.py``):

- ``ensemble_log_psi`` (``torch.func.vmap`` over ``functional_call``) from
  JAX's stacked parameters, carried across by ``convert.params_from_jax``,
  against JAX's vmap: 1e-5 (1e-4 with bfloat16 activations);
- ``ensemble_mean_energy`` against JAX's: 1e-6;
- the ensemble step on H2 (3 replicas, 4 steps, JAX's test set-up): each
  replica's energies against a standalone trainer of its seed, rtol and
  atol 2e-5 (JAX's tolerance), and two replicas apart;
- in exact summation (no sampling noise), the ensemble step from JAX's
  stacked initial state against JAX's own: energies to 1e-5 Ha.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models import ensemble as jens
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models import ensemble
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from torch_port_common import build_pair, molecules, to_np


@pytest.mark.parametrize("kw", [
    dict(hidden_widths=(16,), aux_hidden_widths=(16,)),
    dict(net_type="nade", hidden_widths=(8, 8), aux_hidden_widths=(8, 8),
         bias=(True, False, True)),
    dict(hidden_widths=(16,), head_mode="log_psi", compute_dtype="bfloat16"),
])
def test_ensemble_log_psi_matches_jax_vmap(kw):
    mol, jax_anqs, _, anqs = build_pair("LiH", 4, **kw)
    stacked = jens.ensemble_init(jax_anqs, jax.random.PRNGKey(4), 3)
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = dets.astype(np.int64)[:, None]
    la_j, ph_j = jens.ensemble_log_psi(jax_anqs, stacked,
                                       jnp.asarray(words, jnp.uint32))
    params = params_from_jax(to_np(stacked))
    assert {n: tuple(p.shape[1:]) for n, p in params.items()} == {
        n: tuple(p.shape) for n, p in anqs.named_parameters()}
    with torch.no_grad():
        la, ph = ensemble.ensemble_log_psi(anqs, params,
                                           torch.from_numpy(words))
    assert la.shape == (3, len(words))
    tol = 1e-4 if kw.get("compute_dtype") else 1e-5  # as in
    # test_torch_ansatz_options.py
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), atol=tol)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), atol=tol)


def test_ensemble_init_and_mean_energy():
    _, _, _, anqs = build_pair("LiH", 4, 16)
    own = {n: p.detach().clone() for n, p in anqs.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    stacked = ensemble.ensemble_init(anqs, [gen, gen])
    for n, p in anqs.named_parameters():
        assert torch.equal(p, own[n])  # the ansatz keeps its parameters
        assert stacked[n].shape == (2, *p.shape)
    anqs.reset_parameters(torch.Generator().manual_seed(0))
    for n, p in anqs.named_parameters():
        assert torch.equal(stacked[n][0], p)
    assert not torch.equal(stacked["main.w0"][0], stacked["main.w0"][1])

    e = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    w = np.asarray([1.0, 2.0, 0.5], np.float32)
    for weights in (None, w):
        want = jens.ensemble_mean_energy(
            e, None if weights is None else jnp.asarray(weights))
        got = ensemble.ensemble_mean_energy(
            torch.from_numpy(e),
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def h2_vmc(seed, **kw):
    """JAX test_ensemble_step.py's trainer: H2, 16 Gumbel samples, lr 1e-2,
    two 2-qubit qudits (one qudit would make the first conditional
    input-free and the early steps seed-independent), MADE 16."""
    _, mol = molecules("H2")
    cfg = dict(sample_num=16, sampling_mode="gumbel", lr=1e-2, seed=seed,
               qubit_per_qudit=2, **kw)
    return VMC(mol, VMCConfig(**cfg), AnqsConfig(hidden_widths=(16,)),
               device="cpu")


def test_ensemble_step_matches_standalone_runs():
    vmc = h2_vmc(0)
    n_rep, n_steps = 3, 4
    state = vmc.init_ensemble_state(n_rep)
    own = {n: p.detach().clone() for n, p in vmc.anqs.named_parameters()}
    state, metrics = vmc._multi_step_ensemble(n_steps, n_rep)(state)
    e_ens = metrics["energy"]
    assert e_ens.shape == (n_rep, n_steps)
    for n, p in vmc.anqs.named_parameters():
        assert torch.equal(p, own[n])
    for r in range(n_rep):
        solo = h2_vmc(r)
        s = solo.init_state()
        e = [solo.step(s)["energy"] for _ in range(n_steps)]
        np.testing.assert_allclose(e_ens[r], e, rtol=2e-5, atol=2e-5)
        for n, p in solo.anqs.named_parameters():
            assert torch.equal(state.params[n][r], p)
    assert not np.allclose(e_ens[0], e_ens[1])
    with pytest.raises(ValueError):
        vmc._multi_step_ensemble(n_steps, 2)(state)


def test_exact_ensemble_step_matches_jax():
    """Exact summation over H2's sector: JAX's stacked initial state
    (``init_ensemble_state``, seeds 0-1) through both packages' ensemble
    steps, Adam 1e-2, 3 steps: the energies to 1e-5 Ha."""
    jmol, mol = molecules("H2")
    cfg = dict(sampling_mode="exact", lr=1e-2, qubit_per_qudit=2, seed=0)
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(**cfg),
                  JaxAnqsConfig(hidden_widths=(16,)))
    sp, so, sk = jv.init_ensemble_state(2)
    _, _, _, jm = jv._multi_step_ensemble(3, 2)(sp, so, sk)
    v = VMC(mol, VMCConfig(**cfg), AnqsConfig(hidden_widths=(16,)),
            device="cpu")
    state = v.init_ensemble_state(2)
    state = state._replace(params=params_from_jax(to_np(sp)))
    _, metrics = v._multi_step_ensemble(3, 2)(state)
    np.testing.assert_allclose(metrics["energy"], np.asarray(jm["energy"]),
                               rtol=0, atol=1e-5)
