"""The support-CI closure of the PyTorch port (``experiments/support_ci.py``)
against the JAX package's, on LiH (STO-3G, MADE 16/16, qubit_per_qudit 3)
with the JAX package's initial weights (``params_from_jax``) and its
selected-CI vector from the HF determinant (225 determinants, the whole
sector) as the target.

Deterministic quantities (the target arrays, the polish loss and mass, the
restricted Rayleigh quotient, the sampled full energy of a sample drawn
from JAX's uniforms) agree to float32 rounding; short optimisations (a
polish stage, full-batch distillation, a few steps of ``support_vmc``
under each objective and with MinSR, a few L-BFGS evaluations) follow
JAX's trajectory to the stated tolerances. The polish result does not
depend on ``chunk``. ``select='loss'`` with a non-refit objective raises
in the port (in JAX it selects nothing)."""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from anqs_quantum_chemistry_tpu.chem import fci as jfci
from anqs_quantum_chemistry_tpu.chem import selected_ci as jsci
from anqs_quantum_chemistry_tpu.experiments import support_ci as jscp
from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments import support_ci as scp
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.sampling.sampler import uniform_shapes
from torch_port_common import jax_uniforms, molecules, to_np

CFG = dict(sample_num=128, sampling_mode="gumbel", qubit_per_qudit=3, seed=0)
NET = dict(hidden_widths=(16,), aux_hidden_widths=(16,))


@pytest.fixture(scope="module")
def lih():
    """(JAX VMC, its initial params, port VMC holding them, target dets,
    target coef, H over the target)."""
    jmol, mol = molecules("LiH")
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(**CFG), JaxAnqsConfig(**NET))
    params = jv.init_state()[0]
    v = VMC(mol, VMCConfig(**CFG), AnqsConfig(**NET), device="cpu")
    v.anqs.load_state_dict(params_from_jax(to_np(params)))
    _, dets, _ = jsci.selected_ci([jmol.hf_det], jmol.h1, jmol.v,
                                  jmol.e_nuc, n_parents=64, rounds=3,
                                  tol=1e-8)
    h = jfci.sparse_hamiltonian(dets, jmol.h1, jmol.v)
    # The ground state by dense eigh: ARPACK's start vector (eigsh inside
    # selected_ci) depends on how many eigsh calls the process made
    # before, and the float32 targets must not depend on test order.
    coef = np.linalg.eigh(h.toarray())[1][:, 0]
    return jv, params, v, dets, coef, h


@pytest.fixture
def port(lih):
    """The port's VMC, its parameters reset to JAX's initial ones."""
    jv, params, v = lih[:3]
    v.anqs.load_state_dict(params_from_jax(to_np(params)))
    return v


def targets(lih):
    jv, _, v, dets, coef, _ = lih
    return (jscp.make_target(dets, coef, jv.ham.qubit_num),
            scp.make_target(dets, coef, v.ham.qubit_num, "cpu"))


def log_psi_close(v, jv, jparams, words, atol):
    la, ph = scp.log_psi_rows(v.anqs, words)
    jla, jph = jv.anqs.log_psi(jparams, jax.numpy.asarray(words.numpy()))
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=0,
                               atol=atol)


def test_make_target_matches_jax(lih):
    jt, t = targets(lih)
    assert t["dets"] == jt["dets"] and len(t["dets"]) == 225
    np.testing.assert_array_equal(t["words"].numpy(),
                                  np.asarray(jt["words"]).astype(np.int64))
    for k in ("p", "la", "ph"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)


def test_sample_support_matches_jax(lih, port):
    """Gumbel samples of 256 > 225 rows hold the whole sector in either
    package: the union is the sector."""
    jv, params = lih[:2]
    dets = scp.sample_support(port, torch.Generator().manual_seed(0), 256,
                              passes=2)
    jdets, _ = jscp.sample_support(jv, params, jax.random.PRNGKey(0), 256,
                                   passes=2)
    assert dets == jdets and len(dets) == 225


@pytest.mark.parametrize("kind", ["lin", "log", "quad"])
def test_polish_loss_matches_jax(lih, port, kind):
    """The loss and mass at JAX's weights, as JAX's ``polish`` reports them
    for one step at lr 0 (its info row), to 1e-5 relative."""
    jv, params = lih[:2]
    jt, t = targets(lih)
    _, jinfo = jscp.polish(jv.anqs, params, jt, temp=2.0, lam=30.0,
                           kind=kind, lrs=(0.0,), steps=1, window=1,
                           chunk=256)
    with torch.no_grad():
        loss, mass = scp.polish_loss(port.anqs, t, 2.0, 30.0, kind)
    np.testing.assert_allclose(float(loss), jinfo[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(mass), jinfo[0]["mass"], rtol=1e-5)


@pytest.mark.parametrize("chunk", [None, 64])
def test_polish_stage_matches_jax(lih, port, chunk):
    """One stage of 40 steps at lr 3e-3 (clip 10, temperature 2, linear lam
    30), whole batch or slices of 64 rows: best loss and mass within 1e-4
    relative of JAX's (chunks of 256), and the fitted log|psi| and phase
    within 2e-4 on the target rows."""
    jv, params = lih[:2]
    jt, t = targets(lih)
    jp, jinfo = jscp.polish(jv.anqs, params, jt, lrs=(3e-3,), steps=40,
                            window=40, chunk=256)
    rows = []
    _, info = scp.polish(port.anqs, t, lrs=(3e-3,), steps=40, chunk=chunk,
                         on_stage=lambda row, p: rows.append(row))
    assert rows == info and len(info) == 1
    np.testing.assert_allclose(info[0]["loss"], jinfo[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose(info[0]["mass"], jinfo[0]["mass"], rtol=1e-4)
    log_psi_close(port, jv, jp, t["words"], 2e-4)


def test_polish_accept_rolls_back(lih, port):
    """An acceptance guard that never improves rolls every stage back: the
    input parameters come back bit for bit."""
    _, t = targets(lih)
    before = scp.snapshot(port.anqs)
    energies = iter([0.0, 1.0, 2.0])
    out, info = scp.polish(port.anqs, t, lrs=(3e-3, 1e-3), steps=5,
                           accept_fn=lambda p: next(energies))
    assert [r["accepted"] for r in info] == [False, False]
    for k, p in out.items():
        torch.testing.assert_close(p, before[k], rtol=0, atol=0)


def test_distill_full_batch_matches_jax(lih, port):
    """Distillation on the whole target (225 rows fit one batch: no draws),
    two stages of 30 steps: log|psi| and phase within 1e-4 of JAX's."""
    jv, params = lih[:2]
    jt, t = targets(lih)
    stages = ((30, 3e-3), (30, 1e-3))
    jp = jscp.distill(jv.anqs, params, jt, jax.random.PRNGKey(1), stages,
                      batch=4096)
    scp.distill(port.anqs, t, None, stages, batch=4096)
    log_psi_close(port, jv, jp, t["words"], 1e-4)


@pytest.mark.parametrize("row_chunk", [None, 32])
def test_sampled_full_energy_matches_jax(lih, port, row_chunk):
    """A sample of 128 drawn from JAX's uniforms of ``PRNGKey(3)``: the
    full energy and its variance within 2e-5 of JAX's, one batch or blocks
    of 32 rows."""
    jv, params = lih[:2]
    key = jax.random.PRNGKey(3)
    je, jvar = jscp.sampled_full_energy(jv, params, key, 128,
                                        row_chunk=row_chunk)
    u = jax_uniforms(key, uniform_shapes(port.anqs, 128))
    e, var = scp.sampled_full_energy(port, None, 128, row_chunk=row_chunk,
                                     uniforms=u)
    assert abs(e - je) < 2e-5
    assert abs(var - jvar) < 2e-5 * max(1.0, abs(jvar))


def test_support_rayleigh_matches_jax(lih, port):
    """Within 1e-6 Ha of JAX's (the two networks' float32 log|psi| differ
    by rounding); H built here or passed in gives the same quotient."""
    jv, params, _, _, _, h = lih
    jmol, mol = molecules("LiH")
    jt, t = targets(lih)
    e = scp.support_rayleigh(mol, t, port.anqs)
    assert abs(e - jscp.support_rayleigh(jmol, jt, jv.anqs, params)) < 1e-6
    assert abs(e - scp.support_rayleigh(mol, t, port.anqs, h=h)) < 1e-12


@pytest.mark.parametrize("objective,sr_k", [
    ("rq", 0), ("overlap", 0), ("refit", 0), ("rq_refit", 0), ("rq", 16)])
def test_support_vmc_matches_jax(lih, port, objective, sr_k):
    """6 steps at lr 1e-3 (mass_lam 1, clip 1000; MinSR over the top 16
    rows where ``sr_k``): every step's exact rq within 2e-6 Ha of JAX's,
    its mass and the objective's own metric within 1e-5, and the stage's
    best rq (select's default) within 2e-6 Ha."""
    jv, params, _, dets, coef, h = lih
    jmol, _ = molecules("LiH")
    jt, t = targets(lih)
    kw = dict(lrs=(1e-3,), steps_per_stage=6, mass_lam=1.0, grad_clip=1000.0,
              log_every=1, objective=objective, sr_k=sr_k, target_coef=coef)
    jrows, rows = [], []
    _, jinfo = jscp.support_vmc(jv.anqs, params, jt, h, jmol.e_nuc,
                                chunk=256, on_log=jrows.append, **kw)
    _, info = scp.support_vmc(port.anqs, t, h, jmol.e_nuc,
                              on_log=rows.append, **kw)
    assert len(rows) == len(jrows) == 6
    metric = {"overlap": "fid", "refit": "refit_loss",
              "rq_refit": "refit_loss"}.get(objective)
    for r, jr in zip(rows, jrows):
        assert abs(r["rq"] - jr["rq"]) < 2e-6, (r, jr)
        assert abs(r["mass"] - jr["mass"]) < 1e-5
        if metric:
            assert abs(r[metric] - jr[metric]) < 1e-5
    assert abs(info[0]["best_rq"] - jinfo[0]["best_rq"]) < 2e-6
    assert rows[-1]["rq"] <= rows[0]["rq"] or objective != "rq"


def test_support_vmc_repair_chain_select_and_baseline(lih, port):
    """JAX's repair-chain contract: under 'rq_refit' with ``select='loss'``
    the stage returns its best-loss parameters (moved from the start, loss
    no worse than the first step's); with an unbeatable
    ``accept_baseline`` every stage is rejected and the start comes back
    bit for bit."""
    jmol, _ = molecules("LiH")
    _, t = targets(lih)
    coef, h = lih[4], lih[5]
    start = scp.snapshot(port.anqs)
    rows = []
    out, info = scp.support_vmc(
        port.anqs, t, h, jmol.e_nuc, lrs=(1e-3,), steps_per_stage=20,
        mass_lam=1.0, grad_clip=1000.0, log_every=1, objective="rq_refit",
        refit_clip=1.0, refit_beta=0.05, target_coef=coef, select="loss",
        on_log=rows.append)
    assert info[0]["best_loss"] <= rows[0]["refit_loss"]
    assert any(not torch.equal(out[k], start[k]) for k in start)
    scp.restore(port.anqs, start)
    out, info = scp.support_vmc(
        port.anqs, t, h, jmol.e_nuc, lrs=(1e-3,), steps_per_stage=10,
        mass_lam=1.0, grad_clip=1000.0, accept_baseline=-1e9,
        accept_fn=lambda p: 0.0)
    assert [r["accepted"] for r in info] == [False]
    for k, p in out.items():
        torch.testing.assert_close(p, start[k], rtol=0, atol=0)


def test_support_vmc_select_loss_raises(lih, port):
    """JAX ignores ``select='loss'`` under 'rq' (no refit loss exists: its
    snapshot stays the input); the port refuses it."""
    _, t = targets(lih)
    h = lih[5]
    with pytest.raises(ValueError, match="select='loss'"):
        scp.support_vmc(port.anqs, t, h, 0.0, select="loss")
    with pytest.raises(ValueError, match="objective"):
        scp.support_vmc(port.anqs, t, h, 0.0, objective="energy")


def test_support_vmc_lbfgs_matches_jax(lih, port):
    """The flat vector in JAX's ``ravel_pytree`` order, bit for bit; then
    L-BFGS for up to 8 evaluations in segments of 4 (mass_lam 1): the first
    3 evaluations' rq and mass within 2e-6 of JAX's, and every segment's
    best rq variational within the support."""
    jv, params, _, dets, coef, h = lih
    jmol, _ = molecules("LiH")
    _, t = targets(lih)
    jt = targets(lih)[0]
    flat = torch.cat([dict(port.anqs.named_parameters())[n].detach()
                      .reshape(-1) for n in scp.flat_names(port.anqs)])
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(params)[0]))
    kw = dict(maxiter=8, segment=4, mass_lam=1.0, log_every=1)
    jrows, rows = [], []
    _, jinfo = jscp.support_vmc_lbfgs(jv.anqs, params, jt, h, jmol.e_nuc,
                                      chunk=256, on_log=jrows.append, **kw)
    _, info = scp.support_vmc_lbfgs(port.anqs, t, h, jmol.e_nuc,
                                    on_log=rows.append, **kw)
    for r, jr in zip(rows[:3], jrows[:3]):
        assert r["eval"] == jr["eval"]
        assert abs(r["rq"] - jr["rq"]) < 2e-6, (r, jr)
        assert abs(r["mass"] - jr["mass"]) < 2e-6
    e0 = jsci.restricted_ground_state(dets, jmol.h1, jmol.v, jmol.e_nuc)[0]
    assert len(info) >= 1
    for row in info:
        assert row["best_rq"] >= e0 - 1e-6
