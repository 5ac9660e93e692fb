"""Couplings of the VMC trainer (pinned determinants added to every step's
set) against the JAX package, and the C2H4 transformer slice.

* ``ref_neighbor_words`` (``couple_ref_dets``) equals JAX's set; where
  JAX's k-th and (k+1)-th |<HF ^ A_m|H|HF>| tie within 1e-6 relative, the
  port's set must be a valid top-k that matches JAX's outside the tie.
* ``interleave_swap`` equals JAX's bit for bit at one and two words.
* One step on H2O/STO-3G with each coupling (``couple_ref_dets`` on the
  sector path, ``couple_support_file`` under hash membership,
  ``couple_spin_flip`` under prefilter membership), from one set of
  weights and JAX's uniforms: energy within 1e-6 Ha, gradients (SGD at lr
  1) to 1e-5 of their largest magnitude, ``unique_num`` and
  ``found_pairs`` equal.
* The slice: one C2H4/6-31G step (52 qubits, two words) of a tiny
  transformer (d 16, 2 layers, 2 heads, d_ff 32, ``logit_cap`` 4, qubit per
  qudit 4), 64 Gumbel samples and 64 pinned HF neighbours, prefilter
  membership and the 'grouped' group order (both engines' 'auto'): energy
  within 1e-5 Ha + 4e-7 relative (float32 at |E| ~ 78 Ha),
  ``unique_num``, ``found_pairs`` and ``pf_dropped_rows`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.ops import bits as bitops
from anqs_quantum_chemistry_torch.optim.sr import SRConfig
from anqs_quantum_chemistry_torch.sampling.sampler import uniform_shapes
from torch_port_common import jax_uniforms, molecules, to_np

TINY_TRANSFORMER = dict(net_type="transformer", d_model=16, n_layers=2,
                        n_heads=2, d_ff=32, logit_cap=4.0)


def build(name, cfg, anqs_kw, membership=None):
    """(JAX VMC, port VMC, JAX (params, opt_state, key), port state), the
    port loaded with the JAX weights. ``membership``: a dynamic membership
    of both engines, with the JAX trainer's sector membership off (the
    port's is off under a named membership)."""
    jmol, mol = molecules(name)
    jcfg, port_cfg = dict(cfg), dict(cfg)
    if membership:
        jcfg.update(engine_overrides={"membership": membership},
                    sector_membership="off")
        port_cfg["engine_overrides"] = {"membership": membership}
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(sr=JaxSRConfig(max_indices_num=50),
                                       **jcfg),
                  JaxAnqsConfig(**anqs_kw))
    v = VMC(mol, VMCConfig(sr=SRConfig(max_indices_num=50), **port_cfg),
            AnqsConfig(**anqs_kw), device="cpu")
    params, opt_state, key = jv.init_state()
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(params)))
    return jv, v, (params, opt_state, key), state


def one_step(jv, v, jstate, state, sample_num):
    """One step of each package from the same weights and uniforms:
    (port metrics, JAX metrics, port grads, JAX update at SGD lr 1)."""
    p0, o0, key = jstate
    p1, _, _, jm = jv._step(p0, o0, key)
    _, sample_key = jax.random.split(key)
    uniforms = jax_uniforms(sample_key, uniform_shapes(v.anqs, sample_num))
    metrics, grads = v._grads_and_metrics(state, uniforms)
    want = params_from_jax(to_np(jax.tree.map(lambda a, b: a - b, p0, p1)))
    return metrics, jm, grads, want


def _ref_set_matches(got_words, jv, k):
    """The port's pinned set against JAX's, tie-aware (module docstring)."""
    me = np.abs(np.asarray(jv.engine.matrix_elements(jv.hf_words))[0])
    a = np.asarray(jv.engine.a_words).astype(np.int64)
    hf = np.asarray(jv.hf_words).astype(np.int64)[0]
    by_key = {tuple(hf ^ a[m]): me[m] for m in range(len(me))}
    want = {tuple(r) for r in np.asarray(jv.ref_neighbor_words).astype(
        np.int64)}
    got = {tuple(r) for r in got_words}
    assert len(got) == len(want) == min(k, len(me))
    if got == want:
        return
    kth = np.sort(me)[::-1][len(want) - 1]
    tie = lambda r: abs(by_key[r] - kth) <= 1e-6 * kth  # noqa: E731
    assert all(by_key[r] >= kth * (1 - 1e-6) for r in got)
    assert {r for r in got if not tie(r)} == {r for r in want if not tie(r)}


@pytest.mark.parametrize("name,k", [("H2O", 40), ("C2H4", 2048)])
def test_ref_neighbor_words_match_jax(name, k):
    anqs_kw = dict(hidden_widths=(8,), aux_hidden_widths=(8,))
    jmol, mol = molecules(name)
    cfg = dict(sample_num=16, qubit_per_qudit=4, couple_ref_dets=k)
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(**cfg), JaxAnqsConfig(**anqs_kw))
    v = VMC(mol, VMCConfig(**cfg), AnqsConfig(**anqs_kw), device="cpu")
    _ref_set_matches(v.ref_neighbor_words.numpy(), jv, k)


@pytest.mark.parametrize("qubit_num", [14, 52])
def test_interleave_swap_matches_jax(qubit_num):
    rng = np.random.default_rng(qubit_num)
    bits = rng.integers(0, 2, (256, qubit_num))
    words = bitops.pack(torch.from_numpy(bits))
    got = bitops.interleave_swap(words, qubit_num).numpy()
    want = jbits.interleave_swap(jnp.asarray(words.numpy(), jnp.uint32),
                                 qubit_num)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(
        bitops.unpack(torch.from_numpy(got), qubit_num).numpy(),
        bits.reshape(256, -1, 2)[:, :, ::-1].reshape(256, -1))


def _support_file(tmp_path):
    """40 H2O sector determinants with random coefficients (npz)."""
    _, mol = molecules("H2O")
    rng = np.random.default_rng(8)
    dets = rng.choice(sector_determinants(mol.qubit_num, mol.n_alpha,
                                          mol.n_beta), 40, replace=False)
    path = str(tmp_path / "support.npz")
    np.savez(path, dets=dets.astype(np.uint64), coef=rng.standard_normal(40))
    return path


COUPLINGS = {
    "ref_dets": (dict(couple_ref_dets=48), None),
    "support_file": (dict(couple_support_k=24), "hash"),
    "spin_flip": (dict(couple_spin_flip=True), "prefilter"),
}


@pytest.mark.parametrize("coupling", list(COUPLINGS))
def test_coupled_step_matches_jax(coupling, tmp_path):
    extra, membership = COUPLINGS[coupling]
    cfg = dict(sample_num=128, sampling_mode="gumbel", qubit_per_qudit=6,
               opt_type="sgd", lr=1.0, grad_clip_norm=1.0, seed=3, **extra)
    if coupling == "support_file":
        cfg["couple_support_file"] = _support_file(tmp_path)
    jv, v, jstate, state = build(
        "H2O", cfg, dict(hidden_widths=(32,), aux_hidden_widths=(32,)),
        membership)
    assert (v.sector_words is None) == (membership is not None)
    metrics, jm, grads, want = one_step(jv, v, jstate, state, 128)
    assert int(metrics["unique_num"]) == int(jm["unique_num"])
    assert int(metrics["unique_num"]) > 128  # coupled rows beyond the sample
    assert int(metrics["found_pairs"]) == int(jm["found_pairs"])
    assert int(metrics["pf_dropped_rows"]) == int(jm["pf_dropped_rows"]) == 0
    assert abs(float(metrics["energy"]) - float(jm["energy"])) < 1e-6
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(w)),
                                   err_msg=name)


def test_c2h4_transformer_step_matches_jax():
    """The slice: one step of the C2H4 transformer trainer (module
    docstring) in both packages."""
    cfg = dict(sample_num=64, sampling_mode="gumbel", qubit_per_qudit=4,
               lr=3e-5, grad_clip_norm=0.25, couple_ref_dets=64, seed=0)
    jv, v, jstate, state = build("C2H4", cfg, TINY_TRANSFORMER)
    assert v.engine.membership == jv.engine.membership == "prefilter"
    assert v.engine.weights_matmul == jv.engine.weights_matmul == "grouped"
    assert v.anqs.n_words == 2
    metrics, jm, _, _ = one_step(jv, v, jstate, state, 64)
    for name in ("unique_num", "found_pairs", "pf_dropped_rows",
                 "table_overflow"):
        assert int(metrics[name]) == int(jm[name]), name
    assert 64 < int(metrics["unique_num"]) <= 128
    assert int(metrics["found_pairs"]) > int(metrics["unique_num"])
    e, je = float(metrics["energy"]), float(jm["energy"])
    assert abs(e - je) <= 1e-5 + 4e-7 * abs(je), (e, je)
    assert np.isfinite(e)
