"""Spin-flip (alpha <-> beta) symmetrization of the PyTorch port against
the JAX package (reference SpinFlipSymmetryConfig, abstract_anqs.py:53-67;
JAX ``tests/test_spin_flip.py``), from the same weights:

- ``spin_flip_abs`` / ``spin_flip_phase`` log_psi against JAX's on every
  physical state of an 8-qubit, 4-electron sector (qubit_per_qudit 2) and
  on LiH (qubit_per_qudit 4): 1e-5;
- |psi(flip x)| == |psi(x)| and psi(flip x) == (-1)^(n_open/2) psi(x) on
  the port alone: 2e-5 (the JAX test's tolerance);
- the Gumbel sampler through the flip-averaged conditionals: its sets from
  JAX's uniforms, and its log-probs against 2 log|psi| over a whole sector;
- one ``couple_spin_flip`` step on LiH (64 samples of its 225-determinant
  sector, the set closed under the flip) against JAX's: gradients rtol
  1e-4, energies 1e-6 Ha, the same pair count.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_tpu.symmetries import Masker as JaxMasker
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_tpu.symmetries import (
    particle_number_symmetry as jax_particle_number_symmetry,
)
from anqs_quantum_chemistry_tpu.symmetries import (
    spin_projection_symmetry as jax_spin_projection_symmetry,
)
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.ops import bits
from anqs_quantum_chemistry_torch.sampling.sampler import (
    gumbel_top_k_sample,
    uniform_shapes,
)
from anqs_quantum_chemistry_torch.symmetries import (
    Masker,
    QubitGrouping,
    particle_number_symmetry,
    spin_projection_symmetry,
)
from torch_port_common import build_pair, jax_uniforms, molecules, to_np
from torch_step_common import assert_step_matches, step_pair

FLAGS = [dict(spin_flip_abs=True), dict(spin_flip_phase=True),
         dict(spin_flip_abs=True, spin_flip_phase=True)]


def eight_qubit_pair(**kw):
    """(physical 8-qubit states (B, 8), JAX ANQS, params, port ANQS) for
    N = 4, Sz = 0 at qubit_per_qudit 2: the JAX test's ``build``."""
    n = 8
    x = np.array(list(itertools.product([0, 1], repeat=n)),
                 dtype=np.int64)[:, ::-1]
    masker = Masker([particle_number_symmetry(n, 4),
                     spin_projection_symmetry(n, 0)])
    x = np.ascontiguousarray(x[masker.is_physical(x)])
    jmasker = JaxMasker([jax_particle_number_symmetry(n, 4),
                         jax_spin_projection_symmetry(n, 0)])
    cfg = dict(hidden_widths=(16,), aux_hidden_widths=(16,), **kw)
    jax_anqs = JaxANQS(JaxGrouping.create(jmasker, 2), JaxAnqsConfig(**cfg))
    params = jax_anqs.init(jax.random.PRNGKey(3))
    anqs = ANQS(QubitGrouping.create(masker, 2), AnqsConfig(**cfg))
    anqs.load_state_dict(params_from_jax(to_np(params)))
    return x, jax_anqs, params, anqs


def flip_bits(x):
    out = x.copy()
    out[:, 0::2] = x[:, 1::2]
    out[:, 1::2] = x[:, 0::2]
    return out


def _compare(jax_anqs, params, anqs, words):
    la_j, ph_j = jax_anqs.log_psi(params, jnp.asarray(words, jnp.uint32))
    with torch.no_grad():
        la, ph = anqs.log_psi(torch.from_numpy(words))
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), rtol=0,
                               atol=1e-5)
    return la.numpy().astype(np.float64), ph.numpy().astype(np.float64)


@pytest.mark.parametrize("kw", FLAGS)
def test_log_psi_matches_jax_and_relations_hold(kw):
    x, jax_anqs, params, anqs = eight_qubit_pair(**kw)
    words = bits.pack(torch.from_numpy(x)).numpy()
    words_f = bits.pack(torch.from_numpy(flip_bits(x))).numpy()
    la, ph = _compare(jax_anqs, params, anqs, words)
    la_f, ph_f = _compare(jax_anqs, params, anqs, words_f)
    if kw.get("spin_flip_abs"):
        np.testing.assert_allclose(la_f, la, rtol=0, atol=2e-5)
        assert abs(np.exp(2 * la).sum() - 1.0) < 5e-4
    if kw.get("spin_flip_abs") and kw.get("spin_flip_phase"):
        n_open = (x != flip_bits(x)).sum(axis=1) // 2
        sign = np.where((n_open // 2) % 2 == 1, -1.0, 1.0)
        for f in (np.cos, np.sin):
            np.testing.assert_allclose(np.exp(la_f) * f(ph_f),
                                       sign * np.exp(la) * f(ph), atol=2e-5)


def test_without_flags_not_invariant():
    x, _, _, anqs = eight_qubit_pair()
    with torch.no_grad():
        la = anqs.log_psi(bits.pack(torch.from_numpy(x)))[0]
        la_f = anqs.log_psi(bits.pack(torch.from_numpy(flip_bits(x))))[0]
    assert float(torch.max(torch.abs(la - la_f))) > 1e-3


@pytest.mark.parametrize("net", ["made", "nade"])
def test_lih_log_psi_and_gumbel_match_jax(rng, net):
    """Both flags on LiH (12 qubits, three 4-qubit qudits): log_psi on the
    sector and random states, and 64 Gumbel samples from JAX's uniforms
    (the conditionals the sampler reads are the flip-averaged ones)."""
    mol, jax_anqs, params, anqs = build_pair(
        "LiH", 4, net_type=net, hidden_widths=(16,),
        aux_hidden_widths=(16,), spin_flip_abs=True, spin_flip_phase=True)
    from anqs_quantum_chemistry_torch.chem.fci import sector_determinants

    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = np.concatenate([dets, rng.integers(0, 4096, 32).astype(
        np.uint64)]).astype(np.int64)[:, None]
    _compare(jax_anqs, params, anqs, words)
    key = jax.random.PRNGKey(2)
    k = 64
    js = jax_gumbel_top_k_sample(jax_anqs, params, key, k)
    out = gumbel_top_k_sample(
        anqs, k, uniforms=jax_uniforms(key, uniform_shapes(anqs, k)))
    jw = np.asarray(js.words)[np.asarray(js.valid)][:, 0].astype(np.int64)
    w = out.words[out.valid][:, 0].numpy()
    np.testing.assert_array_equal(np.sort(w), np.sort(jw))


def test_sampler_matches_log_psi():
    """Over the whole 36-state sector, the Gumbel sampler's renormalized
    log-probs equal 2 log|psi| of the flip-symmetrized ansatz (JAX
    ``test_spin_flip_sampler_matches_log_psi``, its 2e-4)."""
    _, _, _, anqs = eight_qubit_pair(spin_flip_abs=True)
    out = gumbel_top_k_sample(anqs, 36, torch.Generator().manual_seed(7))
    assert int(out.valid.sum()) == 36
    with torch.no_grad():
        la = anqs.log_psi(out.words)[0]
    np.testing.assert_allclose(out.log_probs.numpy(), 2.0 * la.numpy(),
                               atol=2e-4)


def test_couple_spin_flip_step_matches_jax():
    """One step with ``couple_spin_flip`` and both flags on LiH, 64 Gumbel
    samples (the closure adds their flips), SGD at lr 1 so that JAX's
    update is minus its gradient: the same gradients, energies, variance
    and pair count as JAX's step, from the same weights and uniforms."""
    _, _, jm, metrics, grads, want = step_pair(
        "LiH", dict(sample_num=64, sampling_mode="gumbel", qubit_per_qudit=4,
                    seed=3, couple_spin_flip=True),
        dict(hidden_widths=(16,), aux_hidden_widths=(16,),
             spin_flip_abs=True, spin_flip_phase=True))
    assert_step_matches(jm, metrics, grads, want)
    assert int(metrics["unique_num"]) > 64


def test_qubit_perm_refuses_spin_flip():
    _, mol = molecules("H2")
    perm = (1, 0, 3, 2)
    for vcfg, acfg in ((dict(couple_spin_flip=True), {}),
                       ({}, dict(spin_flip_abs=True)),
                       ({}, dict(spin_flip_phase=True))):
        with pytest.raises(ValueError, match="qubit_perm"):
            VMC(mol, VMCConfig(qubit_perm=perm, qubit_per_qudit=2, **vcfg),
                AnqsConfig(hidden_widths=(8,), **acfg), device="cpu")
