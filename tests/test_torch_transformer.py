"""Transformer ansatz of the PyTorch port against the JAX package from the
same weights (``convert.params_from_jax``), at d_model 16, 2 layers, 2
heads, d_ff 32: the raw net outputs (``transformer_apply``), the capped
conditionals and log|psi| / phase agree to atol/rtol 1e-5, with and without
``logit_cap``, on LiH and H2O (one word a determinant) and on C2H4/6-31G's
52 qubits at qubit_per_qudit 4 (13 qudits, two words). The Gumbel sampler
on the transformer, fed the JAX sampler's uniforms, returns the same set of
valid rows (log-probs to atol 1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.models.transformer import transformer_apply
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_torch.chem.fci import (
    random_sector_dets,
    sector_determinants,
)
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.models.anqs import NEG, ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.ops import bits as bitops
from anqs_quantum_chemistry_torch.sampling.sampler import (
    gumbel_top_k_sample,
    uniform_shapes,
)
from torch_port_common import build_pair, jax_uniforms, to_np

TINY = dict(net_type="transformer", d_model=16, n_layers=2, n_heads=2,
            d_ff=32)
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [("LiH", 4), ("H2O", 4), ("C2H4", 4)]


def _pair(name, qpq, cap=None, seed=1):
    return build_pair(name, qpq, seed=seed, logit_cap=cap, **TINY)


def _words(rng, mol, rows):
    """``rows`` sector determinants of ``mol`` (random ones above 20
    qubits) and 16 random bit strings, as (B, W) int64 words."""
    n = mol.qubit_num
    if n <= 20:
        dets = sector_determinants(n, mol.n_alpha, mol.n_beta)
        dets = rng.choice(dets, min(rows, len(dets)), replace=False)
    else:
        dets = random_sector_dets(n // 2, mol.n_alpha, mol.n_beta, rows, rng)
    bits = (dets[:, None] >> np.arange(n, dtype=np.uint64)) & np.uint64(1)
    bits = np.concatenate([bits.astype(np.int64),
                           rng.integers(0, 2, (16, n))])
    return bitops.pack(torch.from_numpy(bits)).numpy()


@pytest.mark.parametrize("cap", [None, 4.0])
@pytest.mark.parametrize("name,qpq", CASES)
def test_transformer_matches_jax(rng, name, qpq, cap):
    mol, jax_anqs, params, anqs = _pair(name, qpq, cap)
    words = _words(rng, mol, 128)
    jwords = jnp.asarray(words, jnp.uint32)
    tw = torch.from_numpy(words)
    x = bitops.unpack(tw, mol.qubit_num, dtype=torch.float32)
    with torch.no_grad():
        raw = anqs.main(x)
        la_raw = anqs.main_log_abs_raw(tw)
        la, ph = anqs.log_psi(tw)
    np.testing.assert_allclose(
        raw.numpy(),
        np.asarray(transformer_apply(jax_anqs.main_spec, params["main"],
                                     jnp.asarray(x.numpy()))),
        **TOL)
    np.testing.assert_allclose(
        la_raw.numpy(),
        np.asarray(jax_anqs.main_log_abs_raw(params, jwords)), **TOL)
    if cap:
        assert float(la_raw.abs().max()) <= cap
    la_j, ph_j = jax_anqs.log_psi(params, jwords)
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), **TOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), **TOL)
    assert np.all(la[:128].numpy() > 0.5 * NEG)  # sector members


def test_parameter_tree_matches_jax():
    """The port's parameter names and shapes are the flattened JAX tree,
    and a fresh port net has JAX's initial scales."""
    _, jax_anqs, params, anqs = _pair("H2O", 4)
    want = {k: tuple(v.shape)
            for k, v in params_from_jax(to_np(params)).items()}
    fresh = ANQS(anqs.grouping, AnqsConfig(d_model=64, n_layers=2,
                                           n_heads=4, d_ff=256,
                                           net_type="transformer"),
                 torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in anqs.state_dict().items()} == want
    sd = fresh.state_dict()
    assert float(sd["main.pos"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(sd["main.layer0.wq"].std()) == pytest.approx(
        (2 / 128) ** 0.5, rel=0.1)
    assert float(sd["main.layer1.ff1"].std()) == pytest.approx(
        (2 / 320) ** 0.5, rel=0.1)
    assert torch.equal(sd["aux.layer0.ln2_scale"], torch.ones(64))


def test_causal_and_normalized(rng):
    """Output position q depends only on qudits < q, and |psi|^2 sums to 1
    over LiH's sector (masked, normalised conditionals)."""
    mol, _, _, anqs = _pair("LiH", 4, cap=4.0)
    bits = torch.from_numpy(rng.integers(0, 2, (32, mol.qubit_num)))
    x = bits.to(torch.float32)
    with torch.no_grad():
        out = anqs.main(x)
        for q, (s, e) in enumerate(zip(anqs.qudit_starts,
                                       anqs.grouping.qudit_ends)):
            flipped = x.clone()
            flipped[:, s:e] = 1 - flipped[:, s:e]
            moved = anqs.main(flipped)
            assert torch.equal(moved[:, :q + 1], out[:, :q + 1])
            if q + 1 < anqs.qudit_num:
                assert not torch.equal(moved[:, q + 1:], out[:, q + 1:])
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    with torch.no_grad():
        la, _ = anqs.log_psi(torch.from_numpy(dets.astype(np.int64)[:, None]))
    assert abs(float(torch.exp(2 * la.double()).sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("name,qpq,k", [("LiH", 4, 64), ("C2H4", 4, 64)])
def test_gumbel_sample_matches_jax(name, qpq, k):
    mol, jax_anqs, params, anqs = _pair(name, qpq, cap=4.0)
    key = jax.random.PRNGKey(5)
    js = jax.jit(functools.partial(jax_gumbel_top_k_sample, jax_anqs,
                                   sample_num=k))(params, key)
    out = gumbel_top_k_sample(
        anqs, k, uniforms=jax_uniforms(key, uniform_shapes(anqs, k)))
    jvalid = np.asarray(js.valid)
    jw = np.asarray(js.words)[jvalid].astype(np.int64)
    jl = np.asarray(js.log_probs)[jvalid]
    w = out.words[out.valid].numpy()
    lp = out.log_probs[out.valid].numpy()
    assert out.words.shape == (k, anqs.n_words)
    assert len(w) == len({tuple(r) for r in w})  # unique determinants
    order_j = np.lexsort(jw.T)
    order = np.lexsort(w.T)
    np.testing.assert_array_equal(w[order], jw[order_j])
    np.testing.assert_allclose(lp[order], jl[order_j], rtol=0, atol=1e-5)
    if anqs.n_words == 2:
        assert np.any(w[:, 1] > 0)  # the second word is used
