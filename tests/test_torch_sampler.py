"""The samplers of the PyTorch port against the JAX package.

torch cannot reproduce JAX's threefry stream, so the port's Gumbel sampler
is fed the JAX sampler's own uniforms (``jax.random.split(key, Q)``, one
draw per qudit step). The sets of valid words must be equal and their
log-probs agree to atol 1e-5; row order is not compared (top-k ties among
NEG rows). The multinomial sampler is held against JAX's with both
packages' binomial draw replaced by the deterministic split
floor(n p + 1/2), and with its own draws against the multinomial law."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.sampling import sampler as jax_sampler
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.sampling.sampler import (
    SamplingConfig,
    _binomial_bisect,
    gumbel_top_k_sample,
    multinomial_sample,
    sample,
    sample_precisely,
    uniform_shapes,
)
from torch_port_common import build_pair, jax_uniforms


@pytest.mark.parametrize("name,qpq,width,k", [
    ("LiH", 6, 32, 64),  # top-k truncation of the 225-det sector
    ("LiH", 3, 32, 256),  # whole sector, padded to k
    ("N2", 10, 512, 14464),  # the main path: 14400 dets padded to 14464
])
def test_gumbel_sample_matches_jax(name, qpq, width, k):
    mol, jax_anqs, params, anqs = build_pair(name, qpq, width)
    key = jax.random.PRNGKey(11)
    run = jax.jit(functools.partial(jax_gumbel_top_k_sample, jax_anqs,
                                    sample_num=k))
    js = run(params, key)
    out = gumbel_top_k_sample(
        anqs, k, uniforms=jax_uniforms(key, uniform_shapes(anqs, k))
    )
    jvalid = np.asarray(js.valid)
    jw = np.asarray(js.words)[jvalid][:, 0].astype(np.int64)
    jl = np.asarray(js.log_probs)[jvalid]
    w = out.words[out.valid][:, 0].numpy()
    lp = out.log_probs[out.valid].numpy()
    assert out.words.shape == (k, 1)
    assert len(w) == len(set(w))  # unique determinants
    np.testing.assert_array_equal(np.sort(w), np.sort(jw))
    np.testing.assert_allclose(lp[np.argsort(w)], jl[np.argsort(jw)],
                               rtol=0, atol=1e-5)
    if k >= mol.fci_ndet:
        assert len(w) == mol.fci_ndet


def test_sample_weights_and_generator():
    """``sample`` returns Born weights renormalized over the set; with its
    own generator the draw is reproducible from the seed."""
    _, _, _, anqs = build_pair("LiH", 6, 32)
    cfg = SamplingConfig(sample_num=64)
    a = sample(anqs, cfg, torch.Generator().manual_seed(5))
    b = sample(anqs, cfg, torch.Generator().manual_seed(5))
    words, weights, valid, stats = a
    assert torch.equal(words, b[0])
    assert int(stats["unique_num"]) == int(valid.sum()) == 64
    assert abs(float(weights.sum()) - 1.0) < 1e-5
    with pytest.raises(ValueError):  # a mode of neither package
        sample(anqs, SamplingConfig(sample_num=64, mode="exact"))


def split_half_up(n, p):
    return torch.floor(n * p + 0.5)


@pytest.mark.parametrize("width,k", [(32, 64), (8, 256)])
@pytest.mark.parametrize("budget", [1000, 10**6])
def test_multinomial_matches_jax_deterministic_split(monkeypatch, width, k,
                                                     budget):
    """LiH (qubit_per_qudit 6): with the binomial draw of both packages
    replaced by floor(n p + 1/2) (``jax.random.binomial`` patched in this
    test only), the valid words and their counts, and the dropped count,
    are equal exactly -- at k 64 (truncation drops counts) and k 256 (the
    whole 225-determinant sector)."""
    def jax_split(key, n, p, shape=None, dtype=jnp.float64):
        return jnp.floor(n * p + 0.5).astype(dtype)

    monkeypatch.setattr(jax.random, "binomial", jax_split)
    _, jax_anqs, params, anqs = build_pair("LiH", 6, width)
    run = jax.jit(functools.partial(jax_sampler.multinomial_sample,
                                    jax_anqs, sample_num=k, budget=budget))
    js = run(params, jax.random.PRNGKey(0))
    out = multinomial_sample(anqs, k, budget, draw=split_half_up)
    jvalid = np.asarray(js.valid)
    want = dict(zip(np.asarray(js.words)[jvalid][:, 0].astype(np.int64),
                    np.asarray(js.counts)[jvalid]))
    got = dict(zip(out.words[out.valid][:, 0].tolist(),
                   out.counts[out.valid].tolist()))
    assert got == want
    assert int(out.dropped) == int(js.dropped)
    assert int(out.counts.sum()) == budget - int(out.dropped)
    if k >= 225:
        assert len(got) == 225 and int(out.dropped) == 0


def test_multinomial_own_draws_keep_counts():
    """With the generator's draws: every budget's counts sum to the budget
    less ``dropped``, weights are counts / total, and ``sample_precisely``
    grows the budget until the unique count reaches its target."""
    _, _, _, anqs = build_pair("LiH", 6, 32)
    gen = torch.Generator().manual_seed(0)
    for budget in (10, 1000, 10**6):
        out = multinomial_sample(anqs, 64, budget, generator=gen)
        assert int(out.counts.sum()) + int(out.dropped) == budget
        assert int(out.valid.sum()) <= 64
    words, weights, valid, stats = sample(
        anqs, SamplingConfig(sample_num=64, mode="multinomial"), gen,
        budget=500)
    assert abs(float(weights.sum()) - 1.0) < 1e-6
    assert int(stats["unique_num"]) == int(valid.sum())
    out, budget = sample_precisely(anqs, 256, target_unique=200,
                                   generator=gen)
    assert int(out.valid.sum()) >= 200 or budget == 1 << 27
    assert budget > 256
    with pytest.raises(ValueError, match="2\\^30"):
        multinomial_sample(anqs, 64, (1 << 30) + 1)


def test_binomial_bisect_p_one_keeps_counts():
    """A split with p == 1 (all mass in one half) keeps every count, and
    p == 0 gives the half none, whatever the draw: the deterministic
    splits bypass it (the draw here would lose everything)."""
    probs = torch.zeros((3, 8))
    probs[0, 0] = 1.0  # p == 1 at every level
    probs[1, 7] = 0.5  # p == 0 at every level
    probs[2] = 1.0
    counts = torch.tensor([1 << 29, 12345, 0])
    out = _binomial_bisect(counts, probs, 3,
                           draw=lambda n, p: torch.zeros_like(n))
    assert out[0].tolist() == [1 << 29] + [0] * 7
    assert out[1].tolist() == [0] * 7 + [12345]
    assert out[2].tolist() == [0] * 8


def test_multinomial_frequencies_follow_born_law():
    """Budget 1e7 on LiH's whole 225-determinant sector: every empirical
    frequency lies within 5 sigma (binomial, plus 1/budget) of |psi|^2."""
    mol, _, _, anqs = build_pair("LiH", 6, 32)
    budget = 10**7
    out = multinomial_sample(anqs, 256, budget,
                             generator=torch.Generator().manual_seed(1))
    assert int(out.dropped) == 0
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    words = torch.from_numpy(dets.astype(np.int64))[:, None]
    with torch.no_grad():
        la, _ = anqs.log_psi(words)
    p = np.exp(2.0 * la.double().numpy())
    counts = dict(zip(out.words[:, 0].tolist(), out.counts.tolist()))
    freq = np.array([counts.get(int(d), 0) for d in dets]) / budget
    sigma = np.sqrt(p * (1.0 - p) / budget)
    assert abs(p.sum() - 1.0) < 1e-5
    assert np.all(np.abs(freq - p) <= 5.0 * sigma + 1.0 / budget)
