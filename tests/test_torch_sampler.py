"""Gumbel top-k sampler of the PyTorch port against the JAX package.

torch cannot reproduce JAX's threefry stream, so the port's sampler is fed
the JAX sampler's own uniforms (``jax.random.split(key, Q)``, one draw per
qudit step). The sets of valid words must be equal and their log-probs agree
to atol 1e-5; row order is not compared (top-k ties among NEG rows)."""

import functools

import jax
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_torch.sampling.sampler import (
    SamplingConfig,
    gumbel_top_k_sample,
    sample,
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
    with pytest.raises(NotImplementedError):
        sample(anqs, SamplingConfig(sample_num=64, mode="multinomial"))
