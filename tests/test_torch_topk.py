"""``ops.topk.exact_top_k`` of the PyTorch port against the JAX package's
``exact_top_k`` and ``jax.lax.top_k`` (values and indices bit for bit:
values descending, ties to the lowest index, -0.0 below 0.0), and the
samplers at ``topk_impl='bisect'`` against 'lax' (the same sets and
log-probs bit for bit from the same noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.ops.topk import exact_top_k as jax_exact_top_k
from anqs_quantum_chemistry_torch.ops.topk import exact_top_k
from anqs_quantum_chemistry_torch.sampling.sampler import (
    SamplingConfig,
    _top_k,
    gumbel_top_k_sample,
    multinomial_sample,
    sample,
)
from torch_port_common import build_pair

NEG = -1e30


def _values(case, n, seed):
    rng = np.random.default_rng(seed)
    if case == "random":
        return (100.0 * rng.standard_normal(n)).astype(np.float32)
    if case == "ties":  # 90% duplicates straddling the threshold
        return np.round(3.0 * rng.standard_normal(n)).astype(np.float32)
    if case == "neg_fill":  # the sampler's workload: mostly NEG
        x = np.full(n, NEG, np.float32)
        live = rng.choice(n, n // 100, replace=False)
        x[live] = rng.standard_normal(len(live))
        return x
    if case == "signed_zeros":
        return np.resize(np.asarray([-0.0, 0.0, -1.5, 3.25, NEG, 7.0, 7.0,
                                     -2.0], np.float32), n)
    return np.full(n, 2.5, np.float32)  # all equal


@pytest.mark.parametrize("case,n,k", [
    ("random", 1000, 1), ("random", 1000, 17), ("random", 4096, 1024),
    ("random", 100000, 8192), ("random", 257, 257),
    ("ties", 20000, 5000), ("neg_fill", 50000, 100),
    ("neg_fill", 50000, 2000), ("signed_zeros", 8, 3),
    ("signed_zeros", 40, 17), ("equal", 1024, 64),
])
def test_matches_jax(case, n, k):
    x = _values(case, n, n + k)
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x), k)
    v_jx, i_jx = jax_exact_top_k(jnp.asarray(x), k)
    v, i = exact_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_jx))
    np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                  np.asarray(v_ref).view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_int64_and_float64_match_lax(dtype):
    """Multinomial counts (int64 in the port, int32 in JAX) and float64
    values: the ordered top-k of the same numbers."""
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 7, 5000) if dtype == torch.int64
         else rng.standard_normal(5000))
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(x.astype(
        np.int32 if dtype == torch.int64 else np.float32)), 700)
    v, i = exact_top_k(torch.from_numpy(x).to(dtype), 700)
    if dtype == torch.int64:
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    sv, si = _top_k(torch.from_numpy(x).to(dtype), 700)
    assert torch.equal(i, si) and torch.equal(v, sv)
    with pytest.raises(ValueError):
        exact_top_k(torch.from_numpy(x), 5001)


@pytest.mark.parametrize("k", [16, 64])
def test_gumbel_bisect_equals_lax(k):
    _, _, _, anqs = build_pair("LiH", 4, 32)
    a = gumbel_top_k_sample(anqs, k, torch.Generator().manual_seed(1))
    b = gumbel_top_k_sample(anqs, k, torch.Generator().manual_seed(1),
                            topk_impl="bisect")
    assert torch.equal(a.valid, b.valid)
    wa, wb = a.words[a.valid][:, 0], b.words[b.valid][:, 0]
    assert torch.equal(torch.sort(wa).values, torch.sort(wb).values)
    la = a.log_probs[a.valid][torch.argsort(wa)]
    lb = b.log_probs[b.valid][torch.argsort(wb)]
    assert torch.equal(la, lb)


def test_multinomial_bisect_equals_lax():
    _, _, _, anqs = build_pair("LiH", 4, 32)
    a = multinomial_sample(anqs, 48, 4000, torch.Generator().manual_seed(2))
    b = multinomial_sample(anqs, 48, 4000, torch.Generator().manual_seed(2),
                           topk_impl="bisect")
    assert torch.equal(a.words, b.words) and torch.equal(a.counts, b.counts)
    assert int(a.dropped) == int(b.dropped)
    cfg = SamplingConfig(sample_num=48, mode="multinomial", budget=4000,
                         topk_impl="bisect")
    words, _, valid, _ = sample(anqs, cfg, torch.Generator().manual_seed(2))
    assert torch.equal(words, b.words)
    with pytest.raises(ValueError):
        SamplingConfig(topk_impl="sort")
