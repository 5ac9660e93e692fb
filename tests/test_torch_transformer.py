"""Transformer ansatz of the PyTorch port against the JAX package from the
same weights (``convert.params_from_jax``), at d_model 16, 2 layers, 2
heads, d_ff 32: the raw net outputs (``transformer_apply``), the capped
conditionals and log|psi| / phase agree to atol/rtol 1e-5, with and without
``logit_cap``, on LiH and H2O (one word a determinant) and on C2H4/6-31G's
52 qubits at qubit_per_qudit 4 (13 qudits, two words). The Gumbel sampler
on the transformer, fed the JAX sampler's uniforms, returns the same set of
valid rows (log-probs to atol 1e-5). The decode step with its key/value
cache gives ``forward``'s column of each position through gathers of the
frontier, the cached draw gives the full recompute's rows, and the draws
that cannot cache (spin-flip averaging, MADE) recompute."""

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


def _pair(name, qpq, cap=None, seed=1, **kw):
    return build_pair(name, qpq, seed=seed, logit_cap=cap, **TINY, **kw)


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


def _assert_close_to_scale(got, want, tol):
    """``got`` equals ``want`` where ``want`` is masked (NEG) and to ``tol``
    of the larger of 1 and the largest unmasked |want| elsewhere: a sum
    in another float32 order errs by ulps of its largest terms."""
    kept = want > 0.5 * NEG
    assert torch.equal(got[~kept], want[~kept])
    scale = max(1.0, float(want[kept].abs().max()))
    np.testing.assert_allclose(got[kept].numpy(), want[kept].numpy(),
                               rtol=tol, atol=tol * scale)


def _set_qudit(bits, rng, start, end):
    """``bits`` with the qudit [start, end) of every row drawn at random."""
    bits = bits.copy()
    bits[:, start:end] = rng.integers(0, 2, (len(bits), end - start))
    return bits


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [None, 4.0])
@pytest.mark.parametrize("name", ["LiH", "C2H4"])
def test_decode_matches_forward(rng, name, cap, cdt):
    """``Transformer.decode`` position by position, with a parent gather
    between positions that repeats, drops and reorders rows and pads the
    frontier with dead rows: each live row's output is ``forward``'s
    column q of its prefix, and the cached conditional is
    ``cond_for_qudit_dyn``'s, to 1e-6 of the step's scale
    (``_assert_close_to_scale``). With bfloat16 storage, a float32 sum in
    another order can flip the rounding of a stored activation by one
    bfloat16 unit, 2^-8 of it, and the tolerance is that unit."""
    mol, _, _, anqs = _pair(name, 4, cap, compute_dtype=cdt)
    tol = 1e-6 if cdt == "float32" else 2.0 ** -8
    n, q_num = mol.qubit_num, anqs.qudit_num
    starts, ends = anqs.qudit_starts, anqs.grouping.qudit_ends
    cap_rows = 96
    cache = anqs.decode_cache(cap_rows)
    bits = np.zeros((1, n), dtype=np.int64)
    alive = np.ones(1, dtype=bool)
    for q in range(q_num):
        words = bitops.pack(torch.from_numpy(bits))
        _, masks = anqs.memo_path(words)
        live = torch.from_numpy(alive)
        with torch.no_grad():
            prev = (anqs.qudit_values(words)[:, q - 1] if q
                    else words.new_zeros(len(words)))
            out = anqs.main.decode(cache, prev, q)
            want = anqs.main(torch.from_numpy(bits).float())[:, q]
            cond = anqs.cond_for_qudit_cached(cache, words, q, masks[:, q],
                                              live)
            cond_want = anqs.cond_for_qudit_dyn(words, q, masks[:, q], live)
        assert torch.isfinite(out).all()
        _assert_close_to_scale(out[live], want[live], tol)
        _assert_close_to_scale(cond, cond_want, tol)
        if q + 1 == q_num:
            break
        # Survivors: a new frontier of another size whose rows repeat,
        # drop and reorder the old ones, each with a new value at q.
        rows = int(rng.integers(len(bits) // 2 + 1, cap_rows - 8))
        parent = rng.integers(0, len(bits), rows)
        cache.advance(torch.from_numpy(parent), q)
        bits = _set_qudit(bits[parent], rng, starts[q], ends[q])
        alive = alive[parent]
        if q == 1:  # dead padding rows, as the draw pads to its capacity
            bits = np.concatenate([bits, np.zeros((8, n), np.int64)])
            alive = np.concatenate([alive, np.zeros(8, bool)])
    assert alive.sum() > 0


@pytest.mark.parametrize("k", [64, 300])
@pytest.mark.parametrize("name", ["LiH", "C2H4"])
def test_cached_draw_matches_the_full_recompute(name, k, monkeypatch):
    """From the same uniforms, the Gumbel draw with the key/value cache
    returns the full recompute's rows in its order, log-probs to 1e-6
    (float32 summation order)."""
    _, _, _, anqs = _pair(name, 4, cap=4.0)
    gen = torch.Generator().manual_seed(7)
    uniforms = [torch.clamp(torch.rand(s, generator=gen), min=1e-38)
                for s in uniform_shapes(anqs, k)]
    cached = gumbel_top_k_sample(anqs, k, uniforms=uniforms)
    monkeypatch.setattr(anqs, "decode_cache", lambda rows: None)
    full = gumbel_top_k_sample(anqs, k, uniforms=uniforms)
    assert torch.equal(cached.valid, full.valid)
    assert int(cached.valid.sum()) > 0
    assert torch.equal(cached.words, full.words)
    v = full.valid
    np.testing.assert_allclose(cached.log_probs[v].numpy(),
                               full.log_probs[v].numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("net", ["spin_flip", "made"])
def test_draws_without_the_decode_step_recompute(net):
    """A flip-averaged transformer and a MADE ANQS offer no cache: their
    draws take ``cond_for_qudit_dyn`` (the transformer counting Q
    positions a row, twice with the flip)."""
    from anqs_quantum_chemistry_torch.utils import spans

    kw = (dict(TINY, spin_flip_abs=True) if net == "spin_flip"
          else dict(hidden_widths=(16,), aux_hidden_widths=(16,)))
    _, _, _, anqs = build_pair("LiH", 4, **kw)
    assert anqs.decode_cache(64) is None
    rows = [r for r, _ in uniform_shapes(anqs, 64)]
    with spans.recording() as rec, spans.span("draw"):
        out = gumbel_top_k_sample(anqs, 64, torch.Generator().manual_seed(1))
    assert int(out.valid.sum()) > 0
    assert not any(s.name == "tx.decode" for s in rec.spans)
    want = ({"tx_sample_positions": sum(rows) * 2 * anqs.qudit_num}
            if net == "spin_flip" else {})
    assert rec.spans[0].counts == want
