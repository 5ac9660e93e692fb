"""Prefilter membership of the PyTorch port against the JAX package's
(``PauliEngine(membership='prefilter')``) on one sample batch, as JAX's
``tests/test_local_energy.py`` holds it: H2O/STO-3G (14 qubits, one word a
determinant) and a 40-qubit embedding of a random 12-orbital problem (two
words), at the default capacities, at a row capacity of 2 (dense
fallback), with a row block that does not divide the batch, and at
capacities (1, 1), where rows are dropped.

``found_pairs``, ``pf_dropped_rows`` and ``table_overflow`` must be equal;
``e_re``/``e_im`` agree to 1e-6 of the batch's largest |e| (float32 sums of
the same terms, exp/cos/sin of two libraries) and ``t_re``/``t_im`` to atol
1e-6 + 4e-7 relative. The fingerprint table is bit-equal to JAX's
``_hash_build(..., with_fp=True)``, and stage 1 alone (the plain version
of kernel #3, ``fp_filter_plain``) equals the JAX engine's fingerprint
probe bit for bit at W 1-4 and every table layout the prefilter admits.
Under ``weights_matmul='grouped'`` the
port's ``a_words`` equal the JAX engine's (its class-major group order) and
its matrix elements agree to 1e-6 relative, on H2O and on C2H4/6-31G."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem.jw import (
    PauliHamiltonian as JaxPauliHamiltonian,
)
from anqs_quantum_chemistry_tpu.chem.jw import (
    jordan_wigner_pauli_hamiltonian,
)
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
from anqs_quantum_chemistry_torch.chem.molecule import load_c2h4
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops import bits as bitops
from anqs_quantum_chemistry_torch.ops import keys
from anqs_quantum_chemistry_torch.ops.hash_lookup import as_int32
from anqs_quantum_chemistry_torch.ops.hash_lookup import fp_filter_plain
from torch_port_common import molecules


@functools.lru_cache(maxsize=None)
def _hams(name):
    """(JAX PauliHamiltonian, port PauliHamiltonian) of the same arrays."""
    if name == "H2O":
        jmol, mol = molecules("H2O")
        return jmol.qubit_ham, mol.qubit_ham
    rng = np.random.default_rng(23)  # 40 qubits, active orbitals 0-11
    h1 = np.zeros((40, 40))
    sub = rng.standard_normal((12, 12))
    h1[:12, :12] = sub + sub.T
    v = np.zeros((40,) * 4)
    s4 = rng.standard_normal((12,) * 4)
    v[:12, :12, :12, :12] = s4 + s4.transpose(1, 0, 3, 2)
    jham = jordan_wigner_pauli_hamiltonian(h1, v)
    return jham, PauliHamiltonian(
        qubit_num=jham.qubit_num, constant=jham.constant,
        a_masks=jham.a_masks, b_words=jham.b_words, weights=jham.weights,
        group_starts=jham.group_starts,
    )


def _batch(n, rows, active, seed=5):
    """``rows`` random determinants on the first ``active`` of ``n`` qubits,
    ~10% invalid (all-ones sentinels), canonically sorted, duplicates made
    invalid; log|psi| <= 0 and phases. numpy arrays."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((rows, n), dtype=np.int64)
    bits[:, :active] = rng.integers(0, 2, (rows, active))
    words = bitops.pack(torch.from_numpy(bits))
    valid = torch.from_numpy(rng.random(rows) < 0.9)
    words = torch.where(valid[:, None], words, bitops.MASK32)
    words, _, valid = keys.sort_words(words, valid)
    valid = valid & keys.unique_mask(words)
    la = -np.abs(rng.standard_normal(rows)).astype(np.float32)
    ph = rng.standard_normal(rows).astype(np.float32)
    return words.numpy(), la, ph, valid.numpy()


def _run(jham, ham, batch, **kw):
    words, la, ph, valid = batch
    je = JaxPauliEngine(jham, membership="prefilter", **kw).local_energy_proxy(
        jnp.asarray(words, jnp.uint32), jnp.asarray(la), jnp.asarray(ph),
        jnp.asarray(valid))
    eng = PauliEngine(ham, device="cpu", membership="prefilter", **kw)
    e = eng.local_energy_proxy(*map(torch.from_numpy, (words, la, ph, valid)))
    for field in ("found_pairs", "pf_dropped_rows", "table_overflow"):
        assert int(getattr(e, field)) == int(getattr(je, field)), field
    for field in ("e_re", "e_im"):
        want = np.asarray(getattr(je, field))
        np.testing.assert_allclose(
            getattr(e, field).numpy(), want, rtol=0,
            atol=1e-6 * np.max(np.abs(want)), err_msg=field)
    for field in ("t_re", "t_im"):
        np.testing.assert_allclose(
            getattr(e, field).numpy(), np.asarray(getattr(je, field)),
            rtol=4e-7, atol=1e-6, err_msg=field)
    return e


CAPACITIES = {
    "defaults": {},
    "dense_fallback": dict(prefilter_row_capacity=2, prefilter_dense_rows=96),
    "row_blocks": dict(prefilter_row_capacity=2, prefilter_dense_rows=96,
                       pf_row_chunk=40),
    "dropped": dict(prefilter_row_capacity=1, prefilter_dense_rows=1),
}


@pytest.mark.parametrize("case", list(CAPACITIES))
@pytest.mark.parametrize("name,rows,active", [("H2O", 96, 14),
                                              ("emb40", 64, 12)])
def test_prefilter_matches_jax(name, rows, active, case):
    jham, ham = _hams(name)
    batch = _batch(ham.qubit_num, rows, active)
    e = _run(jham, ham, batch, **CAPACITIES[case])
    assert int(e.found_pairs) > int(batch[3].sum())  # off-diagonal pairs
    if case == "dropped":
        assert int(e.pf_dropped_rows) > 0
    elif case != "defaults":
        assert int(e.pf_dropped_rows) == 0


@pytest.mark.parametrize("name,rows,active", [("H2O", 96, 14),
                                              ("emb40", 64, 12)])
def test_fingerprint_table_matches_jax(name, rows, active):
    jham, ham = _hams(name)
    words, la, ph, valid = _batch(ham.qubit_num, rows, active)
    _, jnb, _, jfp = JaxPauliEngine(jham, membership="prefilter")._hash_build(
        jnp.asarray(words, jnp.uint32), jnp.asarray(la), jnp.asarray(ph),
        jnp.asarray(valid), with_fp=True)
    _, nb, _, fp = PauliEngine(ham, device="cpu")._hash_build(
        *map(torch.from_numpy, (words, la, ph, valid)), with_fp=True)
    assert nb == jnb
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp).view(np.int32))
    assert int((fp != 0).sum()) == int(valid.sum())


@pytest.mark.parametrize("name", ["H2O", "C2H4"])
def test_grouped_order_matches_jax(name):
    if name == "C2H4":  # the JAX rule picks 'grouped' by itself here
        ham = load_c2h4().qubit_ham
        jham = JaxPauliHamiltonian(
            qubit_num=ham.qubit_num, constant=ham.constant,
            a_masks=ham.a_masks, b_words=ham.b_words, weights=ham.weights,
            group_starts=ham.group_starts)
        kw, rows = {}, 8
    else:
        jham, ham = _hams(name)
        kw, rows = dict(weights_matmul="grouped"), 32
    jeng = JaxPauliEngine(jham, membership="prefilter", **kw)
    eng = PauliEngine(ham, device="cpu", **kw)
    assert jeng.weights_matmul == eng.weights_matmul == "grouped"
    np.testing.assert_array_equal(eng.a_words.numpy(),
                                  np.asarray(jeng.a_words).astype(np.int64))
    assert not np.array_equal(np.asarray(ham.a_masks),
                              np.asarray(jeng.a_words))  # order changed
    words = _batch(ham.qubit_num, rows, ham.qubit_num)[0]
    me = eng.matrix_elements(torch.from_numpy(words)).numpy()
    want = np.asarray(jeng.matrix_elements(jnp.asarray(words, jnp.uint32)))
    np.testing.assert_allclose(me, want, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(want)))


def _masked_ham(words, valid, n, m, rng):
    """A JAX Hamiltonian on ``n`` qubits of ``m`` one-term groups whose
    masks couple the batch to itself: 0 (each row's own key), XORs of two
    valid rows, and random masks on the register."""
    w = words.shape[1]
    rows = np.flatnonzero(valid)
    pairs = rng.choice(rows, (m // 2, 2))
    top = np.full(w, 0xFFFFFFFF, np.int64)
    if n % 32:
        top[-1] = (1 << (n % 32)) - 1
    a = np.concatenate([
        np.zeros((1, w), np.int64), words[pairs[:, 0]] ^ words[pairs[:, 1]],
        rng.integers(0, 1 << 32, (m - 1 - m // 2, w), dtype=np.int64) & top])
    return JaxPauliHamiltonian(
        qubit_num=n, constant=0.0, a_masks=a.astype(np.uint32),
        b_words=np.zeros((m, w), np.uint32), weights=np.ones(m),
        group_starts=np.arange(m + 1))


@pytest.mark.parametrize("w,epb", [(1, 8), (1, 16), (1, 32), (2, 8),
                                   (2, 16), (2, 32), (3, None), (4, None)])
def test_fp_filter_plain_matches_jax_stage1(w, epb):
    """Stage 1 of the prefilter alone: ``fp_filter_plain`` on the JAX
    engine's fingerprint table, rows and masks equals the JAX engine's
    probe (gather the partner's bucket row, compare its E lanes) bit for
    bit, on a random batch with all-ones sentinel rows, at W 1-4 and
    E 8, 16 and 32 where the layout admits them."""
    n = 32 * w - 5
    words, la, ph, valid = _batch(n, 96, n, seed=10 + w)
    assert not valid.all() and (words == 0xFFFFFFFF).all(axis=1).any()
    rng = np.random.default_rng(w)
    jeng = JaxPauliEngine(_masked_ham(words, valid, n, 80, rng),
                          membership="prefilter", hash_epb=epb)
    jw = jnp.asarray(words, jnp.uint32)
    _, nb, _, jfp = jeng._hash_build(jw, jnp.asarray(la), jnp.asarray(ph),
                                     jnp.asarray(valid), with_fp=True)
    cols = tuple((jw[:, i][:, None] ^ jeng.a_words[:, i][None, :]).reshape(-1)
                 for i in range(w))
    bucket = (jeng._bucket_hash(cols) & jnp.uint32(nb - 1)).astype(jnp.int32)
    want = np.asarray(jnp.any(jfp[bucket] == jeng._fp_hash(cols)[:, None],
                              axis=1)).reshape(96, 80)
    a_cols = as_int32(torch.from_numpy(
        np.asarray(jeng.a_words).astype(np.int64))).T.contiguous()
    got = fp_filter_plain(torch.from_numpy(np.array(jfp).view(np.int32)),
                          torch.from_numpy(words), a_cols)
    assert jfp.shape == (nb, epb or 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] == valid).all()  # mask 0: each valid row finds itself
    assert int(want[:, 1:].sum()) >= 80 // 2  # the row-pair masks

