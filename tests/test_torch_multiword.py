"""Membership above 64 qubits and the other bucket layouts: the PyTorch port
against the JAX package.

- Local energies over 70-, 84- and 100-qubit embeddings of a random
  10-orbital problem (three and four key words), through the port's
  'hash', 'prefilter' and 'search' memberships against the JAX engine's
  word-agnostic 'search' (``tests/test_local_energy.py``'s 70-qubit test,
  the same tolerances): ``found_pairs`` equal, ``e_re`` to rtol 1e-4 /
  atol 1e-5, ``t_re`` to rtol 1e-5 / atol 1e-6, no bucket overflow.
- ``hash_epb`` 8 and 16 at two words against the JAX engine at the same
  epb.
- The bucket table at W 3 and 4 (``_hash_build``, 16 entries a bucket,
  with its fingerprints) equal to JAX's as int32 bits, and the plain lookup
  over it equal to JAX's ``_hash_query`` bit for bit.
- ``me_chunk``: matrix elements in row chunks equal the unchunked ones bit
  for bit.
- The Gumbel sampler at 84 qubits (qubit_per_qudit 6: 14 qudits over three
  words) fed the JAX sampler's uniforms: the same valid rows.

The 84- and 100-qubit Hamiltonians are the 10-qubit Jordan-Wigner form
with its qubits moved to the active positions (``_spread_ham``): the same
Hamiltonian on the states that occupy only those qubits, without the
dense n^4 integrals.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem.jw import (
    PauliHamiltonian as JaxPauliHamiltonian,
)
from anqs_quantum_chemistry_tpu.chem.jw import jordan_wigner_pauli_hamiltonian
from anqs_quantum_chemistry_tpu.experiments.preparation import (
    create_masker as jax_create_masker,
)
from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.observables.pauli import (
    PauliEngine as JaxPauliEngine,
)
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.ops import keys as jkeys
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JaxGrouping
from anqs_quantum_chemistry_torch.chem.jw import PauliHamiltonian
from anqs_quantum_chemistry_torch.convert import params_from_jax
from anqs_quantum_chemistry_torch.experiments.preparation import create_masker
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.observables.pauli import PauliEngine
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    hash_lookup,
    hash_lookup_plain,
)
from anqs_quantum_chemistry_torch.sampling.sampler import (
    gumbel_top_k_sample,
    uniform_shapes,
)
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping
from torch_port_common import jax_uniforms, to_np

U32 = np.uint32
# Active orbitals of each register: across every word boundary, and the
# last qubit.
ACTIVE = {
    70: [0, 1, 30, 31, 32, 33, 62, 63, 64, 69],
    84: [0, 1, 31, 32, 33, 62, 63, 64, 65, 83],
    100: [0, 1, 31, 32, 63, 64, 95, 96, 97, 99],
}
N_SAMPLES = 96


def _port_ham(jham):
    return PauliHamiltonian(
        qubit_num=jham.qubit_num, constant=jham.constant,
        a_masks=jham.a_masks, b_words=jham.b_words, weights=jham.weights,
        group_starts=jham.group_starts,
    )


def _integrals(rng, n, act):
    """``tests/test_local_energy.py``'s random problem on orbitals ``act``
    of an n-qubit register."""
    h1 = np.zeros((n, n))
    sub = rng.standard_normal((len(act), len(act)))
    h1[np.ix_(act, act)] = sub + sub.T
    v = np.zeros((n,) * 4)
    s4 = rng.standard_normal((len(act),) * 4)
    v[np.ix_(act, act, act, act)] = s4 + s4.transpose(1, 0, 3, 2)
    return h1, v


def _to_words(ints, n):
    w = -(-n // 32)
    return np.array([[(x >> (32 * j)) & 0xFFFFFFFF for j in range(w)]
                     for x in ints], dtype=U32).reshape(-1, w)


def _spread_ham(jham, act, n):
    """The JAX Hamiltonian of ``len(act)`` qubits with qubit i moved to
    ``act[i]`` of an n-qubit register, its terms re-sorted by flip mask
    (stably) and regrouped."""
    def spread(x):
        return sum(1 << a for i, a in enumerate(act) if (x >> i) & 1)

    starts = np.asarray(jham.group_starts)
    a_of_term = np.repeat(np.asarray(jham.a_masks)[:, 0].astype(np.int64),
                          np.diff(starts))
    a = [spread(int(x)) for x in a_of_term]
    b = [spread(int(x)) for x in np.asarray(jham.b_words)[:, 0]]
    order = sorted(range(len(a)), key=lambda t: a[t])
    a = [a[t] for t in order]
    starts = [t for t in range(len(a)) if t == 0 or a[t] != a[t - 1]]
    return JaxPauliHamiltonian(
        qubit_num=n, constant=float(jham.constant),
        a_masks=_to_words([a[t] for t in starts], n),
        b_words=_to_words([b[t] for t in order], n),
        weights=np.asarray(jham.weights)[order],
        group_starts=np.array(starts + [len(a)], dtype=np.int64),
    )


@functools.lru_cache(maxsize=None)
def case(n):
    """(JAX Hamiltonian, sorted words (B, W) uint32, log|psi|, phase,
    valid) of an n-qubit embedding; at 70 qubits exactly
    ``tests/test_local_energy.py``'s (rng 29, the dense integrals)."""
    rng = np.random.default_rng(29 if n == 70 else n)
    act = ACTIVE[n]
    if n == 70:
        jham = jordan_wigner_pauli_hamiltonian(*_integrals(rng, n, act))
    else:
        small = jordan_wigner_pauli_hamiltonian(
            *_integrals(rng, len(act), list(range(len(act)))))
        jham = _spread_ham(small, act, n)
    assert jham.a_masks.shape[1] == -(-n // 32)
    bits = np.zeros((N_SAMPLES, n), dtype=np.int64)
    bits[:, act] = rng.integers(0, 2, size=(N_SAMPLES, len(act)))
    words = jbits.pack(jnp.asarray(bits))
    valid = jnp.asarray(rng.random(N_SAMPLES) < 0.9)
    words = jnp.where(valid[:, None], words,
                      jnp.full_like(words, jbits.UINT(0xFFFFFFFF)))
    sw, _, sv = jkeys.sort_words(words, valid.astype(jnp.int32))
    sv = sv.astype(bool) & jkeys.unique_mask(sw)
    la = -np.abs(rng.standard_normal(N_SAMPLES)).astype(np.float32)
    ph = rng.standard_normal(N_SAMPLES).astype(np.float32)
    return jham, np.asarray(sw), la, ph, np.asarray(sv)


@functools.lru_cache(maxsize=None)
def jax_search(n):
    jham, sw, la, ph, sv = case(n)
    e = JaxPauliEngine(jham, membership="search").local_energy_proxy(
        jnp.asarray(sw), jnp.asarray(la), jnp.asarray(ph), jnp.asarray(sv))
    return jax.tree.map(np.asarray, e)


def _port_inputs(sw, la, ph, sv):
    return (torch.from_numpy(sw.astype(np.int64)), torch.tensor(la),
            torch.tensor(ph), torch.tensor(sv))


def _assert_energies_match(got, ref):
    assert int(got.found_pairs) == int(ref.found_pairs)
    np.testing.assert_allclose(got.e_re.numpy(), ref.e_re, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.t_re.numpy(), ref.t_re, rtol=1e-5,
                               atol=1e-6)
    assert int(got.table_overflow) == 0


@pytest.mark.parametrize("membership", ["hash", "prefilter", "search"])
@pytest.mark.parametrize("n", [70, 84, 100])
def test_multiword_membership_matches_jax_search(n, membership):
    jham, sw, la, ph, sv = case(n)
    ref = jax_search(n)
    assert int(ref.found_pairs) > int(sv.sum())  # off-diagonal pairs too
    eng = PauliEngine(_port_ham(jham), device="cpu", membership=membership)
    assert eng.hash_epb == 16
    got = eng.local_energy_proxy(*_port_inputs(sw, la, ph, sv))
    _assert_energies_match(got, ref)
    assert int(got.pf_dropped_rows) == 0


@pytest.mark.parametrize("n", [84, 100])
def test_auto_membership_above_64_qubits_is_prefilter(n):
    """'auto' resolves as JAX's: 'prefilter' at W 3-4, under the same
    ``weights_matmul``."""
    jham = case(n)[0]
    eng = PauliEngine(_port_ham(jham), device="cpu")
    jeng = JaxPauliEngine(jham)
    assert (eng.membership, eng.weights_matmul) == (
        jeng.membership, jeng.weights_matmul) == ("prefilter", "split")


def _ham40():
    """The 40-qubit (two-word) embedding of ``tests/test_local_energy.py``
    and 64 sampled rows over its active qubits and three high bits."""
    rng = np.random.default_rng(20260816)
    jham = jordan_wigner_pauli_hamiltonian(*_integrals(rng, 40,
                                                       list(range(12))))
    bits = np.zeros((64, 40), np.int64)
    bits[:, :12] = rng.integers(0, 2, (64, 12))
    bits[:, 35:38] = rng.integers(0, 2, (64, 3))
    words = np.unique(np.stack([(bits[:, :32] << np.arange(32)).sum(1),
                                (bits[:, 32:] << np.arange(8)).sum(1)], 1),
                      axis=0)
    valid = rng.random(len(words)) < 0.9
    la = -np.abs(rng.standard_normal(len(words))).astype(np.float32)
    ph = rng.uniform(-3, 3, len(words)).astype(np.float32)
    return jham, words.astype(U32), la, ph, valid


@pytest.mark.parametrize("membership", ["hash", "prefilter"])
@pytest.mark.parametrize("epb", [8, 16])
def test_hash_epb_matches_jax(epb, membership):
    """JAX's ``hash_epb`` rows at two words: the same table (int32 bits)
    and the same local energies as the JAX engine at that epb."""
    jham, words, la, ph, valid = _ham40()
    kw = dict(membership=membership, hash_epb=epb)
    jeng = JaxPauliEngine(jham, **kw)
    eng = PauliEngine(_port_ham(jham), device="cpu", **kw)
    args = (jnp.asarray(words), jnp.asarray(la), jnp.asarray(ph),
            jnp.asarray(valid))
    targs = _port_inputs(words, la, ph, valid)
    jtab, jnb, _ = jeng._hash_build(*args)
    tab, nb, overflow = eng._hash_build(*targs)
    assert nb == jnb and tab.shape == (nb, 4 * epb) and int(overflow) == 0
    np.testing.assert_array_equal(tab.view(torch.int32).numpy(),
                                  np.asarray(jtab).view(np.int32))
    ref = jax.tree.map(np.asarray, jeng.local_energy_proxy(*args))
    _assert_energies_match(eng.local_energy_proxy(*targs), ref)


@pytest.mark.parametrize("n", [84, 100])
def test_hash_build_matches_jax_multiword(n):
    """The 16-entry planar table of (K + 2) x 16 lanes and its fingerprint
    table, equal to JAX's as int32 bits (bucket and rank included)."""
    jham, sw, la, ph, sv = case(n)
    jtab, jnb, jover, jfp = JaxPauliEngine(
        jham, membership="prefilter")._hash_build(
        jnp.asarray(sw), jnp.asarray(la), jnp.asarray(ph), jnp.asarray(sv),
        with_fp=True)
    tab, nb, over, fp = PauliEngine(
        _port_ham(jham), device="cpu", membership="prefilter")._hash_build(
        *_port_inputs(sw, la, ph, sv), with_fp=True)
    w = sw.shape[1]
    assert (nb, int(over)) == (jnb, int(jover)) and tab.shape == (
        nb, (w + 2) * 16)
    np.testing.assert_array_equal(tab.view(torch.int32).numpy(),
                                  np.asarray(jtab).view(np.int32))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp).view(np.int32))


@pytest.mark.parametrize("n", [84, 100])
def test_plain_lookup_matches_jax_hash_query(n):
    """Hits, misses that share every word but the last with an entry, and
    random misses (words of random bits: none is a key), over the same
    table: ``hash_lookup`` (the plain version on the CPU) against JAX's
    ``_hash_query``, bit for bit."""
    jham, sw, la, ph, sv = case(n)
    jeng = JaxPauliEngine(jham, membership="hash")
    jtab, nb, _ = jeng._hash_build(jnp.asarray(sw), jnp.asarray(la),
                                   jnp.asarray(ph), jnp.asarray(sv))
    tab = torch.from_numpy(np.asarray(jtab))
    rng = np.random.default_rng(n + 1)
    near = sw.copy()
    near[:, -1] ^= U32(1 << 31)  # above the register: never a key
    q = np.concatenate([sw, near, rng.integers(0, 1 << 32, sw.shape,
                                               dtype=np.uint64).astype(U32)])
    want_la, want_ph = jeng._hash_query(
        jtab, nb, tuple(jnp.asarray(q[:, j]) for j in range(q.shape[1])))
    cols = [torch.from_numpy(q[:, j].view(np.int32)) for j in
            range(q.shape[1])]
    launches = hash_lookup.launches
    la_p, ph_p, found = hash_lookup(tab, *cols, entries=16)
    assert hash_lookup.launches == launches  # CPU: the plain version
    np.testing.assert_array_equal(la_p.view(torch.int32).numpy(),
                                  np.asarray(want_la).view(np.int32))
    np.testing.assert_array_equal(ph_p.view(torch.int32).numpy(),
                                  np.asarray(want_ph).view(np.int32))
    stored = {tuple(r) for r in sw[sv]}  # duplicates of a valid row too
    assert found.numpy()[:len(sw)].tolist() == [tuple(r) in stored
                                                for r in sw]
    assert not found.numpy()[len(sw):].any()
    with pytest.raises(ValueError):  # a 16-entry table read as 32 entries
        hash_lookup_plain(tab, *cols)


@pytest.mark.parametrize("chunk", [13, 32])
def test_me_chunk_is_bit_identical(chunk):
    """``me_chunk`` cuts the rows into launches; each row's elements are
    its own, so the result equals the unchunked one bit for bit."""
    jham, sw, _, _, _ = case(84)
    words = torch.from_numpy(sw.astype(np.int64))
    whole = PauliEngine(_port_ham(jham), device="cpu").matrix_elements(words)
    eng = PauliEngine(_port_ham(jham), device="cpu", me_chunk=chunk)
    assert torch.equal(eng.matrix_elements(words), whole)


def test_gumbel_sampler_84_qubits_matches_jax():
    """Cr2's register and sector (84 qubits, 24 + 24 electrons) at
    qubit_per_qudit 6, a narrow MADE with Cr2's logit cap, fed JAX's
    uniforms: the same set of valid three-word rows, log-probs to 1e-5."""
    mol = types.SimpleNamespace(qubit_num=84, n_electrons=48, n_alpha=24,
                                n_beta=24)
    cfg = dict(hidden_widths=(16,), aux_hidden_widths=(16,), logit_cap=8.0)
    jax_anqs = JaxANQS(
        JaxGrouping.create(jax_create_masker(mol, "e_num_spin"), 6),
        JaxAnqsConfig(**cfg))
    params = jax_anqs.init(jax.random.PRNGKey(3))
    anqs = ANQS(QubitGrouping.create(create_masker(mol, "e_num_spin"), 6),
                AnqsConfig(**cfg))
    anqs.load_state_dict(params_from_jax(to_np(params)))
    assert anqs.n_words == 3 and len(uniform_shapes(anqs, 64)) == 14
    key = jax.random.PRNGKey(7)
    js = jax.jit(functools.partial(jax_gumbel_top_k_sample, jax_anqs,
                                   sample_num=64))(params, key)
    out = gumbel_top_k_sample(
        anqs, 64, uniforms=jax_uniforms(key, uniform_shapes(anqs, 64)))
    jvalid = np.asarray(js.valid)
    jw = np.asarray(js.words)[jvalid].astype(np.int64)
    w = out.words[out.valid].numpy()
    assert out.words.shape == (64, 3) and len(w) == 64
    assert len({tuple(r) for r in w}) == len(w)
    order, jorder = np.lexsort(w.T[::-1]), np.lexsort(jw.T[::-1])
    np.testing.assert_array_equal(w[order], jw[jorder])
    np.testing.assert_allclose(out.log_probs[out.valid].numpy()[order],
                               np.asarray(js.log_probs)[jvalid][jorder],
                               rtol=0, atol=1e-5)
    assert np.all((w[:, 2] >> 20) == 0)  # nothing above qubit 83


def test_vmc_step_84_qubits_matches_jax():
    """One training step on the 84-qubit embedding in both packages, from
    one set of weights and JAX's uniforms: 14 qudits of Gumbel samples over
    three words, the pinned HF neighbourhood (``couple_ref_dets``), the
    all-ones sentinels and the canonical three-word sort, prefilter
    membership in ``pf_row_chunk`` blocks with ``me_chunk`` launches and a
    dense fallback: ``unique_num``, ``found_pairs`` and
    ``pf_dropped_rows`` equal, the energy within 1e-6 Ha, the gradients
    (SGD at lr 1) to 1e-5 of their largest magnitude plus one float32 unit
    of the largest weight (JAX's gradient is read as the float32 update
    p0 - p1, exact to that unit)."""
    from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
    from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
    from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig

    jham = case(84)[0]
    hf = (1 << 0) | (1 << 1) | (1 << 31) | (1 << 32)  # across word 0/1

    def molecule(ham):
        return types.SimpleNamespace(
            qubit_num=84, n_electrons=4, n_alpha=2, n_beta=2, hf_det=hf,
            fci_ndet=861 ** 2, z2_generators=np.zeros((0, 84), np.int64),
            qubit_ham=ham)

    cfg = dict(sample_num=64, sampling_mode="gumbel", qubit_per_qudit=6,
               opt_type="sgd", lr=1.0, grad_clip_norm=1.0,
               couple_ref_dets=16, seed=3,
               engine_overrides={"me_chunk": 16, "pf_row_chunk": 32,
                                 "prefilter_row_capacity": 4,
                                 "prefilter_dense_rows": 64})
    anqs_kw = dict(hidden_widths=(16,), aux_hidden_widths=(16,),
                   logit_cap=8.0)
    jv = jvmc.VMC(molecule(jham), jvmc.VMCConfig(
        sr=JaxSRConfig(max_indices_num=50), **cfg), JaxAnqsConfig(**anqs_kw))
    v = VMC(molecule(_port_ham(jham)), VMCConfig(
        sr=SRConfig(max_indices_num=50), **cfg), AnqsConfig(**anqs_kw),
        device="cpu")
    assert v.engine.membership == jv.engine.membership == "prefilter"
    assert v.anqs.n_words == 3 and v.ref_neighbor_words.shape == (16, 3)
    params, opt_state, key = jv.init_state()
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(params)))
    p1, _, _, jm = jv._step(params, opt_state, key)
    _, sample_key = jax.random.split(key)
    metrics, grads = v._grads_and_metrics(
        state, jax_uniforms(sample_key, uniform_shapes(v.anqs, 64)))
    for name in ("unique_num", "found_pairs", "pf_dropped_rows",
                 "table_overflow"):
        assert int(metrics[name]) == int(jm[name]), name
    assert int(metrics["found_pairs"]) > int(metrics["unique_num"]) > 64
    assert abs(float(metrics["energy"]) - float(jm["energy"])) < 1e-6
    want = params_from_jax(to_np(jax.tree.map(lambda a, b: a - b, params,
                                              p1)))
    p0 = params_from_jax(to_np(params))
    for name, g in grads.items():
        w = want[name].numpy()
        unit = np.spacing(np.max(np.abs(p0[name].numpy())))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(w)) + unit,
                                   err_msg=name)
