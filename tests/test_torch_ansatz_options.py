"""The ansatz options of the PyTorch port against the JAX package, from the
same weights (``convert.params_from_jax``, whose strict load also shows
that both packages hold the same parameters: no ``b{i}`` where a layer has
no bias, no ``aux`` under the 'log_psi' head): MADE and NADE per-layer
patterns (activations, biases, residuals), ``subtract_mean``, the
'log_psi' head and ``compute_dtype='bfloat16'`` for all three nets, the
masking patterns (log_psi and Gumbel sample sets from JAX's uniforms), the
sign structure, MinSR without regularisation, ``BFState`` and
``popcount_hw``. LiH at qubit_per_qudit 4 (three 16-way qudits), narrow
nets. Tolerances: float32 1e-5 (2e-5 for the phase of the
'log_abs_phase' head, pi times a net output); where activations are stored
in bfloat16, 1e-4 (2e-4 for that phase): the packages round the same
activations (measured within 1e-6), and the float32 net of the same
weights is more than ten times that far from JAX's bfloat16 output (5.4e-3
for MADE, 1.1e-2 for NADE, 4.2e-2 for the transformer), which the test
checks, so a port that skipped the rounding fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.models.bf_state import BFState as JaxBFState
from anqs_quantum_chemistry_tpu.ops import bits as jbits
from anqs_quantum_chemistry_tpu.optim import sr as jsr
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.models.anqs import ANQS, AnqsConfig
from anqs_quantum_chemistry_torch.models.bf_state import BFState
from anqs_quantum_chemistry_torch.ops import bits
from anqs_quantum_chemistry_torch.optim import sr
from anqs_quantum_chemistry_torch.sampling.sampler import (
    gumbel_top_k_sample,
    uniform_shapes,
)
from anqs_quantum_chemistry_torch.symmetries import QubitGrouping
from torch_port_common import build_pair, jax_uniforms, molecules
from torch_step_common import assert_step_matches, step_pair

NETS = {
    "made": dict(net_type="made", hidden_widths=(16, 16),
                 aux_hidden_widths=(16, 16)),
    "nade": dict(net_type="nade", hidden_widths=(16, 16),
                 aux_hidden_widths=(16, 16)),
    "transformer": dict(net_type="transformer", d_model=16, n_heads=2,
                        n_layers=2, d_ff=32),
}


def lih_words(rng, mol, extra=32):
    """The whole LiH sector and ``extra`` random 12-qubit states."""
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    rand = rng.integers(0, 2**mol.qubit_num, extra).astype(np.uint64)
    return np.concatenate([dets, rand]).astype(np.int64)[:, None]


def check_log_psi(rng, net, atol=1e-5, seed=1, unrounded=False, **kw):
    """The port's log_psi against JAX's on LiH's words, to ``atol`` (twice
    that on the phase). ``unrounded``: also hold the port's float32 net of
    the same weights against JAX's output, which it must miss by more than
    ten times those tolerances."""
    mol, jax_anqs, params, anqs = build_pair("LiH", 4, seed=seed,
                                             **{**NETS[net], **kw})
    words = lih_words(rng, mol)
    la_j, ph_j = jax_anqs.log_psi(params, jnp.asarray(words, jnp.uint32))
    with torch.no_grad():
        la, ph = anqs.log_psi(torch.from_numpy(words))
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(ph.numpy(), np.asarray(ph_j), rtol=0,
                               atol=2 * atol)
    if unrounded:
        plain = ANQS(anqs.grouping, AnqsConfig(**NETS[net]))
        plain.load_state_dict(anqs.state_dict())
        with torch.no_grad():
            la32, ph32 = plain.log_psi(torch.from_numpy(words))
        assert np.max(np.abs(la32.numpy() - np.asarray(la_j))) > 10 * atol
        assert np.max(np.abs(ph32.numpy() - np.asarray(ph_j))) > 20 * atol
    return anqs


@pytest.mark.parametrize("net,kw", [
    ("made", dict(activation="tanh")),
    ("made", dict(activation="relu")),
    ("made", dict(activation="gelu")),
    ("made", dict(activation="leaky_relu")),
    ("made", dict(activation="silu")),
    ("made", dict(activation="sanqs_paper")),
    ("made", dict(activation=("relu", "gelu"))),
    ("made", dict(bias=(True, False, True))),
    ("made", dict(bias=(False, False, False))),
    ("made", dict(residual=False)),
    ("made", dict(subtract_mean=False)),
    ("nade", dict(activation="sanqs_paper")),
    ("nade", dict(bias=(False, True, False))),
    ("nade", dict(activation=("silu", "gelu"), residual=False,
                  subtract_mean=False)),
])
def test_patterns_match_jax(rng, net, kw):
    anqs = check_log_psi(rng, net, **kw)
    bias = kw.get("bias", True)
    if bias is not True:
        names = dict(anqs.named_parameters())
        prefix = "main." if net == "made" else "main.qudit0."
        for i, on in enumerate(bias):
            assert (prefix + f"b{i}" in names) == on


@pytest.mark.parametrize("net", ["made", "nade", "transformer"])
def test_log_psi_head_matches_jax(rng, net):
    anqs = check_log_psi(rng, net, head_mode="log_psi")
    assert anqs.aux is None
    out_channels = anqs.main.spec.n_channels
    assert out_channels == 2


# With both knobs, MADE's and NADE's operands are bfloat16 already, so the
# JAX result is the same at either matmul precision. The transformer's
# attention products take float32 operands, which JAX's CPU backend does
# not round at matmul_precision='bfloat16' (it ignores the precision; see
# test_torch_precision.py): that case has no CPU reference.
@pytest.mark.parametrize("net,matmul_precision", [
    ("made", None), ("made", "bfloat16"), ("nade", None),
    ("nade", "bfloat16"), ("transformer", None)])
def test_compute_dtype_bfloat16_matches_jax(rng, net, matmul_precision):
    check_log_psi(rng, net, atol=1e-4, unrounded=True,
                  compute_dtype="bfloat16",
                  matmul_precision=matmul_precision)


def test_compute_dtype_rounds_activations(rng):
    """bfloat16 storage is not the float32 net: from one set of weights
    the two differ by more than float32 rounding."""
    mol, _, _, a = build_pair("LiH", 4, **NETS["made"])
    b = ANQS(a.grouping, AnqsConfig(**NETS["made"],
                                    compute_dtype="bfloat16"))
    b.load_state_dict(a.state_dict())
    words = torch.from_numpy(lih_words(rng, mol))
    with torch.no_grad():
        gap = torch.max(torch.abs(a.log_psi(words)[0] - b.log_psi(words)[0]))
    assert float(gap) > 1e-4


@pytest.mark.parametrize("kw", [dict(masking_mode="unmasked"),
                                dict(masking_depth=1)])
def test_masking_log_psi_and_gumbel_match_jax(rng, kw):
    """Unmasked qudits normalize over every continuation: log|psi| of
    out-of-sector states is finite there, and the Gumbel sampler draws
    from the same law (the same sets from JAX's uniforms)."""
    check_log_psi(rng, "made", **kw)
    mol, jax_anqs, params, anqs = build_pair("LiH", 4, **{**NETS["made"],
                                                          **kw})
    key = jax.random.PRNGKey(5)
    k = 128
    js = jax.jit(jax_gumbel_top_k_sample, static_argnums=(0, 3))(
        jax_anqs, params, key, k)
    out = gumbel_top_k_sample(
        anqs, k, uniforms=jax_uniforms(key, uniform_shapes(anqs, k)))
    jvalid = np.asarray(js.valid)
    jw = np.asarray(js.words)[jvalid][:, 0].astype(np.int64)
    w = out.words[out.valid][:, 0].numpy()
    np.testing.assert_array_equal(np.sort(w), np.sort(jw))
    lp = out.log_probs[out.valid].numpy()
    jl = np.asarray(js.log_probs)[jvalid]
    np.testing.assert_allclose(lp[np.argsort(w)], jl[np.argsort(jw)],
                               rtol=0, atol=1e-5)
    dets = set(sector_determinants(mol.qubit_num, mol.n_alpha,
                                   mol.n_beta).tolist())
    outside = sum(int(x) not in dets for x in w)
    assert outside > 0  # the unmasked tail leaves the (N, Sz) sector
    assert anqs.leaves_sector


def test_sign_structure_replaces_phase(rng):
    """A {0, pi} table of 2^12 entries: every phase is its entry, in both
    packages."""
    mol, jax_anqs, params, anqs = build_pair("LiH", 4, **NETS["made"])
    table = np.pi * rng.integers(0, 2, 2**mol.qubit_num).astype(np.float32)
    from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS

    jax_signed = JaxANQS(jax_anqs.grouping, jax_anqs.config,
                         sign_structure=table)
    signed = ANQS(anqs.grouping, anqs.config, sign_structure=table)
    signed.load_state_dict(anqs.state_dict())
    words = lih_words(rng, mol)
    la_j, ph_j = jax_signed.log_psi(params, jnp.asarray(words, jnp.uint32))
    with torch.no_grad():
        la, ph = signed.log_psi(torch.from_numpy(words))
    np.testing.assert_array_equal(ph.numpy(), table[words[:, 0]])
    np.testing.assert_array_equal(ph.numpy(), np.asarray(ph_j))
    np.testing.assert_allclose(la.numpy(), np.asarray(la_j), atol=1e-5)


def _lih_step(jax_sector, sign=None, **acfg):
    """One step on LiH (128 Gumbel samples of its 225-determinant sector,
    MADE 16, qubit_per_qudit 4, seed 3) in both packages; ``jax_sector``:
    JAX's ``sector_membership``."""
    return step_pair(
        "LiH", dict(sample_num=128, sampling_mode="gumbel",
                    qubit_per_qudit=4, seed=3),
        dict(hidden_widths=(16,), aux_hidden_widths=(16,), **acfg),
        dict(sector_membership=jax_sector), sign)


def test_masking_depth_takes_dynamic_membership():
    """masking_depth=1 on LiH: the unmasked last qudit draws states outside
    the (N, Sz) sector, which has no rows for them. JAX's sector
    membership loses every pair of such a sample, its diagonal included
    (found_pairs 18 where the dynamic table finds 586, energy -4.209 Ha
    against -5.377 Ha at seed 3); the port turns sector membership off
    there and matches JAX's dynamic membership (``sector_membership=
    'off'``): gradients rtol 1e-4, energy 1e-6 Ha, the same pairs."""
    jv, v, jm, metrics, grads, want = _lih_step("off", masking_depth=1)
    assert v.sector_words is None and jv.sector_words is None
    assert v.engine.membership == "table"
    assert_step_matches(jm, metrics, grads, want)
    jv_sector, _, jm_sector, _, _, _ = _lih_step("auto", masking_depth=1)
    assert jv_sector.sector_words is not None  # the JAX fault
    assert int(jm_sector["found_pairs"]) < int(metrics["found_pairs"])


def test_sign_structure_step_matches_jax(rng):
    """A VMC step with a {0, pi} sign structure (set on JAX's ansatz as its
    ``_const_targets`` expect, given to the port's trainer): the aux net
    gets zero gradients in both, the rest the same, energies 1e-6 Ha."""
    sign = np.pi * rng.integers(0, 2, 4096).astype(np.float32)
    _, _, jm, metrics, grads, want = _lih_step("auto", sign=sign)
    assert_step_matches(jm, metrics, grads, want)
    assert not any(torch.any(g) for name, g in grads.items()
                   if name.startswith("aux."))


@pytest.mark.parametrize("kw,qpq,table", [
    (dict(activation="softplus"), 4, False),
    (dict(activation=("tanh",)), 4, False),
    (dict(bias=(True, True)), 4, False),
    (dict(spin_flip_abs=True), 3, False),  # a qudit on odd qubits
    (dict(spin_flip_phase=True), 4, True),
    (dict(masking_depth=4), 4, False),  # 3 qudits
])
def test_invalid_options_raise(kw, qpq, table):
    _, mol = molecules("LiH")
    from anqs_quantum_chemistry_torch.experiments.preparation import (
        create_masker,
    )

    grouping = QubitGrouping.create(create_masker(mol), qpq)
    sign = np.zeros(2**mol.qubit_num, np.float32) if table else None
    with pytest.raises(ValueError):
        ANQS(grouping, AnqsConfig(**{**NETS["made"], **kw}),
             sign_structure=sign)


@pytest.mark.parametrize("kw", [dict(head_mode="log_abs"),
                                dict(masking_mode="partly"),
                                dict(compute_dtype="float16")])
def test_invalid_config_raises(kw):
    with pytest.raises(ValueError):
        AnqsConfig(**kw)


@pytest.mark.parametrize("k", [20, 50])
def test_minsr_without_regularisation_matches_jax(k):
    """``use_reg=False``: O^dag (S + 2^-14 max diag S)^-2 O g, float64
    here, JAX's float32 Schulz solve there: rtol 1e-4 of the norm."""
    rng = np.random.default_rng(k)
    p = 300
    o = 0.3 * (rng.standard_normal((k, p)) + 1j * rng.standard_normal((k, p)))
    o = o.astype(np.complex64)
    g = rng.standard_normal(p).astype(np.float32)
    want = np.asarray(jsr.minsr_precondition(
        jnp.asarray(o.real), jnp.asarray(o.imag), jnp.asarray(g), 1e-4,
        use_reg=False))
    got = sr.minsr_precondition(
        torch.from_numpy(o.real.copy()), torch.from_numpy(o.imag.copy()),
        torch.from_numpy(g), 1e-4, use_reg=False).numpy()
    assert np.linalg.norm(got - want) < 1e-4 * np.linalg.norm(want)
    assert sr.SRConfig(use_reg=False).use_reg is False


def test_bf_state_matches_jax():
    """Dense-state oracle: log_psi, probs and the multinomial's words from
    the same table, the counts injected from JAX's draw; its own draw sums
    to the sample number."""
    n = 10
    jbf = JaxBFState(n)
    jparams = jbf.init(jax.random.PRNGKey(3), support=np.arange(0, 1024, 3))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    bf = BFState(n, device="cpu")
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**n, 200).astype(np.int64)[:, None]
    la_j, ph_j = jbf.log_psi(jparams, jnp.asarray(words, jnp.uint32))
    la, ph = bf.log_psi(params, torch.from_numpy(words))
    np.testing.assert_array_equal(la.numpy(), np.asarray(la_j))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(ph_j))
    np.testing.assert_allclose(bf.probs(params).numpy(),
                               np.asarray(jbf.probs(jparams)), atol=1e-7)
    jw, jc = jbf.sample_counts(jparams, jax.random.PRNGKey(4), 5000)
    w, c = bf.sample_counts(params, 5000,
                            draw=lambda num, p: np.array(jc))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    _, own = bf.sample_counts(params, 5000, torch.Generator().manual_seed(0))
    assert int(own.sum()) == 5000
    assert int(own[torch.isinf(params["log_abs"])].sum()) == 0
    fresh = bf.init(torch.Generator().manual_seed(0), support=[1, 5])
    assert abs(float(bf.probs(fresh).sum()) - 1.0) < 1e-6
    with pytest.raises(ValueError):
        BFState(21, device="cpu")


@pytest.mark.parametrize("w", [1, 2, 3])
def test_popcount_hw_matches_popcount(rng, w):
    words = rng.integers(0, 2**32, (257, w), dtype=np.uint64)
    words = torch.from_numpy(words.astype(np.int64))
    assert torch.equal(bits.popcount_hw(words), bits.popcount(words))
    want = np.asarray(jbits.popcount_hw(jnp.asarray(words.numpy(),
                                                    jnp.uint32)))
    np.testing.assert_array_equal(bits.popcount_hw(words).numpy(), want)
