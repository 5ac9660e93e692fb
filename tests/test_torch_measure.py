"""The trainer's measurement surface in the PyTorch port against the JAX
package: ``VMC._multi_step`` (a window equals as many ``step`` calls bit
for bit), ``VMC.step_cost_analysis`` (``utils/cost.py``: the matmul-class
flops equal a count from the MADE shapes exactly; kernel #1's, #2's and
#3's entries equal their counts from the shapes; two calls agree and leave the
training state as it was; JAX's XLA totals printed beside the port's),
``VMC.profile_stages`` (JAX's keys on the sector, dynamic and exact
branches, with and without MinSR), and the small helpers
``ANQS.amplitude``, ``ANQS.cond_for_qudit`` and ``Config.to_path_suffix``
against JAX's on the same weights. LiH/STO-3G on the CPU, where the
kernels' plain versions run."""

import copy

import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.chem.molecule import MolConfig as JaxMolConfig
from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
from anqs_quantum_chemistry_torch.chem.molecule import MolConfig, Molecule
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.ops.hash_lookup import (
    fp_filter,
    hash_lookup,
)
from anqs_quantum_chemistry_torch.ops.matrix_elements import (
    fused_matrix_elements,
)
from anqs_quantum_chemistry_torch.optim.sr import SRConfig
from anqs_quantum_chemistry_torch.sampling.sampler import uniform_shapes
from anqs_quantum_chemistry_torch.utils import cost
from torch_port_common import build_pair, mol_path, molecules

# The cost configuration: 256 Gumbel samples, qubit_per_qudit 3, MADE
# (64,) (the aux net at its default 512), MinSR on the top 20; JAX's
# defaults otherwise (Adam 1e-3, seed 0).
B, K_SR = 256, 20
COST = dict(sample_num=B, sampling_mode="gumbel", qubit_per_qudit=3)


@pytest.fixture(scope="module")
def lih():
    return Molecule.from_npz(mol_path("LiH"), name="LiH")


def cost_vmc(mol, sr=K_SR, widths=(64,), **cfg):
    return VMC(mol, VMCConfig(**{**COST, **cfg}, sr=sr and SRConfig(
        max_indices_num=sr)), AnqsConfig(hidden_widths=widths), device="cpu")


def test_multi_step_equals_steps(lih):
    """``_multi_step(3)`` equals three ``step`` calls of a twin trainer bit
    for bit: every metric (JAX's names, stacked (3,) float64) and every
    parameter after the window."""
    a, b = cost_vmc(lih, sample_num=128), cost_vmc(lih, sample_num=128)
    sa, sb = a.init_state(), b.init_state()
    rows = [a.step(sa) for _ in range(3)]
    state, m = b._multi_step(3)(sb)
    assert state is sb
    assert sorted(m) == sorted(rows[0])
    for k, v in m.items():
        assert v.shape == (3,) and v.dtype == np.float64, k
        np.testing.assert_array_equal(v, [r[k] for r in rows], err_msg=k)
    for (n, p), q in zip(a.anqs.named_parameters(), b.anqs.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError):
        b._multi_step(0)


def _net_dims(net):
    return [tuple(p.shape) for n, p in sorted(net.named_parameters())
            if n.startswith("w")]


def _fwd(dims):
    return sum(2 * a * b for a, b in dims)


def _bwd(dims):
    """dW of every layer and dx of every layer but the first."""
    return _fwd(dims) + _fwd(dims[1:])


def test_matmul_flops_from_shapes(lih):
    """The matmul-class flops of one step equal a count from the shapes:
    the sampler's frontier forwards of the main net (``uniform_shapes``'
    rows), log psi of the set, the loss forward and backward, log psi of
    HF, MinSR's per-sample Jacobians (``jacrev``: one forward of the top k,
    then 2k cotangents each batched over the k rows, so k times the 2k
    single-row vjps JAX's ``vmap`` of ``vjp`` takes; filed under
    'minsr_jacobians/'), its four k x P x k products, four matrix-vector
    products and the 2k x 2k solve."""
    v = cost_vmc(lih)
    c = v.step_cost_analysis()
    main, aux = _net_dims(v.anqs.main), _net_dims(v.anqs.aux)
    both_f, both_b = _fwd(main) + _fwd(aux), _bwd(main) + _bwd(aux)
    n_params = sum(p.numel() for p in v.anqs.parameters())
    rows = sum(r for r, _ in uniform_shapes(v.anqs, B))
    n = 2 * K_SR
    jacobians = K_SR * both_f + 2 * K_SR * K_SR * both_b
    want = (rows * _fwd(main)
            + B * both_f
            + B * (both_f + both_b)
            + both_f
            + jacobians
            + 4 * 2 * K_SR * K_SR * n_params + 4 * 2 * K_SR * n_params
            + 2 * n ** 3 // 3 + 2 * n * n)
    assert cost.matmul_flops(c["by_source"]) == want
    assert cost.matmul_flops(c["by_source"], "minsr_jacobians") == jacobians
    assert c["flops"] > want and c["transcendentals"] > 0
    assert c["device"] == "cpu"


def test_kernel_counts_from_shapes(lih):
    """Kernel #1's entry of a sector step: one call, 6 B T flops (three
    float64 FMAs a pair) and the bound's bytes. Kernel #2's of a hash step
    (nb 256 buckets of 32 entries for 256 one-word keys): no flops, the
    queries' words, the table, its tags and 9 B of output a query; the tag
    build the table and the tags. A wrapper's plain version adds no aten
    op of its own to the count."""
    v = cost_vmc(lih, sr=None)
    tables = v.engine.me_tables
    n_terms, m = tables.splits.shape[1], v.engine.n_groups
    me = v.step_cost_analysis()["by_source"]["fused_matrix_elements"]
    assert me == {"kind": "kernel", "calls": 1, "flops": 6 * B * n_terms,
                  "transcendentals": 0, cost.BYTES: 4 * B + n_terms * 10
                  + 4 * (m + 1) + 4 * B * m}

    h = cost_vmc(lih, sr=None, engine_overrides={"membership": "hash"})
    src = h.step_cost_analysis()["by_source"]
    nb, n_q = 256, B * m
    tab, tags = nb * 4 * 32 * 4, nb * 32
    assert src["hash_lookup"] == {
        "kind": "kernel", "calls": 1, "flops": 0, "transcendentals": 0,
        cost.BYTES: 4 * n_q + tab + tags + 9 * n_q}
    assert src["hash_tags"] == {
        "kind": "kernel", "calls": 1, "flops": 0, "transcendentals": 0,
        cost.BYTES: tab + tags}

    words = torch.arange(B, dtype=torch.int64)[:, None]
    query = words[:, 0].to(torch.int32)
    table = torch.zeros((nb, 128), dtype=torch.float32)
    for fn in (lambda: fused_matrix_elements(words, tables),
               lambda: hash_lookup(table, query)):
        with cost.WorkCounter() as counter:
            fn()
        assert all(e["kind"] == "kernel"
                   for e in counter.by_source().values())


def test_filter_counts_from_shapes(lih):
    """Kernel #3's entry of a prefilter step (one row block of B rows, nb
    256 x E 32 fingerprints): one call, no flops (integer hashing), the
    rows' and masks' words, the table and the (B, M) mask; its plain
    version adds no aten op of its own to the count."""
    v = cost_vmc(lih, sr=None, engine_overrides={"membership": "prefilter"})
    m = v.engine.n_groups
    src = v.step_cost_analysis()["by_source"]
    assert src["fp_filter"] == {
        "kind": "kernel", "calls": 1, "flops": 0, "transcendentals": 0,
        cost.BYTES: 8 * B + 4 * m + 4 * 256 * 32 + B * m}
    fptab = torch.zeros((256, 32), dtype=torch.int32)
    rows = torch.arange(B, dtype=torch.int64)[:, None]
    with cost.WorkCounter() as counter:
        fp_filter(fptab, rows, v.engine.a_cols)
    assert list(counter.by_source()) == ["fp_filter"]


def _snapshot(v, state):
    return ({n: p.detach().clone() for n, p in v.anqs.named_parameters()},
            copy.deepcopy(state.opt.state_dict()),
            state.generator.get_state().clone())


def test_cost_analysis_repeats_and_leaves_state(lih):
    """Calls made after a trained step give equal counts (each at a fresh
    optimizer and a generator seeded ``config.seed``, as JAX counts at
    ``init_state``); the parameters, Adam's moments and count and the
    sampler's generator are as they were, so the next step equals a twin
    trainer's that never ran the analysis, bit for bit."""
    a, b = cost_vmc(lih, sample_num=128), cost_vmc(lih, sample_num=128)
    sa, sb = a.init_state(), b.init_state()
    a.step(sa), b.step(sb)
    before = _snapshot(a, sa)
    assert a.step_cost_analysis() == a.step_cost_analysis()
    after = _snapshot(a, sa)
    for n in before[0]:
        assert torch.equal(before[0][n], after[0][n]), n
    assert before[1]["count"] == after[1]["count"] == 1
    for i, st in before[1]["inner"]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, after[1]["inner"]["state"][i][k]), (i, k)
    assert torch.equal(before[2], after[2])
    ra, rb = a.step(sa), b.step(sb)
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_cost_beside_jax(lih, mode):
    """The port's totals beside JAX's XLA counts of the same configuration
    (XLA counts the compiled program, the port the executed ops: printed,
    not bounded). The sector path and the dynamic table share the
    matmuls."""
    jmol, _ = molecules("LiH")
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(
        **COST, sr=JaxSRConfig(max_indices_num=K_SR),
        sector_membership=mode), JaxAnqsConfig(hidden_widths=(64,)))
    want = jv.step_cost_analysis()
    got = cost_vmc(lih, sector_membership=mode).step_cost_analysis()
    print(f"\nLiH {mode}: port flops {got['flops']} transcendentals "
          f"{got['transcendentals']} bytes {got[cost.BYTES]} (matmul "
          f"{cost.matmul_flops(got['by_source'])}); JAX XLA flops "
          f"{want['flops']:.0f} bytes {want[cost.BYTES]:.0f}")
    assert got["flops"] > 0 and want["flops"] > 0


@pytest.fixture(scope="module")
def jax_stage_keys():
    """The keys of JAX's ``profile_stages`` on its widest branch (sampled,
    dynamic membership, MinSR), on LiH with narrow nets."""
    jmol, _ = molecules("LiH")
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(
        sample_num=32, qubit_per_qudit=3, sector_membership="off",
        sr=JaxSRConfig(max_indices_num=4)),
        JaxAnqsConfig(hidden_widths=(8,), aux_hidden_widths=(8,)))
    return set(jv.profile_stages(reps=1))


@pytest.mark.parametrize("sr", [4, None], ids=["sr", "no_sr"])
@pytest.mark.parametrize("branch", ["sector", "dynamic", "exact"])
def test_profile_stages_keys(lih, jax_stage_keys, branch, sr):
    """``profile_stages(reps=2)`` has JAX's keys (no ``sample_ms`` in exact
    mode, ``sr_ms`` only with MinSR; ``local_energy_ms`` by the static,
    sector or proxy path) and ``device``; every time is positive and
    finite; the trainer's parameters are untouched."""
    cfg = dict(sample_num=32, sector_membership="off"
               if branch == "dynamic" else "auto")
    if branch == "exact":
        cfg["sampling_mode"] = "exact"
    v = cost_vmc(lih, sr=sr, widths=(8,), **cfg)
    assert (v.sector_words is not None) == (branch == "sector")
    assert (v.exact_partner_idx is not None) == (branch == "exact")
    before = {n: p.detach().clone() for n, p in v.anqs.named_parameters()}
    res = v.profile_stages(reps=2)
    want = set(jax_stage_keys)
    if branch == "exact":
        want.discard("sample_ms")
    if sr is None:
        want.discard("sr_ms")
    assert res.pop("device") == "cpu"
    assert set(res) == want
    assert all(np.isfinite(t) and t > 0 for t in res.values()), res
    for n, p in v.anqs.named_parameters():
        assert torch.equal(p, before[n]), n


def test_helpers_match_jax(rng):
    """``amplitude`` and ``cond_for_qudit`` (every qudit, each row's
    symmetry mask) against JAX's on the same weights, to 1e-5; a
    ``Config``'s ``to_path_suffix`` as JAX's."""
    mol, jax_anqs, params, anqs = build_pair("LiH", 3, width=16)
    words = torch.from_numpy(rng.integers(0, 1 << 12, (64, 1)))
    re, im = anqs.amplitude(words)
    jre, jim = jax_anqs.amplitude(params, words.numpy().astype(np.uint32))
    np.testing.assert_allclose(re.detach().numpy(), np.asarray(jre),
                               atol=1e-5)
    np.testing.assert_allclose(im.detach().numpy(), np.asarray(jim),
                               atol=1e-5)
    _, masks = anqs.memo_path(words)
    for q in range(anqs.qudit_num):
        got = anqs.cond_for_qudit(words, q, masks[:, q]).detach().numpy()
        want = jax_anqs.cond_for_qudit(params, words.numpy().astype(
            np.uint32), q, masks[:, q].numpy())
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    for kw in (dict(name="LiH"), dict(name="C2H4", basis="6-31g")):
        assert MolConfig(**kw).to_path_suffix() == JaxMolConfig(
            **kw).to_path_suffix()
