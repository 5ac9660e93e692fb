"""The NADE ansatz of the PyTorch port against the JAX package.

Both packages run the same parameters (JAX's tree, converted by
``convert.params_from_jax``): ``log_psi`` over whole sectors, the
parameter tree's names and shapes, and the Gumbel sampler fed JAX's own
uniforms. Causality and normalization are checked on the port alone. The
packaged JAX closure state (``data/li2o_nade_closure.npz``) is held bit for
bit against the orbax checkpoint it was exported from.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anqs_quantum_chemistry_tpu.ops import bits as jax_bits
from anqs_quantum_chemistry_tpu.sampling.sampler import (
    gumbel_top_k_sample as jax_gumbel_top_k_sample,
)
from anqs_quantum_chemistry_torch.chem.fci import sector_determinants
from anqs_quantum_chemistry_torch.chem.molecule import DATA_DIR
from anqs_quantum_chemistry_torch.experiments.vmc import (
    li2o_nade_closure_params,
    li2o_nade_vmc,
)
from anqs_quantum_chemistry_torch.models.nade import (
    NADE,
    NadeSpec,
    visibility,
)
from anqs_quantum_chemistry_torch.ops import bits as bitops
from anqs_quantum_chemistry_torch.sampling.sampler import (
    gumbel_top_k_sample,
    uniform_shapes,
)
from torch_port_common import ROOT, build_pair, jax_uniforms, to_np

NADE_KW = dict(net_type="nade", hidden_widths=(16, 16),
               aux_hidden_widths=(16, 16))
CLOSURE_CKPT = os.path.join(ROOT, "runs", "li2o_closure", "ckpt_16000")


def sector_bits(mol):
    dets = sector_determinants(mol.qubit_num, mol.n_alpha, mol.n_beta)
    return ((dets[:, None] >> np.arange(mol.qubit_num, dtype=np.uint64))
            & np.uint64(1)).astype(np.int64)


@pytest.mark.parametrize("name,qpq", [("LiH", 2), ("H2O", 3)])
def test_nade_log_psi_matches_jax(name, qpq):
    mol, jax_anqs, params, anqs = build_pair(name, qpq, **NADE_KW)
    bits = sector_bits(mol)
    jla, jph = jax_anqs.log_psi(params, jax_bits.pack(jnp.asarray(bits)))
    with torch.no_grad():
        la, ph = anqs.log_psi(bitops.pack(torch.from_numpy(bits)))
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=0,
                               atol=1e-5)


def test_nade_causal_and_normalized():
    """Subnet q's outputs do not move when the qubits of qudits >= q
    change; the conditionals are normalized, so |psi|^2 sums to 1 over the
    sector (every sector determinant is allowed by the masks)."""
    mol, _, _, anqs = build_pair("H2O", 3, **NADE_KW)
    spec = anqs.main.spec
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (64, mol.qubit_num)))
    with torch.no_grad():
        out = anqs.main(bits)
        for q, start in enumerate(spec.qudit_starts):
            flipped = bits.clone()
            flipped[:, start:] = 1 - flipped[:, start:]
            torch.testing.assert_close(anqs.main(flipped)[:, q], out[:, q],
                                       rtol=0, atol=0)
        la, _ = anqs.log_psi(bitops.pack(torch.from_numpy(sector_bits(mol))))
    assert abs(float(torch.sum(torch.exp(2.0 * la.double()))) - 1.0) < 1e-5
    vis = visibility(spec)
    assert vis.shape == (spec.qudit_num, mol.qubit_num)
    assert not vis[0].any() and vis[-1].sum() == spec.qudit_starts[-1]


def test_nade_parameter_tree_matches_jax():
    """The port's state dict holds JAX's tree under dotted names
    (``main.qudit{q}.w{i}`` ...) with JAX's shapes; a fresh init is
    Glorot-normal with zero biases, reproducible from its generator."""
    _, _, params, anqs = build_pair("LiH", 2, **NADE_KW)
    want = {f"{net}.{q}.{k}": v.shape
            for net, tree in to_np(params).items()
            for q, sub in tree.items() for k, v in sub.items()}
    got = {k: tuple(v.shape) for k, v in anqs.state_dict().items()}
    assert got == want
    assert "main.qudit0.w0" in got and "aux.qudit2.b2" in got
    spec = anqs.main.spec
    a = NADE(spec, torch.Generator().manual_seed(3))
    b = NADE(spec, torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb)
        if name.split(".")[-1].startswith("b"):
            assert not pa.any()
    w1 = a.qudit1.w1
    assert abs(float(w1.detach().std()) - np.sqrt(2.0 / 32)) < 0.05


def test_nade_gumbel_sample_matches_jax():
    mol, jax_anqs, params, anqs = build_pair("LiH", 2, **NADE_KW)
    key, k = jax.random.PRNGKey(7), 64
    run = jax.jit(functools.partial(jax_gumbel_top_k_sample, jax_anqs,
                                    sample_num=k))
    js = run(params, key)
    out = gumbel_top_k_sample(
        anqs, k, uniforms=jax_uniforms(key, uniform_shapes(anqs, k)))
    jvalid = np.asarray(js.valid)
    jw = np.asarray(js.words)[jvalid][:, 0].astype(np.int64)
    w = out.words[out.valid][:, 0].numpy()
    assert len(w) == len(set(w)) == k
    np.testing.assert_array_equal(np.sort(w), np.sort(jw))


def test_li2o_closure_state_loads():
    """The packaged closure state fits ``li2o_nade_vmc``'s ansatz (NADE
    (128, 128), 5 qudits of 6 qubits): 287,360 float32 values."""
    vmc = li2o_nade_vmc(device="cpu")
    params = li2o_nade_closure_params()
    vmc.anqs.load_state_dict(params)
    assert sum(v.numel() for v in params.values()) == 287360
    assert vmc.anqs.main.spec == NadeSpec(
        qubit_num=30, qudit_starts=(0, 6, 12, 18, 24),
        qudit_ends=(6, 12, 18, 24, 30), max_qudit_dim=64,
        hidden_widths=(128, 128))


@pytest.mark.skipif(not os.path.isdir(CLOSURE_CKPT),
                    reason="runs/li2o_closure/ckpt_16000 is not present")
def test_packaged_closure_state_equals_checkpoint():
    spec = importlib.util.spec_from_file_location(
        "export_jax_params", os.path.join(ROOT, "tools",
                                          "export_jax_params.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.flatten(tool.restore_params(CLOSURE_CKPT))
    with np.load(os.path.join(DATA_DIR, "li2o_nade_closure.npz")) as data:
        got = dict(data)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("name,membership", [("LiH", "sector"),
                                             ("H2O", "prefilter")])
def test_nade_step_matches_jax(name, membership):
    """One training step with the NADE ansatz, tempered gradient weights
    (T 2) and MinSR, from the same weights and sampler uniforms: the
    sector path on LiH's whole sector, and prefilter membership on 256 of
    H2O's 441 determinants at capacities that drop rows (16, 64). The
    gradients (SGD at lr 1: JAX's update is minus the gradient) to 1e-4
    relative + 1e-6, the energy to 1e-6 Ha and the variance to 1e-6
    relative (its float32 sum at |E_loc|^2 ~ 1e4), the pairs exactly."""
    from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
    from anqs_quantum_chemistry_tpu.models.anqs import (
        AnqsConfig as JaxAnqsConfig,
    )
    from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
    from anqs_quantum_chemistry_torch.convert import params_from_jax
    from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
    from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
    from anqs_quantum_chemistry_torch.optim.sr import SRConfig
    from torch_port_common import molecules

    jmol, mol = molecules(name)
    cfg = dict(sample_num=256, sampling_mode="gumbel", qubit_per_qudit=6,
               grad_weight_temperature=2.0, grad_clip_norm=1.0, seed=3,
               opt_type="sgd", lr=1.0)
    jax_extra, port_extra = {}, {}
    if membership == "prefilter":
        caps = {"prefilter_row_capacity": 16, "prefilter_dense_rows": 64}
        jax_extra = dict(sector_membership="off", engine_overrides={
            "membership": "prefilter", **caps})
        port_extra = dict(engine_overrides={"membership": "prefilter",
                                            **caps})
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(sr=JaxSRConfig(max_indices_num=50),
                                       **cfg, **jax_extra),
                  JaxAnqsConfig(**NADE_KW))
    v = VMC(mol, VMCConfig(sr=SRConfig(max_indices_num=50), **cfg,
                           **port_extra), AnqsConfig(**NADE_KW),
            device="cpu")
    p0, o0, key = jv.init_state()
    state = v.init_state()
    v.anqs.load_state_dict(params_from_jax(to_np(p0)))
    p1, _, _, jm = jv._step(p0, o0, key)
    want = params_from_jax(to_np(jax.tree.map(lambda a, b: a - b, p0, p1)))
    _, sample_key = jax.random.split(key)
    uniforms = jax_uniforms(sample_key, uniform_shapes(v.anqs, 256))
    metrics, grads = v._grads_and_metrics(state, uniforms)
    for k, g in grads.items():
        np.testing.assert_allclose(g.detach().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("unique_num", "found_pairs", "pf_dropped_rows"):
        assert int(metrics[k]) == int(jm[k]), k
    if membership == "prefilter":
        assert int(metrics["pf_dropped_rows"]) > 0
    assert abs(float(metrics["energy"]) - float(jm["energy"])) < 1e-6
    assert float(metrics["energy_var"]) == pytest.approx(
        float(jm["energy_var"]), rel=1e-6)
