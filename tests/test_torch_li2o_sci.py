"""The Li2O support-CI closure of the PyTorch port against the JAX package's
records and computations, on the CPU.

- The packaged data equal their sources bit for bit: Li2O's integrals
  (``data/li2o_sto3g.npz`` against ``mols/Li2O``), the selected-CI target
  (``runs/li2o_sci/target.npz``) and the three JAX states of the chain
  (``runs/li2o_sci/ckpt_4``, ``_13``, ``_26``, read with orbax).
- The anchors ``chip_smoke.py`` carries are the JAX package's float32
  values here, and the port's agree with them: ckpt_26's Rayleigh quotient
  over the target's top 8192 (2e-6 Ha), its ``support_ci.polish`` loss and
  mass over all 131,072 rows (1e-5 relative), and ckpt_13's loss of
  ``examples/li2o_sci_polish.py`` (1e-5 relative). The constants equal the
  JAX values to 2e-6 relative (float32 rounding of one machine's XLA).
- Each entry point's ``VMCConfig`` and ``AnqsConfig`` equal its JAX
  example's, and each runs a few iterations at a cut depth.
- ``cisd_pretrain_vmc``'s MADE has the JAX example's parameter shapes.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from anqs_quantum_chemistry_tpu.chem import fci as jfci
from anqs_quantum_chemistry_tpu.experiments import support_ci as jscp
from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_torch.chem import selected_ci as sci
from anqs_quantum_chemistry_torch.chem.molecule import (
    DATA_DIR,
    LI2O_STO3G,
    load_li2o,
)
from anqs_quantum_chemistry_torch.experiments import support_ci as scp
from anqs_quantum_chemistry_torch.experiments.li2o_sci_polish import (
    example_polish_loss,
)
from anqs_quantum_chemistry_torch.experiments.li2o_support_ci import (
    LI2O_SCI_TARGET,
    li2o_sci_params,
    li2o_sci_vmc,
    load_target,
)
from torch_port_common import ROOT, molecules, mol_path

CKPTS = (4, 13, 26)


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nested(flat):
    """Dotted names -> the JAX package's nested parameter dict."""
    out = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return out


def jax_params(ckpt):
    with np.load(os.path.join(DATA_DIR, f"li2o_sci_ckpt{ckpt}.npz")) as d:
        return nested(dict(d))


@pytest.fixture(scope="module")
def li2o():
    """(JAX Li2O molecule, JAX VMC of the examples' config, the port's VMC
    on the CPU, the target (dets, coef, e0))."""
    jmol, _ = molecules("Li2O")
    jv = jvmc.VMC(jmol, jvmc.VMCConfig(
        sample_num=16384, sampling_mode="gumbel", qubit_per_qudit=6, seed=0,
        engine_overrides={"prefilter_row_capacity": 768,
                          "prefilter_dense_rows": 4096}),
        JaxAnqsConfig(net_type="nade", hidden_widths=(128, 128),
                      aux_hidden_widths=(128, 128)))
    return jmol, jv, li2o_sci_vmc(device="cpu"), load_target()


def test_packaged_integrals_match_mols_file():
    """The spin-orbital integrals rebuilt from the packaged spatial form
    equal the ``mols/`` file's bit for bit."""
    mol = load_li2o()
    with np.load(LI2O_STO3G) as pkg, np.load(mol_path("Li2O")) as src:
        assert pkg["e_nuc"].dtype == src["e_nuc"].dtype
        assert pkg["e_nuc"] == src["e_nuc"]
        for key in ("h1", "v"):
            got = getattr(mol, key)
            assert got.dtype == src[key].dtype, key
            np.testing.assert_array_equal(got, src[key], err_msg=key)
    assert mol.h1.shape == (30, 30) and mol.v.shape == (30,) * 4


def test_packaged_target_matches_run():
    src = os.path.join(ROOT, "runs", "li2o_sci", "target.npz")
    with np.load(LI2O_SCI_TARGET) as pkg, np.load(src) as ref:
        assert sorted(pkg.files) == sorted(ref.files)
        for key in ref.files:
            assert pkg[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(pkg[key], ref[key], err_msg=key)
    td, tc, e0 = load_target()
    assert len(td) == 131_072 and td == sorted(td)
    assert abs(e0 - -88.705381) < 1e-6


@pytest.mark.parametrize("ckpt", CKPTS)
def test_packaged_checkpoint_matches_orbax(ckpt):
    """Every parameter of ``runs/li2o_sci/ckpt_<n>`` bit for bit, and the
    state dict loads into the support-CI trainer's ansatz."""
    tool = load_tool("export_jax_params")
    want = tool.flatten(tool.restore_params(
        os.path.join(ROOT, "runs", "li2o_sci", f"ckpt_{ckpt}")))
    with np.load(os.path.join(DATA_DIR, f"li2o_sci_ckpt{ckpt}.npz")) as d:
        assert sorted(d.files) == sorted(want)
        for key, value in want.items():
            assert d[key].dtype == value.dtype, key
            np.testing.assert_array_equal(d[key], value, err_msg=key)
    li2o_sci_vmc(device="cpu").anqs.load_state_dict(li2o_sci_params(ckpt))


def test_ckpt26_rayleigh_matches_jax(li2o):
    """ckpt_26 restricted to the target's top 8192: the port within 2e-6 Ha
    of the JAX package; the JAX value is ``chip_smoke``'s constant."""
    jmol, jv, v, (td, tc, _) = li2o
    d8, c8 = sci.truncate_by_weight(td, tc, chip_smoke.LI2O_SCI_TOP)
    v.anqs.load_state_dict(li2o_sci_params(26))
    e = scp.support_rayleigh(v.mol, scp.make_target(d8, c8, 30, "cpu"),
                             v.anqs)
    je = jscp.support_rayleigh(jmol, jscp.make_target(d8, c8, 30), jv.anqs,
                               jax_params(26))
    assert abs(je - chip_smoke.LI2O_SCI_CKPT26_RAYLEIGH) < 1e-8
    assert abs(e - je) < 2e-6


def test_ckpt26_support_vmc_rq_matches_jax(li2o):
    """``support_vmc``'s first exact rq of ckpt_26 over the top 8192 (the
    complex amplitudes): the port within 2e-6 Ha of the JAX package, whose
    value is ``chip_smoke``'s constant."""
    jmol, jv, v, (td, tc, _) = li2o
    d8, c8 = sci.truncate_by_weight(td, tc, chip_smoke.LI2O_SCI_TOP)
    h8 = jfci.sparse_hamiltonian(d8, jmol.h1, jmol.v)
    jrows, rows = [], []
    jscp.support_vmc(jv.anqs, jax_params(26), jscp.make_target(d8, c8, 30),
                     h8, jmol.e_nuc, lrs=(1e-4,), steps_per_stage=1,
                     chunk=8192, log_every=1, on_log=jrows.append)
    v.anqs.load_state_dict(li2o_sci_params(26))
    scp.support_vmc(v.anqs, scp.make_target(d8, c8, 30, "cpu"), h8,
                    jmol.e_nuc, lrs=(1e-4,), steps_per_stage=1, log_every=1,
                    on_log=rows.append)
    assert abs(jrows[0]["rq"] - chip_smoke.LI2O_SCI_CKPT26_RQ) < 1e-8
    assert abs(rows[0]["rq"] - jrows[0]["rq"]) < 2e-6
    assert abs(rows[0]["mass"] - jrows[0]["mass"]) < 1e-6


def test_ckpt26_polish_loss_matches_jax(li2o):
    """``support_ci.polish``'s loss and mass of ckpt_26 over the whole
    target (temperature 2, linear lam 30), as JAX's ``polish`` reports them
    after one step at lr 0: the port within 1e-5 relative."""
    jmol, jv, v, (td, tc, _) = li2o
    _, info = jscp.polish(jv.anqs, jax_params(26),
                          jscp.make_target(td, tc, 30), lrs=(0.0,), steps=1,
                          window=1, chunk=16384)
    np.testing.assert_allclose(info[0]["loss"],
                               chip_smoke.LI2O_SCI_CKPT26_LOSS, rtol=2e-6)
    np.testing.assert_allclose(info[0]["mass"],
                               chip_smoke.LI2O_SCI_CKPT26_MASS, rtol=2e-6)
    v.anqs.load_state_dict(li2o_sci_params(26))
    with torch.no_grad():
        loss, mass = scp.polish_loss(
            v.anqs, scp.make_target(td, tc, 30, "cpu"), 2.0, 30.0, "lin")
    np.testing.assert_allclose(float(loss), info[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(mass), info[0]["mass"], rtol=1e-5)


def test_ckpt13_example_loss_matches_jax(li2o):
    """The loss of ``examples/li2o_sci_polish.py`` (temperature 4,
    quadratic lam 1000, no clamps) of ckpt_13 over the whole target, the
    example's formula on the JAX package's ``log_psi`` in its chunks of
    16384: the port within 1e-5 relative."""
    jmol, jv, v, (td, tc, _) = li2o
    jt = jscp.make_target(td, tc, 30)
    p_t, words = jt["p"], jt["words"]
    la_t = 0.5 * jnp.log(jnp.maximum(p_t, 1e-38))
    w_l = p_t ** 0.25
    w_l = w_l / jnp.sum(w_l)
    prm = jax_params(13)
    s = [0.0] * 5
    for i in range(0, words.shape[0], 16384):
        sl = slice(i, i + 16384)
        la, ph = jax.jit(jv.anqs.log_psi)(prm, words[sl])
        dd, dph = la - la_t[sl], ph - jt["ph"][sl]
        parts = (jnp.sum(p_t[sl] * la), jnp.sum(w_l[sl] * dd),
                 jnp.sum(w_l[sl] * dd * dd), jnp.sum(w_l[sl] * dph * dph),
                 jnp.sum(jnp.exp(2.0 * la)))
        s = [a + b for a, b in zip(s, parts)]
    jloss = float(-2.0 * s[0] + s[2] - s[1] * s[1] + s[3]
                  + 1000.0 * (1.0 - s[4]) ** 2)
    np.testing.assert_allclose(jloss, chip_smoke.LI2O_SCI_CKPT13_LOSS,
                               rtol=2e-6)
    v.anqs.load_state_dict(li2o_sci_params(13))
    with torch.no_grad():
        loss = example_polish_loss(v.anqs, scp.make_target(td, tc, 30, "cpu"),
                                   4.0, 1000.0)[0]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)


class _Captured(Exception):
    pass


def example_configs(name, monkeypatch, argv=("example",)):
    """(VMCConfig, AnqsConfig) that JAX's ``examples/<name>.py`` builds,
    captured at its ``VMC(...)`` call."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class FakeMolecule:
        @staticmethod
        def create(*a, **k):
            return None

    def fake_vmc(mol, cfg, anqs_cfg, **kw):
        raise _Captured(cfg, anqs_cfg)

    monkeypatch.setattr(mod, "Molecule", FakeMolecule)
    monkeypatch.setattr(mod, "VMC", fake_vmc)
    monkeypatch.setattr("sys.argv", list(argv))
    with pytest.raises(_Captured) as got:
        mod.main()
    return got.value.args


def assert_config_in(port: dict, ref: dict, skip=()):
    """Every field of the port's config dict equals the JAX one's."""
    for key, value in port.items():
        if key in skip:
            continue
        assert key in ref, key
        if isinstance(value, dict):
            assert_config_in(value, ref[key])
        else:
            assert value == ref[key], (key, value, ref[key])


@pytest.mark.parametrize("entry", ["li2o_support_ci", "li2o_sci_polish",
                                   "li2o_pin_vmc"])
def test_entry_point_configs_match_jax(entry, monkeypatch):
    from anqs_quantum_chemistry_torch.experiments import li2o_pin_vmc
    from anqs_quantum_chemistry_torch.experiments.vmc import LI2O_NADE

    jcfg, janqs = example_configs(entry, monkeypatch)
    if entry == "li2o_pin_vmc":
        cfg = li2o_pin_vmc.li2o_pin_vmc(device="cpu").config
        assert cfg.couple_support_file == LI2O_SCI_TARGET
        assert os.path.basename(jcfg.couple_support_file) == "target.npz"
    else:
        cfg = li2o_sci_vmc(device="cpu").config
    assert_config_in(cfg.to_dict(), jcfg.to_dict(),
                     skip=("couple_support_file",))
    assert_config_in(vars(LI2O_NADE), vars(janqs))


def test_entry_points_run(tmp_path, capsys):
    """The three entry points on the CPU at a cut depth: distillation (2
    steps a stage, full energies of 16 determinants), the polish (the
    target's top 600, 2 steps a stage, from distillation's newest
    checkpoint) and the pinned VMC (2 iterations, 16 samples, 16 pinned
    determinants, from the packaged ckpt_13)."""
    from anqs_quantum_chemistry_torch.experiments import (
        li2o_pin_vmc,
        li2o_sci_polish,
        li2o_support_ci,
    )

    root = str(tmp_path)
    res = li2o_support_ci.main(["x", "2"], device="cpu", run_root=root,
                               full_samples=16)
    out = capsys.readouterr().out
    assert "warm start from the packaged JAX closure state" in out
    assert "target: |S|=131072" in out
    assert [r["stage"] for r in res["stages"]] == [0, 1, 2, 3]
    assert all(-89.0 < r["full_e"] < -88.0 for r in res["stages"])
    res = li2o_sci_polish.main(["x", "2", "4", "0"], device="cpu",
                               run_root=root, full_samples=16, target_k=600)
    out = capsys.readouterr().out
    assert "resuming from" in out and "ckpt_4" in out
    assert len(res["stages"]) == 4
    for r in res["stages"]:
        assert np.isfinite(r["loss"]) and r["loss"] <= r["first_loss"]
        assert -89.0 < r["support_rayleigh"] < -88.0
    assert os.path.isdir(os.path.join(root, "li2o_sci_torch", "ckpt_13"))
    history, _ = li2o_pin_vmc.main(["x", "2"], device="cpu", run_root=root,
                                   sample_num=16, couple_support_k=16)
    assert "warm start from the packaged JAX state ckpt_13" in (
        capsys.readouterr().out)
    assert len(history) == 2
    for row in history:
        assert 16 < row["unique_num"] <= 32
        assert -88.75 < row["energy"] < -88.6


def test_cisd_made_matches_jax_example():
    """``cisd_pretrain_vmc``'s MADE for C2H4 (qubit_per_qudit 4): the
    parameter shapes of the JAX example's ansatz
    (``AnqsConfig(hidden_widths=(2048,))``, a (512,) phase net), and of its
    checkpoint ``runs/c2h4_cisd_made/ckpt_4000``."""
    import orbax.checkpoint as ocp

    from anqs_quantum_chemistry_torch.experiments.cisd_pretrain_vmc import (
        NETS,
    )
    from anqs_quantum_chemistry_torch.experiments.preparation import (
        create_masker,
    )
    from anqs_quantum_chemistry_torch.models.anqs import ANQS
    from anqs_quantum_chemistry_torch.symmetries import QubitGrouping
    from anqs_quantum_chemistry_tpu.experiments.preparation import (
        create_masker as jax_create_masker,
    )
    from anqs_quantum_chemistry_tpu.models.anqs import ANQS as JaxANQS
    from anqs_quantum_chemistry_tpu.symmetries import QubitGrouping as JG

    jmol, mol = molecules("C2H4")
    anqs = ANQS(QubitGrouping.create(create_masker(mol, "e_num_spin"), 4),
                NETS["made"])
    shapes = {k: tuple(v.shape) for k, v in anqs.named_parameters()}
    jax_anqs = JaxANQS(JG.create(jax_create_masker(jmol, "e_num_spin"), 4),
                       JaxAnqsConfig(hidden_widths=(2048,)))
    want = {jax.tree_util.keystr(k, simple=True, separator="."):
            tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(jax_anqs.init, jax.random.PRNGKey(0)))[0]}
    assert shapes == want
    tree = ocp.PyTreeCheckpointer().metadata(os.path.join(
        ROOT, "runs", "c2h4_cisd_made", "ckpt_4000")).item_metadata.tree
    saved = {jax.tree_util.keystr(k, simple=True, separator="."):
             tuple(v.shape) for k, v in
             jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    assert shapes == saved
    assert shapes["aux.w0"] == (52, 512)
