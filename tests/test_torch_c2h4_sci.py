"""The C2H4/6-31G CISD -> support-CI chain of the PyTorch port against the
JAX package's records, computations and examples, on the CPU.

- The packaged data equal their sources bit for bit: the selected-CI target
  (``runs/c2h4_sci/target.npz``), the CISD vector
  (``runs/c2h4_cisd_vector.npz``) and the three JAX states (ckpt_4000 of
  the CISD-pretrained MADE-2048, ckpt_47 of the closure, ckpt_3000 of the
  transformer; read with orbax); the transformer anchor that
  ``chip_smoke.py`` reads is the JAX ansatz's output.
- ``log_psi`` of each state over the target's top 256 equals the JAX
  package's: log|psi| to 1e-5 + 1e-5 |la|; the phase to 1e-5 + 1e-5 |ph|
  (MADE), to 1e-4 (the transformer's, a float32 sum of 13 terms that
  reaches 78).
- ckpt_47's restricted Rayleigh quotient over the target's top 1024 (1e-6
  Ha) and its ``polish`` loss and mass over the top 4096 (1e-5 relative)
  equal JAX's; the JAX values that ``chip_smoke.py`` carries are
  recomputed here at their full size (1e-8 Ha, 2e-6 relative).
- The entry points' configurations equal the examples' field for field:
  ``cisd_pretrain_vmc``'s branches (VMCConfig, AnqsConfig, run directory),
  ``c2h4_support_ci``'s and ``c2h4_support_transformer``'s trainer and
  every stage table and literal argument of their optimiser calls (read
  from the examples' source).
- ``cisd_pretrain_vmc``'s C2H4 branch runs on the CPU at a cut depth; the
  support-CI entry points' command dispatch runs in
  ``test_torch_c2h4_sci_entry.py``.
"""

import ast
import importlib.util
import inspect
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from anqs_quantum_chemistry_tpu.chem import selected_ci as jsci
from anqs_quantum_chemistry_tpu.experiments import support_ci as jscp
from anqs_quantum_chemistry_tpu.experiments import vmc as jvmc
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_torch.chem import selected_ci as sci
from anqs_quantum_chemistry_torch.chem.molecule import DATA_DIR
from anqs_quantum_chemistry_torch.convert import load_params_npz
from anqs_quantum_chemistry_torch.experiments import c2h4_support_ci as c2sci
from anqs_quantum_chemistry_torch.experiments import (
    c2h4_support_transformer as c2tr,
)
from anqs_quantum_chemistry_torch.experiments import cisd_pretrain_vmc as cpv
from anqs_quantum_chemistry_torch.experiments import support_ci as scp
from anqs_quantum_chemistry_torch.experiments.li2o_support_ci import (
    load_target,
)
from anqs_quantum_chemistry_torch.experiments.vmc import VMCConfig
from torch_port_common import ROOT, molecules

RUNS = os.path.join(ROOT, "runs")
STATES = {  # packaged npz -> (JAX checkpoint, net, JAX matmul precision)
    "c2h4_cisd_made_ckpt4000.npz": ("c2h4_cisd_made/ckpt_4000", "made",
                                    None),
    "c2h4_sci_ckpt47.npz": ("c2h4_sci/ckpt_47", "made", "highest"),
    "c2h4_cisd_transformer_ckpt3000.npz": (
        "c2h4_cisd_transformer_emp_lr0.0001/ckpt_3000", "transformer",
        "highest"),
}


def load_module(*path):
    name = os.path.splitext(path[-1])[0]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nested(flat):
    out = {}
    for name, value in flat.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return out


def jax_params(npz):
    with np.load(os.path.join(DATA_DIR, npz)) as d:
        return nested(dict(d))


@pytest.fixture(scope="module")
def c2h4():
    """(JAX molecule, the packaged target (dets, coef, e0))."""
    jmol, _ = molecules("C2H4")
    return jmol, load_target(c2sci.C2H4_SCI_TARGET)


ANQS_FIELDS = ("net_type", "hidden_widths", "aux_hidden_widths", "logit_cap",
               "matmul_precision", "d_model", "n_heads", "n_layers", "d_ff")


def jax_vmc(jmol, net, precision):
    """The JAX trainer of the closure's settings with ``cisd_pretrain_vmc``'s
    ``net`` at ``precision``."""
    fields = {f: getattr(cpv.NETS[net], f) for f in ANQS_FIELDS}
    return jvmc.VMC(jmol, jvmc.VMCConfig(
        sample_num=8192, qubit_per_qudit=4, seed=0,
        engine_overrides={"prefilter_row_capacity": 768,
                          "prefilter_dense_rows": 4096}),
        JaxAnqsConfig(**{**fields, "matmul_precision": precision}))


# ----------------------------------------------------------------------
# Packaged data
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pkg, src", [
    ("c2h4_sci_target.npz", "c2h4_sci/target.npz"),
    ("c2h4_cisd_vector.npz", "c2h4_cisd_vector.npz"),
])
def test_packaged_vectors_match_runs(pkg, src):
    with np.load(os.path.join(DATA_DIR, pkg)) as got, np.load(
            os.path.join(RUNS, src)) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for key in ref.files:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    if pkg == "c2h4_sci_target.npz":
        td, _, e0 = load_target(os.path.join(DATA_DIR, pkg))
        assert len(td) == 262_144 and td == sorted(td)
        assert abs(e0 - -78.2159466927) < 1e-9


@pytest.mark.parametrize("npz", list(STATES))
def test_packaged_state_matches_orbax(npz):
    tool = load_module("tools", "export_jax_params.py")
    want = tool.flatten(tool.restore_params(os.path.join(RUNS,
                                                         STATES[npz][0])))
    with np.load(os.path.join(DATA_DIR, npz)) as d:
        assert sorted(d.files) == sorted(want)
        for key, value in want.items():
            assert d[key].dtype == value.dtype, key
            np.testing.assert_array_equal(d[key], value, err_msg=key)
    assert (os.path.join(DATA_DIR, npz) in (
        c2sci.WARM_STATE, c2sci.BEST_STATE, c2tr.WARM_STATE))


def test_transformer_anchor_is_jax():
    """``data/c2h4_transformer_logpsi.npz`` (``chip_smoke.py``'s anchor) is
    ``tools/export_jax_params.py --anchor``'s output."""
    tool = load_module("tools", "export_jax_params.py")
    want = tool.c2h4_transformer_anchor()
    with np.load(tool.ANCHOR) as d:
        for key in ("log_abs", "phase"):
            assert d[key].shape == (tool.ANCHOR_ROWS,)
            np.testing.assert_allclose(d[key], want[key], rtol=0, atol=1e-6)


@pytest.mark.parametrize("npz", list(STATES))
def test_log_psi_matches_jax(npz, c2h4):
    jmol, (td, tc, _) = c2h4
    _, net, precision = STATES[npz]
    jv = jax_vmc(jmol, net, precision)
    vmc = (c2tr.c2h4_sci_tr_vmc(device="cpu") if net == "transformer"
           else c2sci.c2h4_sci_vmc(device="cpu", precision=precision))
    vmc.anqs.load_state_dict(load_params_npz(os.path.join(DATA_DIR, npz)))
    d, _ = sci.truncate_by_weight(td, tc, 256)
    words = scp.make_target(d, np.ones(len(d)), 52, "cpu")["words"]
    jla, jph = jv.anqs.log_psi(jax_params(npz),
                               jnp.asarray(words.numpy(), jnp.uint32))
    with torch.no_grad():
        la, ph = vmc.anqs.log_psi(words)
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=1e-5,
                               atol=1e-5)
    if net == "transformer":
        np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=0,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------------
# ckpt_47 against the JAX package
# ----------------------------------------------------------------------
def test_ckpt47_rayleigh_top1024_matches_jax(c2h4):
    jmol, (td, tc, _) = c2h4
    d, c = sci.truncate_by_weight(td, tc, 1024)
    jv = jax_vmc(jmol, "made", "highest")
    je = jscp.support_rayleigh(jmol, jscp.make_target(d, c, 52), jv.anqs,
                               jax_params("c2h4_sci_ckpt47.npz"))
    vmc = c2sci.c2h4_sci_vmc(device="cpu", precision="highest")
    vmc.anqs.load_state_dict(load_params_npz(c2sci.BEST_STATE))
    e = scp.support_rayleigh(vmc.mol, scp.make_target(d, c, 52, "cpu"),
                             vmc.anqs)
    assert -78.22 < je < -78.0
    assert abs(e - je) < 1e-6


def test_ckpt47_polish_top4096_matches_jax(c2h4):
    """The example's polish (temperature 4, linear lam 30) loss and mass of
    ckpt_47 over the target's top 4096, as JAX's ``polish`` reports them
    after one step at lr 0: 1e-5 relative."""
    jmol, (td, tc, _) = c2h4
    d, c = sci.truncate_by_weight(td, tc, 4096)
    jv = jax_vmc(jmol, "made", "highest")
    _, info = jscp.polish(jv.anqs, jax_params("c2h4_sci_ckpt47.npz"),
                          jscp.make_target(d, c, 52), temp=4.0, lam=30.0,
                          kind="lin", lrs=(0.0,), steps=1, window=1,
                          chunk=4096)
    vmc = c2sci.c2h4_sci_vmc(device="cpu", precision="highest")
    vmc.anqs.load_state_dict(load_params_npz(c2sci.BEST_STATE))
    with torch.no_grad():
        loss, mass = scp.polish_loss(vmc.anqs,
                                     scp.make_target(d, c, 52, "cpu"), 4.0,
                                     30.0, "lin")
    np.testing.assert_allclose(float(loss), info[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(mass), info[0]["mass"], rtol=1e-5)


def test_chip_smoke_constants_are_jax(c2h4):
    """The JAX values ``chip_smoke.py`` holds the card to, at their full
    size: the top-4096 CISD E0, ckpt_47's quotient over the target's top
    8192 and its polish loss and mass over all 262,144 rows."""
    jmol, (td, tc, _) = c2h4
    with np.load(c2sci.C2H4_CISD_VECTOR) as v:
        d4, _ = jsci.truncate_by_weight([int(x) for x in v["dets"]],
                                        v["coef"], chip_smoke.C2H4_CISD_TOP)
    e4, _ = jsci.restricted_ground_state(d4, jmol.h1, jmol.v, jmol.e_nuc)
    assert abs(e4 - chip_smoke.C2H4_CISD_TOP_E0) < 1e-8
    jv = jax_vmc(jmol, "made", "highest")
    prm = jax_params("c2h4_sci_ckpt47.npz")
    d8, c8 = jsci.truncate_by_weight(td, tc, chip_smoke.C2H4_SCI_TOP)
    rq = jscp.support_rayleigh(jmol, jscp.make_target(d8, c8, 52), jv.anqs,
                               prm)
    assert abs(rq - chip_smoke.C2H4_SCI_CKPT47_RAYLEIGH) < 1e-8
    _, info = jscp.polish(jv.anqs, prm, jscp.make_target(td, tc, 52),
                          temp=4.0, lam=30.0, kind="lin", lrs=(0.0,),
                          steps=1, window=1, chunk=8192)
    np.testing.assert_allclose(info[0]["loss"],
                               chip_smoke.C2H4_SCI_CKPT47_LOSS, rtol=2e-6)
    np.testing.assert_allclose(info[0]["mass"],
                               chip_smoke.C2H4_SCI_CKPT47_MASS, rtol=2e-6)


# ----------------------------------------------------------------------
# The entry points' configurations against the examples
# ----------------------------------------------------------------------
class _Captured(Exception):
    pass


def fake_molecule():
    """What the examples read of a molecule before they build their VMC."""
    return types.SimpleNamespace(
        hf_energy=-78.0, ccsd_t_energy=-78.2, cisd_energy=-78.19, e_nuc=0.0,
        qubit_num=52, hf_det=np.array([0], np.uint64),
        qubit_ham=types.SimpleNamespace(n_groups=20776))


def capture_example_vmc(monkeypatch, argv):
    """(VMCConfig, AnqsConfig, run_dir) that ``examples/
    cisd_pretrain_vmc.py`` builds for ``argv``."""
    mod = load_module("examples", "cisd_pretrain_vmc.py")

    class FakeMolecule:
        @staticmethod
        def create(*a, **k):
            return fake_molecule()

    def fake_vmc(mol, cfg, anqs_cfg, run_dir=None, **kw):
        raise _Captured(cfg, anqs_cfg, run_dir)

    monkeypatch.chdir(ROOT)  # its CISD cache runs/c2h4_cisd_vector.npz
    monkeypatch.setattr(mod, "Molecule", FakeMolecule)
    monkeypatch.setattr(mod, "VMC", fake_vmc)
    monkeypatch.setattr("sys.argv", ["example", *argv])
    with pytest.raises(_Captured) as got:
        mod.main()
    return got.value.args


def assert_config_in(port: dict, ref: dict, skip=()):
    for key, value in port.items():
        if key in skip:
            continue
        assert key in ref, key
        if isinstance(value, dict):
            assert_config_in(value, ref[key])
        elif isinstance(value, (tuple, list)):
            assert ref[key] is not None and (
                list(map(list, value)) if value and isinstance(
                    value[0], (tuple, list)) else list(value)) == (
                list(map(list, ref[key])) if ref[key] and isinstance(
                    ref[key][0], (tuple, list)) else list(ref[key])), key
        else:
            assert value == ref[key], (key, value, ref[key])


@pytest.mark.parametrize("net, theor, lr", [
    ("made", "1", None), ("transformer", "0", "1e-4"),
    ("transformer", "1", None), ("nade", "1", None), ("made", "0", "3e-5"),
])
def test_cisd_pretrain_vmc_configs_match_example(net, theor, lr,
                                                 monkeypatch):
    argv = ["C2H4", "6-31g", "4000", "8192", net, "4", theor, "1"] + (
        [lr] if lr else [])
    jcfg, janqs, jrun = capture_example_vmc(monkeypatch, argv)
    lr_f = float(lr) if lr else None
    cfg = cpv.vmc_config(types.SimpleNamespace(**vars(fake_molecule())),
                         net, 8192, 4, 4000, theor == "1", 1.0, lr_f)
    assert_config_in(cfg.to_dict(), jcfg.to_dict())
    for field in ANQS_FIELDS:
        assert getattr(cpv.NETS[net], field) == getattr(janqs, field), field
    assert cpv.run_name("c2h4", net, theor == "1", 1.0, lr_f) == (
        os.path.basename(jrun) + "_torch")
    assert cfg.full_energy_period is None  # 8192 x 20776 >= 2^27


def example_source(name):
    with open(os.path.join(ROOT, "examples", name)) as f:
        return ast.parse(f.read())


def literal_calls(tree, func):
    """Literal keyword arguments of each call of ``*.func(...)``/``func(...)``
    in ``tree``, in source order."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name == func:
                kw = {}
                for k in node.keywords:
                    try:
                        kw[k.arg] = ast.literal_eval(k.value)
                    except ValueError:
                        pass
                out.append((node.lineno, kw))
    return [kw for _, kw in sorted(out, key=lambda x: x[0])]


def literal_assigns(tree):
    """{name: value} of the literal assignments and of ``name = <int> +
    ...`` (the stage bases) in ``tree``."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name):
            value = node.value
            if isinstance(value, ast.BinOp) and isinstance(value.left,
                                                           ast.Constant):
                value = value.left
            try:
                out[node.targets[0].id] = ast.literal_eval(value)
            except ValueError:
                pass
    return out


def env_defaults(tree):
    """{variable: default} of ``os.environ.get("ANQS_...", "<default>")``."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and len(node.args) == 2
                and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith("ANQS_")):
            out[node.args[0].value] = node.args[1].value
    return out


def assert_subset(port: dict, ref: dict, skip=()):
    for key, value in port.items():
        if key in skip:
            continue
        assert key in ref, key
        assert value == ref[key], (key, value, ref[key])


def test_c2h4_support_ci_tables_match_example(monkeypatch):
    tree = example_source("c2h4_support_ci.py")
    names = literal_assigns(tree)
    assert c2sci.ROUNDS == names["ROUNDS"]
    assert c2sci.ROUND_TOL == names["ROUND_TOL"]
    assert c2sci.DISTILL_STAGES == names["stages"]
    for wave in ("rq", "rql", "refit", "repair"):
        assert c2sci.STAGE_BASE[wave] == names[f"{wave}_base"], wave
    (pretrain_kw,) = literal_calls(tree, "pretrain")
    assert pretrain_kw["batch"] == 8192
    (polish_kw,) = literal_calls(tree, "polish")
    assert_subset(c2sci.POLISH, polish_kw)
    rq, refit, repair_refit, repair_rq = literal_calls(tree, "support_vmc")
    assert_subset(c2sci.RQ, rq)
    assert_subset(c2sci.REFIT, refit, skip=("steps_per_stage",))
    assert_subset({k: v for k, v in c2sci.REFIT.items()
                   if k != "steps_per_stage"}, repair_refit)
    assert repair_refit["select"] == "loss"
    assert_subset(c2sci.REPAIR_RQ, repair_rq)
    (rql,) = literal_calls(tree, "support_vmc_lbfgs")
    assert_subset(c2sci.RQL, rql, skip=("maxiter",))
    (full,) = literal_calls(tree, "sampled_full_energy")
    assert full == {"sample_num": c2sci.FULL_ENERGY_SAMPLES,
                    "row_chunk": c2sci.ROW_CHUNK}
    env = env_defaults(tree)
    sig = inspect.signature(c2sci.main).parameters
    assert sig["refit_beta"].default == float(env["ANQS_REFIT_BETA"])
    assert sig["refit_clip"].default == float(env["ANQS_REFIT_CLIP"])
    assert sig["refit_lrs"].default == (float(env["ANQS_REFIT_LRS"]),)
    assert sig["repair_lr"].default == float(env["ANQS_REFIT_LR"])
    # The trainer: JAX's make_vmc.
    mod = load_module("examples", "c2h4_support_ci.py")

    def fake_vmc(mol, cfg, anqs_cfg, **kw):
        raise _Captured(cfg, anqs_cfg)

    monkeypatch.setattr(mod, "VMC", fake_vmc)
    for precision in (None, "highest"):
        with pytest.raises(_Captured) as got:
            mod.make_vmc(None, precision=precision)
        jcfg, janqs = got.value.args
        assert_config_in(VMCConfig(**c2sci.SCI_VMC_CONFIG).to_dict(),
                         jcfg.to_dict())
        want = c2sci.C2H4_MADE.__class__(**{
            **vars(c2sci.C2H4_MADE), "matmul_precision": precision})
        for field in ANQS_FIELDS:
            assert getattr(want, field) == getattr(janqs, field), field
    assert set(c2sci.HIGHEST_CMDS) == {"rq", "rql", "refit", "repair",
                                       "confirm"}


def test_c2h4_support_transformer_tables_match_example(monkeypatch):
    tree = example_source("c2h4_support_transformer.py")
    refit, rq = literal_calls(tree, "support_vmc")
    assert_subset(c2tr.REFIT, refit, skip=("steps_per_stage",))
    assert_subset(c2tr.RQ, rq, skip=("steps_per_stage",))
    (rql,) = literal_calls(tree, "support_vmc_lbfgs")
    assert_subset(c2tr.TR_RQL, rql, skip=("maxiter",))
    assert env_defaults(tree)["ANQS_TR_ROW_CHUNK"] == str(c2tr.ROW_CHUNK)
    for node in ast.walk(tree):  # base = {"refit": 60, "rq": 20, ...}[cmd]
        if isinstance(node, ast.Subscript) and isinstance(node.value,
                                                          ast.Dict):
            bases = ast.literal_eval(node.value)
    assert bases == {k: c2sci.STAGE_BASE[k] for k in bases}
    mod = load_module("examples", "c2h4_support_transformer.py")

    def fake_vmc(mol, cfg, anqs_cfg, **kw):
        raise _Captured(cfg, anqs_cfg)

    monkeypatch.setattr(mod, "VMC", fake_vmc)
    with pytest.raises(_Captured) as got:
        mod.make_vmc(None)
    jcfg, janqs = got.value.args
    assert_config_in(VMCConfig(**c2sci.SCI_VMC_CONFIG).to_dict(),
                     jcfg.to_dict())
    for field in ANQS_FIELDS:
        assert getattr(cpv.NETS["transformer"], field) == getattr(
            janqs, field), field
    assert os.path.basename(mod.WARM) == "ckpt_3000"


# ----------------------------------------------------------------------
# The entry points on the CPU at a cut depth (the two support-CI command
# tests are in test_torch_c2h4_sci_entry.py)
# ----------------------------------------------------------------------
def test_cisd_pretrain_vmc_c2h4_runs(tmp_path, capsys):
    """The C2H4 transformer branch from a cached CISD vector (the JAX
    one, where a first run would have written its own): pretraining, one
    VMC iteration; then the LR-probe variant starts from its ``ckpt_0``."""
    root = tmp_path
    os.symlink(c2sci.C2H4_CISD_VECTOR, root / "c2h4_cisd_vector.npz")
    argv = ["x", "c2h4", "1", "16", "transformer", "4", "0", "1"]
    history, _ = cpv.main(argv, device="cpu", run_root=str(root),
                          stages=((1, 1e-4),))
    out = capsys.readouterr().out
    assert "CISD: 29593 dets, E -78.197997 (90.2% of corr)" in out
    assert len(history) == 1 and np.isfinite(history[0]["energy"])
    assert (root / "c2h4_cisd_transformer_emp_torch" / "ckpt_0").is_dir()
    history, _ = cpv.main(argv + ["1e-4", "1"], device="cpu",
                          run_root=str(root))
    out = capsys.readouterr().out
    assert "warm start copied from" in out and "  pretrain " not in out
    assert (root / "c2h4_cisd_transformer_emp_lr0.0001_torch"
            / "ckpt_0").is_dir()
    assert len(history) == 1
