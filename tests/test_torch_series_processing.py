"""The run-series and result-processing tools of the PyTorch port against
the JAX package: ``run_series`` directory names against JAX's signature of
the same entries, which they equal, and its skip of finished entries; ``processing`` on JAX's
``tests/test_processing.py`` tree (a gzip run included) and on run
directories that the port's ``run()`` wrote, row by row against JAX's
DataFrames; ``summarize_runs``; and the walkthrough's LiH built from atoms
against the JAX package's molecule."""

import dataclasses
import gzip
import hashlib
import json
import math
import os

import numpy as np
import pytest

from anqs_quantum_chemistry_tpu.chem.molecule import MolConfig as JaxMolConfig
from anqs_quantum_chemistry_tpu.chem.molecule import Molecule as JaxMolecule
from anqs_quantum_chemistry_tpu.experiments import processing as jproc
from anqs_quantum_chemistry_tpu.experiments.vmc import (
    VMCConfig as JaxVMCConfig,
)
from anqs_quantum_chemistry_tpu.models.anqs import AnqsConfig as JaxAnqsConfig
from anqs_quantum_chemistry_tpu.optim.sr import SRConfig as JaxSRConfig
from anqs_quantum_chemistry_torch.chem.molecule import (
    Molecule,
    MolConfig,
    load_li2o,
)
from anqs_quantum_chemistry_torch.experiments import processing as proc
from anqs_quantum_chemistry_torch.experiments import (
    li2o_toy_model,
    series,
    summarize_runs,
    toy_model_walkthrough,
)
from anqs_quantum_chemistry_torch.experiments.vmc import VMC, VMCConfig
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig
from anqs_quantum_chemistry_torch.optim.sr import SRConfig
from torch_port_common import MOLS

SERIES_ITERS = 3
ENERGIES = ("hf_energy", "mp2_energy", "cisd_energy", "ccsd_t_energy",
            "fci_energy")


def _same(a, b):
    """Equal, or both missing (None or NaN). Numbers agree to 1e-12
    relative: pandas' default CSV parser is not correctly rounded (it reads
    0.30000000000000004 as 0.3; on 17-digit values between 1e-3 and 10 it
    is up to 9.9e-13 relative off), and the port's ``float()`` is."""
    def missing(v):
        return v is None or (isinstance(v, float) and math.isnan(v))

    if missing(a) or missing(b):
        return missing(a) and missing(b)
    if isinstance(a, str) or isinstance(b, str):
        return str(a) == str(b)
    a, b = float(a), float(b)
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def _entries(mol, jax=False):
    """Two LiH entries that differ by seed, in either package's configs."""
    vmc_cfg, anqs_cfg, sr_cfg = ((JaxVMCConfig, JaxAnqsConfig, JaxSRConfig)
                                 if jax else (VMCConfig, AnqsConfig,
                                              SRConfig))
    return [(mol,
             vmc_cfg(sample_num=64, qubit_per_qudit=3, lr=1e-2, seed=seed,
                     sr=sr_cfg(max_indices_num=8)),
             anqs_cfg(hidden_widths=(16,), aux_hidden_widths=(16,)))
            for seed in (0, 1)]


def _jax_signature(mol_config, cfg, acfg):
    return [cfg.to_dict(), dataclasses.asdict(acfg), mol_config.to_dict()]


@pytest.fixture(scope="module")
def series_root(tmp_path_factory):
    """Two LiH entries run by ``run_series`` for 3 iterations each on the
    CPU, and what the call returned."""
    root = str(tmp_path_factory.mktemp("series"))
    mol = Molecule.create(MolConfig(name="LiH"), mols_dir=MOLS,
                          device="cpu")
    entries = _entries(mol)
    seen = []
    results = series.run_series(
        entries, root, iter_num=SERIES_ITERS, device="cpu",
        on_result=lambda d, best: seen.append(d))
    return root, entries, results, seen


def test_run_series_names_against_jax(series_root):
    root, entries, results, seen = series_root
    jax_entries = _entries(None, jax=True)
    for (mol, cfg, acfg), (_, jcfg, jacfg), (run_dir, best) in zip(
            entries, jax_entries, results):
        port_sig = json.loads(series.entry_signature(mol, cfg, acfg))
        assert os.path.basename(run_dir) == hashlib.sha256(
            json.dumps(port_sig, sort_keys=True).encode()).hexdigest()[:16]
        jax_sig = json.loads(json.dumps(_jax_signature(
            JaxMolConfig(name="LiH"), jcfg, jacfg), sort_keys=True,
            default=str))
        assert port_sig == jax_sig
        assert best["skipped"] is False
    assert seen == [d for d, _ in results]
    assert len({d for d, _ in results}) == 2


def test_run_series_skips_finished(series_root):
    root, entries, results, _ = series_root
    again = series.run_series(entries, root, iter_num=SERIES_ITERS,
                              device="cpu")
    assert [d for d, _ in again] == [d for d, _ in results]
    for (run_dir, best), (_, first) in zip(again, results):
        assert best["skipped"] is True
        assert best["energy"] == pytest.approx(first["energy"], abs=0)
        assert best["iter"] == first["iter"]
        with open(os.path.join(run_dir, "FINISHED")) as f:
            assert f.read() == "done\n"
        e, it = np.load(os.path.join(run_dir, "best_energy.npy"))
        table = proc.read_table(os.path.join(run_dir, "result.csv"))
        assert len(table["energy"]) == SERIES_ITERS
        assert e == np.float64(np.float32(table["energy"].min()))
        assert int(it) == int(np.argmin(table["energy"]))


def test_harvest_port_runs_against_jax(series_root, capsys):
    """Both packages' ``harvest`` over the directories the port's ``run()``
    wrote, and ``summarize_runs`` over them."""
    root = series_root[0]
    rows = proc.harvest(root)
    jdf = jproc.harvest(root)
    assert len(rows) == len(jdf) == 2
    for row, (_, jrow) in zip(rows, jdf.iterrows()):
        assert row["iters"] == SERIES_ITERS
        assert row["cfg.seed"] in (0, 1)
        for col in jdf.columns:
            assert _same(row.get(col), jrow[col]), col
    summarize_runs.main(["summarize_runs", root])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, row in zip(lines, rows):
        assert line.startswith(f"{row['run_dir']}: {SERIES_ITERS} iters, "
                               f"best E {row['best_energy']:.6f}, ")


def _make_run(root, name, seed, lr, energies, gz=False):
    """JAX ``tests/test_processing.py``'s synthetic run."""
    d = os.path.join(root, name)
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"seed": seed, "lr": lr, "sample_num": 64}, f)
    lines = ["energy,full_energy,iter_idx,wall_time"]
    for i, e in enumerate(energies):
        fe = e - 1e-4 if i == len(energies) - 1 else float("nan")
        lines.append(f"{e},{fe},{i},{0.1 * (i + 1)}")
    payload = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(os.path.join(d, "result.csv.gz"), "wt") as f:
            f.write(payload)
    else:
        with open(os.path.join(d, "result.csv"), "w") as f:
            f.write(payload)
    return d


@pytest.fixture
def tree(tmp_path):
    root = str(tmp_path)
    _make_run(root, "a_s0", 0, 1e-3, [-1.0, -1.2, -1.3])
    _make_run(root, "a_s1", 1, 1e-3, [-1.0, -1.25, -1.28], gz=True)
    d = _make_run(root, "b_s0", 0, 3e-3, [-1.0, -1.1, -1.15])
    with open(os.path.join(d, "full_energy_revalidation.json"), "w") as f:
        json.dump({"full_energy_f64": -1.149, "gap_to_fci_mHa": 2.0}, f)
    return root


def test_load_results_matches_jax(tree):
    table = proc.load_results(tree)
    jdf = jproc.load_results(tree)
    assert list(table) == list(jdf.columns)
    for col in jdf.columns:
        want = jdf[col].to_numpy()
        if col == "run_dir":
            assert table[col].tolist() == want.tolist()
        else:
            assert all(_same(a, b) for a, b in zip(
                table[col].tolist(), want.astype(float).tolist())), col


def test_harvest_matches_jax(tree):
    rows = proc.harvest(tree)
    jdf = jproc.harvest(tree)
    assert len(rows) == len(jdf) == 3
    for row, (_, jrow) in zip(rows, jdf.iterrows()):
        for col in jdf.columns:
            assert _same(row.get(col), jrow[col]), (row["run_dir"], col)
        assert set(row) <= set(jdf.columns)


def test_aggregate_seeds_matches_jax(tree):
    agg = proc.aggregate_seeds(proc.harvest(tree))
    jagg = jproc.aggregate_seeds(jproc.harvest(tree))
    assert len(agg) == len(jagg) == 2
    for row, (_, jrow) in zip(agg, jagg.iterrows()):
        assert list(row) == list(jagg.columns)
        for col in jagg.columns:
            assert _same(row[col], jrow[col]) or math.isclose(
                row[col], jrow[col], rel_tol=1e-15), col
    keyed = proc.aggregate_seeds(proc.harvest(tree), ["cfg.lr"])
    jkeyed = jproc.aggregate_seeds(jproc.harvest(tree), ["cfg.lr"])
    assert [r["n_seeds"] for r in keyed] == jkeyed["n_seeds"].tolist()


@pytest.mark.parametrize("fci", [-1.3005, -1.2, -1.0, -2.0])
def test_time_to_chemical_accuracy_matches_jax(tree, fci):
    runs = proc.by_run(proc.load_results(tree))
    jdf = jproc.load_results(tree)
    for run_dir, sub in runs.items():
        want = jproc.time_to_chemical_accuracy(
            jdf[jdf.run_dir == run_dir], fci_energy=fci)
        assert _same(proc.time_to_chemical_accuracy(sub, fci), want)
    one = runs[os.path.join(tree, "a_s0")]
    if fci == -1.3005:
        assert proc.time_to_chemical_accuracy(one, fci) == 0.1 * 3


def test_plots(tree, tmp_path):
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            proc.plot_energy_vs_reference(proc.load_results(tree), -1.3)
        return
    out = str(tmp_path / "energy.png")
    proc.plot_energy_vs_reference(proc.load_results(tree), -1.3005,
                                  hf_energy=-1.0, out_path=out)
    assert os.path.getsize(out) > 0
    csv_path = str(tmp_path / "curve.csv")
    with open(csv_path, "w") as f:
        f.write("r_angstrom,hf,cisd,fci,vmc\n1.0,-1.0,-1.1,-1.2,-1.19\n"
                "1.5,-0.9,-1.0,-1.1,-1.09\n")
    curve = str(tmp_path / "curve.png")
    proc.plot_dissociation_curve(csv_path, out_path=curve)
    assert os.path.getsize(curve) > 0


def test_li2o_toy_model_config_is_jax_examples():
    """``li2o_toy_model``'s VMCConfig is the JAX example's literal one
    (``examples/li2o_toy_model.py``), key for key, and its 'auto'
    membership is prefilter at 30 qubits."""
    jax_cfg = JaxVMCConfig(
        sample_num=8192, sampling_mode="gumbel", qubit_per_qudit=6,
        lr=3e-3, lr_schedule=((0, 3e-3), (1200, 1e-3), (2400, 3e-4)),
        grad_clip_norm=1.0, sr=JaxSRConfig(max_indices_num=50), seed=0,
    ).to_dict()
    cfg = li2o_toy_model.li2o_toy_config().to_dict()
    assert json.loads(json.dumps(cfg)) == json.loads(json.dumps(jax_cfg))
    vmc = VMC(load_li2o(), li2o_toy_model.li2o_toy_config(64),
              AnqsConfig(hidden_widths=(512,)), device="cpu")
    assert vmc.engine.membership == "prefilter"
    assert vmc.sector_words is None


def test_walkthrough_lih_from_atoms(tmp_path):
    """The walkthrough's LiH, built from atoms by the port into an empty
    molecule directory (2 training iterations), against the JAX package's
    LiH: every ladder energy to 1e-8 Ha."""
    mol, best = toy_model_walkthrough.main(
        ["toy_model_walkthrough", "2", str(tmp_path / "mols"),
         str(tmp_path / "run")], device="cpu")
    assert mol.build_seconds is not None  # built, not read from a cache
    jmol = JaxMolecule.create(JaxMolConfig(name="LiH"), mols_dir=MOLS)
    for name in ENERGIES:
        assert abs(getattr(mol, name) - getattr(jmol, name)) < 1e-8, name
    assert np.isfinite(best["energy"])
    assert len(proc.read_table(str(tmp_path / "run" / "result.csv"))[
        "energy"]) == 2
