"""The entry points that build their molecules from atoms, on the CPU:
``experiments/dissociation_curve.py`` (the JAX package's
``examples/dissociation_curve.py``), ``experiments/ladder_rerun.py``
(``examples/ladder_rerun.py``) and ``experiments/run_molecule.py`` with a
``geometry_repo`` name (``examples/run_molecule.py``)."""

import os

import numpy as np
import pytest

from anqs_quantum_chemistry_torch.chem import molecule as molecule_mod
from anqs_quantum_chemistry_torch.experiments import (
    dissociation_curve,
    ladder_rerun,
    run_molecule,
)
from anqs_quantum_chemistry_torch.models.anqs import AnqsConfig

# The header of examples/dissociation_curve.py's runs/n2_dissociation.csv.
JAX_CURVE_HEADER = "r_angstrom,hf,cisd,fci,vmc"
# The header of the JAX package's ``VMC.run`` result.csv at a Gumbel step
# (its sorted metric names, then the driver's four columns).
JAX_CSV_HEADER = (
    "dropped,energy,energy_imag,energy_var,found_pairs,found_ratio,"
    "grad_norm,hf_log_abs,hf_proj_energy,ipr,max_log_abs,min_log_abs,"
    "pf_dropped_rows,sampled_prob,table_overflow,unique_num,iter_idx,"
    "wall_time,full_energy,full_energy_var"
)


def narrow_anqs(**kw):
    """The recipe's ansatz at width 8 (the card runs 512)."""
    return AnqsConfig(**{**kw, "hidden_widths": (8,),
                         "aux_hidden_widths": (8,)})


def test_dissociation_curve_two_points(tmp_path, monkeypatch, capsys):
    """2 points (0.9 and 2.0 angstrom) x 2 iterations into ``tmp_path``:
    each N2 built from atoms (FCI by direct CI on the CPU: the eigsh cap
    lowered below 20 qubits), the JAX CSV header, one row a point with the
    molecule's own energies; a second call skips both FINISHED points."""
    monkeypatch.setattr(molecule_mod, "MAX_BF_FCI_QUBITS", 18)
    monkeypatch.setattr(dissociation_curve, "AnqsConfig", narrow_anqs)
    kw = dict(device="cpu", mols_dir=str(tmp_path / "mols"),
              run_root=str(tmp_path / "runs"))
    results = dissociation_curve.main(["dissociation_curve", "2", "2"], **kw)
    assert sorted(results) == [0.9, 2.0]
    with open(tmp_path / "runs" / "n2_dissociation.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == JAX_CURVE_HEADER and len(lines) == 3
    for line, (r, res) in zip(lines[1:], sorted(results.items())):
        row = [float(x) for x in line.split(",")]
        mol = res["mol"]
        assert row[:4] == [r, mol.hf_energy, mol.cisd_energy, mol.fci_energy]
        assert row[4] == res["best"]["energy"] == min(res["energies"])
        assert len(res["energies"]) == 2
        assert mol.fci_energy < mol.cisd_energy < mol.hf_energy
        assert min(res["energies"]) > mol.fci_energy
        run_dir = tmp_path / "runs" / f"n2_r{r:.3f}"
        assert {"FINISHED", "result.csv", "best_energy.npy"} <= set(
            os.listdir(run_dir))
    # The 2.0 A point's FCI by direct CI against the record's eigsh FCI
    # (runs/n2_dissociation.csv: -107.45515453326401).
    assert abs(results[2.0]["mol"].fci_energy
               - -107.45515453326401) < 1e-7
    out = capsys.readouterr().out
    assert out.count("r=") == 2

    again = dissociation_curve.main(["dissociation_curve", "2", "2"], **kw)
    assert again == {}
    assert capsys.readouterr().out.count("skipped (FINISHED") == 2
    with open(tmp_path / "runs" / "n2_dissociation.csv") as f:
        assert len(f.read().splitlines()) == 3


class Stop(Exception):
    pass


def test_dissociation_curve_picks_lengths(tmp_path, monkeypatch):
    """``r`` arguments keep only the grid's lengths nearest to them."""
    calls = []

    def trainer(mol, device, run_dir):
        calls.append(run_dir)
        raise Stop

    monkeypatch.setattr(dissociation_curve, "n2_at", lambda *a: None)
    monkeypatch.setattr(dissociation_curve, "dissociation_vmc", trainer)
    with pytest.raises(Stop):
        dissociation_curve.main(["x", "5", "1", "1.99", "2.3"],
                                device="cpu", run_root=str(tmp_path))
    assert calls == [str(tmp_path / "n2_r2.000")]


def test_ladder_rerun_lih(tmp_path, monkeypatch, capsys):
    """LiH for 3 iterations (64 samples, width 8): built from atoms,
    ``result.csv`` under JAX's header, the cache under JAX's file name."""
    monkeypatch.setattr(ladder_rerun, "AnqsConfig", narrow_anqs)
    run_dir = tmp_path / "lih_r3"
    best = ladder_rerun.main(["ladder_rerun", "LiH", "3", str(run_dir), "64"],
                             device="cpu", mols_dir=str(tmp_path / "mols"))
    assert np.isfinite(best["energy"])
    with open(run_dir / "result.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == JAX_CSV_HEADER and len(lines) == 4
    assert os.listdir(tmp_path / "mols" / "LiH") == ["04e00baa83a958ac.npz"]
    out = capsys.readouterr().out
    assert "LiH: 12q HF -7.86" in out and "gap to FCI" in out


def test_run_molecule_builds_by_name(tmp_path, monkeypatch):
    """``run_molecule LiH 2 16``: a ``geometry_repo`` name, built by
    ``Molecule.create`` into ``mols_dir`` (JAX's cache file name), then
    trained."""
    best = run_molecule.main(["run_molecule", "LiH", "2", "16"],
                             device="cpu", run_root=str(tmp_path),
                             mols_dir=str(tmp_path / "mols"))
    assert np.isfinite(best["energy"])
    assert (tmp_path / "mols" / "LiH" / "04e00baa83a958ac.npz").exists()
    assert (tmp_path / "lih_torch" / "result.csv").exists()
