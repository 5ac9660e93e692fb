"""The C2H4/6-31G support-CI entry points of the PyTorch port on the CPU:
each command of ``experiments/c2h4_support_ci.py`` and
``experiments/c2h4_support_transformer.py`` runs with a small injected
target and few steps (the sampled full energy replaced by a cheap stand-in;
it is held on LiH and on the card). Kept apart from
``test_torch_c2h4_sci.py`` so the two files share the test workers' time."""

import os

import numpy as np
import pytest

from anqs_quantum_chemistry_torch.chem import selected_ci as sci
from anqs_quantum_chemistry_torch.chem.molecule import load_c2h4
from anqs_quantum_chemistry_torch.experiments import c2h4_support_ci as c2sci
from anqs_quantum_chemistry_torch.experiments import (
    c2h4_support_transformer as c2tr,
)
from anqs_quantum_chemistry_torch.experiments import support_ci as scp
from anqs_quantum_chemistry_torch.experiments.li2o_support_ci import (
    load_target,
)


@pytest.fixture
def cheap_full_energy(monkeypatch):
    """The sampled full energy replaced by a falling sequence (-78.1,
    -78.1001, ...): the command tests check the dispatch, the stage
    bookkeeping and the resume rules; the full energy itself is held on
    LiH (``tests/test_torch_support_ci.py``) and on the card."""
    calls = []

    def fake(vmc, generator, sample_num, row_chunk=None):
        calls.append((sample_num, row_chunk))
        return -78.1 - 1e-4 * len(calls), 1e-3

    monkeypatch.setattr(scp, "sampled_full_energy", fake)
    return calls


@pytest.fixture(scope="module")
def small_target():
    """The packaged target's top 48 determinants, diagonalised."""
    mol = load_c2h4()
    td, tc, _ = load_target(c2sci.C2H4_SCI_TARGET)
    d, c = sci.truncate_by_weight(td, tc, 48)
    e, c = sci.restricted_ground_state(d, mol.h1, mol.v, mol.e_nuc)
    return d, c, e


def test_c2h4_support_ci_commands_run(tmp_path, capsys, small_target,
                                     monkeypatch, cheap_full_energy):
    root = str(tmp_path)
    cut = dict(device="cpu", run_root=root, target=small_target,
               full_samples=16, row_chunk=8)
    monkeypatch.setitem(c2sci.RQL, "segment", 3)  # L-BFGS iterations
    with np.load(c2sci.C2H4_CISD_VECTOR) as v:
        seed, _ = sci.truncate_by_weight([int(x) for x in v["dets"]],
                                         v["coef"], 40)
    td, tc, e0 = c2sci.main(["x", "target"], device="cpu", run_root=root,
                            seed=seed, rounds=((1e-2, 5, 90),), sizes=(64,))
    out = capsys.readouterr().out
    assert "seed: |S|=40" in out and "round 0" in out
    assert len(td) == 64 and os.path.exists(
        os.path.join(root, c2sci.RUN_NAME, "target.npz"))
    res = c2sci.main(["x", "distill"], **cut,
                     distill_stages=((1, 3e-4), (1, 1e-4)))
    assert "params from" in capsys.readouterr().out
    assert [r["stage"] for r in res["stages"]] == [0, 1]
    assert cheap_full_energy[0] == (16, 8)
    res = c2sci.main(["x", "polish"], **cut, polish_steps=1)
    assert "ckpt_2" in capsys.readouterr().out  # resumes from distill's
    assert [r["stage"] for r in res["stages"]][-4:] == [10, 11, 12, 13]
    with pytest.raises(FileNotFoundError, match="build_h"):
        c2sci.main(["x", "rq"], **cut)
    c2sci.main(["x", "build_h"], **cut)
    assert "restricted E0" in capsys.readouterr().out
    res = c2sci.main(["x", "rq"], **cut, rq_steps=2)
    out = capsys.readouterr().out
    rq_rows = [r for r in res["stages"] if r["stage"] >= 20]
    assert [r["stage"] for r in rq_rows] == [20, 21, 22, 23]
    assert all(r["precision"] == "highest" for r in rq_rows)
    best = min(res["stages"], key=lambda r: r["full_e"])
    assert res["best_full_e"] == best["full_e"]
    res = c2sci.main(["x", "rql", "3"], **cut)
    assert any(r["stage"] == 40 and r["optimizer"] == "lbfgs"
               for r in res["stages"])
    res = c2sci.main(["x", "refit", "2"], **cut)
    assert any(r["stage"] == 60 for r in res["stages"])
    res = c2sci.main(["x", "repair", "2", "2"], **cut)
    out = capsys.readouterr().out
    assert "incumbent sampled full energy" in out
    assert [r["stage"] for r in res["stages"] if r["stage"] >= 70] == [70,
                                                                        71]
    c2sci.main(["x", "confirm"], **cut)
    out = capsys.readouterr().out
    assert "confirm: mean" in out and res["best_ckpt"] in out
    es = np.load(os.path.join(root, c2sci.RUN_NAME, "confirm_energies.npy"))
    assert es.shape == (5,) and np.all(np.isfinite(es))
    with pytest.raises(ValueError, match="unknown command"):
        c2sci.main(["x", "bogus"], **cut)


def test_c2h4_support_transformer_commands_run(tmp_path, capsys,
                                               small_target, monkeypatch,
                                               cheap_full_energy):
    root = str(tmp_path)
    monkeypatch.setitem(c2tr.TR_RQL, "segment", 2)  # L-BFGS iterations
    cut = dict(device="cpu", run_root=root, target=small_target,
               full_samples=16, row_chunk=8)
    e = c2tr.main(["x", "measure"], **cut)
    assert "ckpt3000" in capsys.readouterr().out and np.isfinite(e)
    assert cheap_full_energy == [(16, 8)]
    with pytest.raises(FileNotFoundError, match="build_h"):
        c2tr.main(["x", "rql", "2"], **cut)
    c2sci.main(["x", "build_h"], device="cpu", run_root=root,
               target=small_target)
    res = c2tr.main(["x", "rql", "2"], **cut)
    assert [r["stage"] for r in res["stages"]] == [40]
    assert res["stages"][0]["optimizer"] == "rql"
