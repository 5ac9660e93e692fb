"""``run.py`` end to end on the CPU at a test-only tiny configuration (the
look for a card skipped), its refusal without a card, without the program
or for an ansatz no file covers, the count of failed steps, and a cell, a
configuration and a per-layer metric added by files and manifest entries
alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import run
from benchlib import program
from benchlib.manifest import Manifest
from conftest import BENCH_DIR, REPO_DIR, TINY_DIR

ORDER = ["correct", "attempted", "failed", "metrics", "device"]


def _run(capsys, manifest, cell, trace=0, seed=3000000019):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device="cpu",
                  manifest=manifest)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_rehearsal_prints_the_result_line(capsys, tiny):
    res, err = _run(capsys, tiny, "tiny.sampled")
    keys = list(res)
    assert keys[:5] == ORDER and keys[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % 3 == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"step_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(res["compared"]):]
    for line, (name, c) in zip(tail, res["compared"].items()):
        assert line.startswith(f"compared {name} ") and "limit" in line


def test_added_cell_config_and_metric_need_only_files(capsys, tmp_path):
    """A throwaway configuration, cell and per-layer metric: new files
    and manifest entries, no edit of a harness file."""
    with open(os.path.join(TINY_DIR, "manifest.json")) as f:
        data = json.load(f)
    with open(os.path.join(TINY_DIR, "configs", "n2_tiny.json")) as f:
        config = json.load(f)
    config["ansatz"]["hidden_widths"] = [8]
    (tmp_path / "extra.json").write_text(json.dumps(config))
    data["configs"].append({**data["configs"][0], "name": "n2_extra",
                            "file": str(tmp_path / "extra.json")})
    wdir = tmp_path / "workloads"
    shutil.copytree(os.path.join(TINY_DIR, "workloads"), wdir)
    with open(wdir / "tiny.sampled.json") as f:
        cell = json.load(f)
    cell["vmc"]["sample_num"] = 256
    cell["limits"] = {"set_errors": 0, "energy_gap_ha": 0.1, "grad_gap": 0.1,
                      "change_gap": 0.5}
    (wdir / "tiny.extra.json").write_text(json.dumps(cell))
    data["workloads"].append({"name": "tiny.extra", "config": "n2_extra",
                              "traffic": "extra", "chips": 1, "why": "test"})
    mdir = tmp_path / "metrics"
    shutil.copytree(os.path.join(BENCH_DIR, "metrics"), mdir)
    (mdir / "rows_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['kernel1']['rows'])\n")
    for m in data["per_layer"]:
        m["workloads"].append("tiny.extra")
    data["per_layer"].append({
        "name": "rows_seen", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "step_s",
        "workloads": ["tiny.extra"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(str(tmp_path / "BENCHMARK.json"), str(wdir), str(mdir))
    res, _ = _run(capsys, man, "tiny.extra", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["rows_seen"]["value"] == 256.0
    assert {"log_psi_ms", "sr_ms", "grad_ms"} <= set(res["metrics"])
    assert "breakdown" in res and res["device"]["window_s"] > 0


def _cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_fails_without_a_card():
    """On a machine with no card the run fails and prints no result; it
    does not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        return
    out = _cli(["benchmark/run.py", "--workload", "n2.sector", "--seed", "1",
                "--seconds", "1", "--trace", "0"], REPO_DIR)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the run fails and prints no result."""
    shutil.copy(os.path.join(REPO_DIR, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv[0] = 'benchmark/run.py'; "
            "sys.path.insert(0, 'benchmark'); import run; "
            "sys.exit(run.main(['--workload', 'n2.sector', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device='cpu'))")
    out = _cli(["-c", code], tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "anqs_quantum_chemistry_torch" in out.stderr


@pytest.mark.parametrize("change", [
    {"hidden_widths": [16, 16]}, {"net_type": "transformer"},
    {"head_mode": "real_imag"}, {"d_model": 128}])
def test_ansatz_that_no_file_covers_is_refused(capsys, tmp_path, change):
    """A configuration whose ansatz its ``ansatze/<net_type>.py`` does not
    model (a second hidden layer, an ansatz with no file, another head, a
    key the file does not know) fails before the run and prints no
    result."""
    with open(os.path.join(TINY_DIR, "manifest.json")) as f:
        data = json.load(f)
    with open(os.path.join(TINY_DIR, "configs", "n2_tiny.json")) as f:
        config = json.load(f)
    config["ansatz"].update(change)
    (tmp_path / "config.json").write_text(json.dumps(config))
    data["configs"][0]["file"] = str(tmp_path / "config.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(str(tmp_path / "BENCHMARK.json"),
                   os.path.join(TINY_DIR, "workloads"))
    rc = run.main(["--workload", "tiny.sampled", "--seed", "1", "--seconds",
                   "0.5", "--trace", "0"], device="cpu", manifest=man)
    out = capsys.readouterr()
    assert rc != 0
    assert "{" not in out.out
    assert "refused" in out.err


def test_failed_counts_each_step_once():
    """A step whose energy and gradient are both not finite, or whose
    membership also overflowed, is one failed step."""
    nan, inf = float("nan"), float("inf")
    import numpy as np

    metrics = {"energy": np.array([nan, 1.0, 1.0, inf, 1.0]),
               "grad_norm": np.array([nan, nan, 1.0, 1.0, 1.0]),
               "table_overflow": np.array([1, 0, 0, 0, 0]),
               "pf_dropped_rows": np.array([2, 0, 0, 3, 0])}
    assert program.step_failures(metrics) == 3
