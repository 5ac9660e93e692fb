"""``BENCHMARK.json`` against the benchmark's contract: names and units,
every reference resolving to a file, the four-chip share, and each cell's
files."""

import json
import os
import re

import pytest

from benchlib import judge
from benchlib.manifest import ansatz_of
from conftest import BENCH_DIR, REPO_DIR

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_paths_and_command(manifest):
    assert set(manifest) == KEYS
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert manifest["command"][1].startswith(manifest["paths"][0] + "/")
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_lines(manifest):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry and key != "end_to_end":
                    assert _line(entry[text]), (entry["name"], text)
    assert len(set(names)) == len(names)


def test_references_resolve(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    cells = {w["name"]: w for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    used = {w["config"] for w in cells.values()}
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(REPO_DIR, c["file"]))
        assert len(c["reduced"]) <= 16
        with open(os.path.join(REPO_DIR, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"] and body["precision"]
    assert len({c["file"] for c in configs.values()}) == len(configs)
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    for w in cells.values():
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(BENCH_DIR, "workloads",
                                           w["name"] + ".json"))
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(cells)
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_line(layer) for layer in layers)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        e2e = [m for m in manifest["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in manifest["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per


def test_four_chip_share(manifest):
    cells = manifest["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_workload_files_hold_limits(manifest):
    for w in manifest["workloads"]:
        with open(os.path.join(BENCH_DIR, "workloads",
                               w["name"] + ".json")) as f:
            cell = json.load(f)
        assert cell["limits"]["set_errors"] == 0
        assert int(cell["steps_per_call"]) >= judge.FOLLOWED_STEPS


def test_every_configuration_has_its_ansatz_file(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(REPO_DIR, c["file"])) as f:
            ansatz_of(json.load(f))
