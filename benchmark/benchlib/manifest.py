"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell ``<name>`` is ``workloads/<name>.json``, its configuration the file
its manifest entry names (``configs/<config>.json``) and each per-layer
metric ``metrics/<metric>.py`` (a ``read(ctx)`` function); the ansatz a
configuration names (its ``ansatz.net_type``) is ``ansatze/<net_type>.py``,
all under the benchmark's folder. Adding a cell, a configuration, an ansatz
or a metric adds files and manifest entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
ANSATZE_DIR = os.path.join(BENCH_DIR, "ansatze")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ANSATZE = {}


def ansatz_of(config: dict):
    """The module ``ansatze/<net_type>.py`` of the configuration's ansatz,
    after its ``check(config)``; raises ``ValueError`` for a configuration
    that no such file covers."""
    net_type = config["ansatz"]["net_type"]
    path = os.path.join(ANSATZE_DIR, f"{net_type}.py")
    if not os.path.exists(path):
        raise ValueError(f"no ansatze/{net_type}.py for net_type "
                         f"{net_type!r}")
    if net_type not in _ANSATZE:
        _ANSATZE[net_type] = _load(path, f"bench_ansatz_{net_type}")
    _ANSATZE[net_type].check(config)
    return _ANSATZE[net_type]


class Manifest:
    def __init__(self, path: str = os.path.join(REPO_DIR, "BENCHMARK.json"),
                 workloads_dir: str = os.path.join(BENCH_DIR, "workloads"),
                 metrics_dir: str = os.path.join(BENCH_DIR, "metrics")):
        self.path, self.workloads_dir = path, workloads_dir
        self.metrics_dir = metrics_dir
        with open(path) as f:
            self.data = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key}: no entry named {name!r}")

    def cell(self, name: str) -> dict:
        """The cell's manifest entry merged with ``workloads/<name>.json``."""
        entry = self._entry("workloads", name)
        with open(os.path.join(self.workloads_dir, f"{name}.json")) as f:
            return {**json.load(f), **entry}

    def config(self, name: str) -> dict:
        """``configs/<name>.json`` (the manifest entry's ``file``)."""
        entry = self._entry("configs", name)
        with open(os.path.join(REPO_DIR, entry["file"])) as f:
            return {**json.load(f), "name": name}

    def metrics_of(self, cell: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def readers(self, cell: str) -> Dict[str, object]:
        """{metric: its ``read(ctx)``} of the cell's per-layer metrics."""
        out = {}
        for m in self.metrics_of(cell, "per_layer"):
            module = _load(os.path.join(self.metrics_dir,
                                        f"{m['name']}.py"),
                           f"bench_metric_{m['name'].replace('.', '_')}")
            out[m["name"]] = (module.read, m["unit"])
        return out
