"""Kernel #2's roofline (``metrics/hash_lookup_roofline.py``), read from
the counters the program's ``hash_lookup`` counts under the profiler: a
tiny CPU run with ``--trace 1`` of a prefilter cell counts the traced
call's lookups and leaves the reading out (the CPU's trace has no
``hash_lookup_kernel``); on a trace that has the kernel the reading is the
least time over the mean launch; and where the program counts nothing the
reader gives None and raises nothing."""

import json
import os
import shutil
import sys
import types

import pytest
import torch

import run
from benchlib.manifest import Manifest
from conftest import BENCH_DIR, REPO_DIR, TINY_DIR

METRIC = "hash_lookup_roofline"
PEAK = {"hbm_bytes_per_s": 3.35e12, "float32_flops_per_s": 67e12}


def _manifest(tmp_path):
    """The tiny manifest with a prefilter cell, ``tiny.pf``, and the
    repository's kernel #2 roofline on it."""
    with open(os.path.join(TINY_DIR, "manifest.json")) as f:
        data = json.load(f)
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        ours = {m["name"]: m for m in json.load(f)["per_layer"]}
    wdir = tmp_path / "workloads"
    shutil.copytree(os.path.join(TINY_DIR, "workloads"), wdir)
    with open(wdir / "tiny.sampled.json") as f:
        cell = json.load(f)
    cell["vmc"] = {"sampling_mode": "gumbel", "sample_num": 256,
                   "engine_overrides": {
                       "membership": "prefilter", "pf_row_chunk": 64,
                       "prefilter_row_capacity": 64,
                       "prefilter_dense_rows": 256}}
    (wdir / "tiny.pf.json").write_text(json.dumps(cell))
    data["workloads"].append({"name": "tiny.pf", "config": "n2_tiny",
                              "traffic": "tiny.pf", "chips": 1,
                              "why": "test"})
    data["per_layer"] = [{**ours[METRIC], "workloads": ["tiny.pf"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return Manifest(str(tmp_path / "BENCHMARK.json"), str(wdir),
                    os.path.join(BENCH_DIR, "metrics"))


def test_traced_prefilter_run_counts_its_lookups(capsys, tmp_path):
    from anqs_quantum_chemistry_torch.utils import spans

    before = spans.profiled_counts().get("launches", 0)
    rc = run.main(["--workload", "tiny.pf", "--seed", "3000000023",
                   "--seconds", "0.5", "--trace", "1"], device="cpu",
                  manifest=_manifest(tmp_path))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert METRIC not in res["metrics"]
    # The traced window call (3 steps): stages 3a (4 row blocks) and 3b.
    assert spans.profiled_counts()["launches"] - before == 3 * 5


def test_roofline_on_a_trace_with_the_kernel():
    """Two lookups of one table under the profiler (8 B keys, K 2, E 16)
    against a trace whose two ``hash_lookup_kernel`` launches take 10 and
    30 us: the least time of the mean launch over 20 us."""
    from torch.profiler import ProfilerActivity, profile

    from anqs_quantum_chemistry_torch.ops.hash_lookup import (
        ENTRIES,
        hash_lookup,
    )
    from anqs_quantum_chemistry_torch.utils import spans

    roofline = Manifest().readers("cr2.prefilter")[METRIC][0]
    nb, n = 64, 1000
    tab = torch.full((nb, 4 * ENTRIES), -1e30, dtype=torch.float32)
    q = torch.arange(n, dtype=torch.int32)
    before = spans.profiled_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        hash_lookup(tab, q, q)
        hash_lookup(tab, q, q)
    counts = {k: v - before.get(k, 0)
              for k, v in spans.profiled_counts().items()
              if v != before.get(k, 0)}
    assert counts == {"launches": 2, "queries": 2 * n,
                      "key_words": 4 * n, "buckets": 2 * nb,
                      "entries": 2 * nb * ENTRIES,
                      "table_words": 2 * nb * 4 * ENTRIES}
    n_bytes = 4 * 2 * n + 4 * nb * 4 * ENTRIES + 9 * n
    ops = n * (9 * 1 + 3 * ENTRIES)
    least = max(n_bytes / PEAK["hbm_bytes_per_s"],
                ops / PEAK["float32_flops_per_s"])
    trace = types.SimpleNamespace(
        kernel_times=lambda part: [10e-6, 30e-6]
        if part == "hash_lookup_kernel" else [])
    ctx = {"trace": trace, "peak": PEAK}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "_profiled_counts", counts)
        assert roofline(ctx) == pytest.approx(100 * least / 20e-6)


def test_without_spans_the_reader_gives_none(tmp_path, monkeypatch):
    """A program without ``utils/spans.py`` (the reader laid over an
    older checkout): None, no exception."""
    from anqs_quantum_chemistry_torch import utils

    monkeypatch.setitem(sys.modules,
                        "anqs_quantum_chemistry_torch.utils.spans", None)
    monkeypatch.delattr(utils, "spans", raising=False)
    trace = types.SimpleNamespace(kernel_times=lambda part: [1e-5])
    read = _manifest(tmp_path).readers("tiny.pf")[METRIC][0]
    assert read({"trace": trace, "peak": PEAK}) is None
