"""No run loads JAX or the JAX package, compared by whole top-level module
names: the harness's sources, the reference's (which loads nothing of the
port either), and what a run and the reference load."""

import ast
import os
import subprocess
import sys

from run import FORBIDDEN, forbidden_modules
from conftest import BENCH_DIR, REPO_DIR

PORT = "anqs_quantum_chemistry_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*parts):
    root = os.path.join(BENCH_DIR, *parts)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_harness_sources_import_no_jax():
    for path in _sources():
        assert not set(_imports(path)) & set(FORBIDDEN), path


def test_reference_sources_import_neither_jax_nor_the_port():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert not names & (set(FORBIDDEN) | {PORT, "benchlib"}), path


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "anqs_quantum_chemistry_tpu_notes",
                        sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "jax" not in forbidden_modules()
    assert "anqs_quantum_chemistry_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_reference_loads_neither_jax_nor_the_port():
    loaded = _loaded(
        "import sys; sys.path.insert(0, 'benchmark'); "
        "import reference.vmc, reference.ansatz, reference.hamiltonian; "
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not loaded & (set(FORBIDDEN) | {PORT})


def test_a_run_loads_no_jax():
    loaded = _loaded(
        "import sys; sys.path[:0] = ['benchmark', 'benchmark/tests']; "
        "import run; from benchlib.manifest import Manifest; "
        "m = Manifest('benchmark/tests/tiny/manifest.json', "
        "'benchmark/tests/tiny/workloads'); "
        "rc = run.main(['--workload', 'tiny.sampled', '--seed', '9', "
        "'--seconds', '0.2', '--trace', '0'], device='cpu', manifest=m); "
        "assert rc == 0; "
        "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))")
    assert PORT in loaded
    assert not loaded & set(FORBIDDEN)
