"""The PyTorch port imports no JAX: every module of
``anqs_quantum_chemistry_torch`` (the transformer and NADE ansatzes, the
pretraining, the matmul precision, selected CI, the support-CI closures,
the C2H4 and Li2O campaigns' entry points, and the host chemistry layer
with direct CI and the dissociation and ladder entry points, the ensembles,
the dense-state oracle and the exact top-k, the spin chains, the run-series
and result-processing tools and the last three example entry points, the
data-parallel mesh, the sharded hash membership, the multi-rank dry run,
the step's work counter and its spans among them) and ``chip_smoke.py``
import in a process where ``jax`` and the JAX package cannot be imported
(the machine with the card has no JAX).
The result-processing tools also run where pandas and matplotlib cannot be
imported (that machine has neither)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "orbax", "anqs_quantum_chemistry_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import anqs_quantum_chemistry_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in ("jax", "jaxlib", "orbax")]
assert not loaded, loaded
print(" ".join(names))
"""

# Modules that must be among those walked.
REQUIRED = (
    "anqs_quantum_chemistry_torch.models.transformer",
    "anqs_quantum_chemistry_torch.models.nade",
    "anqs_quantum_chemistry_torch.optim.adam",
    "anqs_quantum_chemistry_torch.optim.pretrain",
    "anqs_quantum_chemistry_torch.experiments.cisd_pretrain_vmc",
    "anqs_quantum_chemistry_torch.experiments.li2o_closure",
    "anqs_quantum_chemistry_torch.experiments.li2o_distill_closure",
    "anqs_quantum_chemistry_torch.experiments.c2h4_transformer",
    "anqs_quantum_chemistry_torch.observables.pauli",
    "anqs_quantum_chemistry_torch.experiments.vmc",
    "anqs_quantum_chemistry_torch.chem.native",
    "anqs_quantum_chemistry_torch.chem.selected_ci",
    "anqs_quantum_chemistry_torch.experiments.support_ci",
    "anqs_quantum_chemistry_torch.experiments.li2o_support_ci",
    "anqs_quantum_chemistry_torch.experiments.li2o_sci_polish",
    "anqs_quantum_chemistry_torch.experiments.li2o_pin_vmc",
    "anqs_quantum_chemistry_torch.models.precision",
    "anqs_quantum_chemistry_torch.experiments.c2h4_support_ci",
    "anqs_quantum_chemistry_torch.experiments.c2h4_support_transformer",
    "anqs_quantum_chemistry_torch.chem.geometry_repo",
    "anqs_quantum_chemistry_torch.chem.basis",
    "anqs_quantum_chemistry_torch.chem.integrals",
    "anqs_quantum_chemistry_torch.chem.scf",
    "anqs_quantum_chemistry_torch.chem.cc",
    "anqs_quantum_chemistry_torch.chem.jw",
    "anqs_quantum_chemistry_torch.chem.direct_ci",
    "anqs_quantum_chemistry_torch.chem.molecule",
    "anqs_quantum_chemistry_torch.experiments.dissociation_curve",
    "anqs_quantum_chemistry_torch.experiments.ladder_rerun",
    "anqs_quantum_chemistry_torch.models.ensemble",
    "anqs_quantum_chemistry_torch.models.bf_state",
    "anqs_quantum_chemistry_torch.ops.topk",
    "anqs_quantum_chemistry_torch.applications",
    "anqs_quantum_chemistry_torch.applications.spin_systems",
    "anqs_quantum_chemistry_torch.experiments.series",
    "anqs_quantum_chemistry_torch.experiments.processing",
    "anqs_quantum_chemistry_torch.experiments.summarize_runs",
    "anqs_quantum_chemistry_torch.experiments.li2o_toy_model",
    "anqs_quantum_chemistry_torch.experiments.toy_model_walkthrough",
    "anqs_quantum_chemistry_torch.utils.cost",
    "anqs_quantum_chemistry_torch.utils.spans",
    "anqs_quantum_chemistry_torch.parallel.mesh",
    "anqs_quantum_chemistry_torch.parallel.dist_membership",
    "anqs_quantum_chemistry_torch.experiments.dryrun_multichip",
)

# Imports and runs the processing tools and summarize_runs over an empty
# tree and one run where pandas and matplotlib cannot be imported.
NO_PANDAS_PROBE = r"""
import os, sys, tempfile
for name in ("pandas", "matplotlib"):
    sys.modules[name] = None
from anqs_quantum_chemistry_torch.experiments import processing
from anqs_quantum_chemistry_torch.experiments import summarize_runs
root = tempfile.mkdtemp()
assert processing.load_results(root) == {} and processing.harvest(root) == []
os.makedirs(os.path.join(root, "a"))
with open(os.path.join(root, "a", "result.csv"), "w") as f:
    f.write("energy,iter_idx,wall_time\n-1.0,0,0.5\n-1.5,1,1.0\n")
summarize_runs.main(["summarize_runs", root])
try:
    processing.plot_dissociation_curve("unused.csv")
except ImportError:
    pass
else:
    raise AssertionError("plotting without matplotlib did not raise")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = out.stdout.split()
    assert len(walked) >= 68  # every module was walked
    assert set(REQUIRED) <= set(walked)


def test_processing_needs_no_pandas_or_matplotlib():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", NO_PANDAS_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "2 iters, best E -1.500000, 1000.0 ms/iter" in out.stdout
