"""N2/STO-3G dissociation curve of the PyTorch port against the JAX
package's records (``runs/n2_dissociation.csv``, ``runs/n2_r*/``).

    python tools/torch_n2_curve_check.py build [mols_dir]
    python tools/torch_n2_curve_check.py compare RUN_ROOT

``build``: builds N2 from atoms at the curve's five lengths
(``np.linspace(0.9, 2.0, 5)`` angstrom) with the port's ``Molecule.create``
on the host (into ``mols_dir``, default a temporary directory) and prints
each HF, CISD and FCI energy beside the record's, with the stage times;
exits 1 if any differs by more than 1e-8 Ha.

``compare``: for each ``RUN_ROOT/n2_r<r>_result.csv`` (or
``RUN_ROOT/n2_r<r>/result.csv``) that the port's
``experiments.dissociation_curve`` wrote, the best energy, its iteration,
its gap to FCI, the first iteration within 1.6 mHa of FCI and the median
seconds a step (from ``wall_time``), beside the same figures, times left
out, of the JAX record ``runs/n2_r<r>/result.csv.gz`` over all its rows and
over as many rows as the port ran. Imports no JAX.
"""

import csv
import gzip
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from anqs_quantum_chemistry_torch.experiments.dissociation_curve import (  # noqa: E402
    CHEMICAL_ACCURACY,
    n2_at,
)

RECORD = os.path.join(ROOT, "runs", "n2_dissociation.csv")
TOL = 1e-8


def record_rows():
    """{r: (hf, cisd, fci, vmc)} of the JAX package's curve."""
    with open(RECORD) as f:
        return {float(row["r_angstrom"]): tuple(
            float(row[k]) for k in ("hf", "cisd", "fci", "vmc"))
            for row in csv.DictReader(f)}


def build(mols_dir):
    worst = 0.0
    for r, ref in sorted(record_rows().items()):
        t = time.perf_counter()
        mol = n2_at(r, mols_dir=mols_dir, device="cpu")
        took = time.perf_counter() - t
        got = (mol.hf_energy, mol.cisd_energy, mol.fci_energy)
        diffs = [abs(a - b) for a, b in zip(got, ref)]
        worst = max(worst, *diffs)
        print(f"r={r:.4f}  HF {got[0]:.14f} CISD {got[1]:.14f} FCI "
              f"{got[2]:.14f}  |diff| {diffs[0]:.1e} {diffs[1]:.1e} "
              f"{diffs[2]:.1e} Ha  [{took:.1f} s: "
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          (mol.build_seconds or {}).items()) + "]",
              flush=True)
    print(f"largest |port - record| {worst:.2e} Ha (tolerance {TOL:g})")
    return 0 if worst <= TOL else 1


def read_csv(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["energy"]) for r in rows]),
            np.array([int(float(r["iter_idx"])) for r in rows]),
            np.array([float(r["wall_time"]) for r in rows]))


def figures(energy, iters, wall, fci, timed=True):
    """The run's figures; ``timed``: with its seconds a step (the port's
    runs; the JAX records' times name no device and are left out)."""
    best = int(np.argmin(energy))
    within = np.nonzero(energy - fci < CHEMICAL_ACCURACY)[0]
    out = (f"best {energy[best]:.8f} at {iters[best]} "
           f"({1e3 * (energy[best] - fci):+.3f} mHa), first within 1.6 mHa "
           f"at {iters[within[0]] if len(within) else None}, "
           f"{len(energy)} rows")
    if timed:
        out += (f", median step {np.median(np.diff(wall)):.4f} s, "
                f"{wall[-1]:.0f} s")
    return out


def compare(run_root):
    for r, ref in sorted(record_rows().items()):
        tag = f"n2_r{r:.3f}"
        paths = [os.path.join(run_root, f"{tag}_result.csv"),
                 os.path.join(run_root, tag, "result.csv")]
        found = [p for p in paths if os.path.exists(p)]
        if not found:
            print(f"r={r:.3f}: no port run under {run_root}")
            continue
        port = read_csv(found[0])
        jax = read_csv(os.path.join(ROOT, "runs", tag, "result.csv.gz"))
        n = len(port[0])
        print(f"r={r:.3f} FCI {ref[2]:.8f}\n  port: {figures(*port, ref[2])}"
              f"\n  JAX record: {figures(*jax, ref[2], timed=False)}"
              f"\n  JAX record, first {n} rows: "
              f"{figures(*(a[:n] for a in jax), ref[2], timed=False)}")
    return 0


def main(argv):
    if len(argv) >= 2 and argv[1] == "build":
        if len(argv) > 2:
            return build(argv[2])
        with tempfile.TemporaryDirectory() as tmp:
            return build(tmp)
    if len(argv) == 3 and argv[1] == "compare":
        return compare(argv[2])
    sys.exit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
