"""Summarise every run under a directory: the port's counterpart of the JAX
package's ``examples/summarize_runs.py``.

Usage:
    python -m anqs_quantum_chemistry_torch.experiments.summarize_runs \
        [runs_root]

Reads each ``result.csv`` and ``result.csv.gz`` under ``runs_root``
(default ``runs``) with ``processing.load_results`` and prints one line a
run: its iterations, its best energy and its milliseconds per iteration
(the last wall time over the iterations after the first).
"""

from __future__ import annotations

import sys

import numpy as np

from .processing import by_run, load_results


def main(argv=None):
    argv = sys.argv if argv is None else argv
    root = argv[1] if len(argv) > 1 else "runs"
    runs = by_run(load_results(root))
    if not runs:
        print(f"no result.csv found under {root}")
        return
    for run_dir, sub in runs.items():
        best = np.nanmin(sub["energy"])
        iters = len(sub["energy"])
        rate = (sub["wall_time"][-1] / max(iters - 1, 1)
                if "wall_time" in sub else float("nan"))
        print(f"{run_dir}: {iters} iters, best E {best:.6f}, "
              f"{rate * 1000:.1f} ms/iter")


if __name__ == "__main__":
    main()
