"""Experiment-series runner with skip-finished bookkeeping.

The JAX package's ``experiments/series.py``: each run lives in
``<root>/<sha16>/`` with ``config.json``, ``result.csv``,
``best_energy.npy`` and a ``FINISHED`` marker; running the series again
skips the finished entries and re-runs interrupted ones.

A run directory is named by the first 16 hex characters of the sha256 of
JAX's signature of an entry, ``[cfg.to_dict(), asdict(acfg),
mol.config.to_dict()]`` (keys sorted), built from the port's configs. The
port's ``VMCConfig``, ``AnqsConfig`` and ``MolConfig`` serialise as JAX's
do, so an entry gets the directory name that the JAX package gives it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from ..chem.molecule import Molecule
from ..models.anqs import AnqsConfig
from .vmc import VMC, VMCConfig


def entry_signature(mol: Molecule, cfg: VMCConfig, acfg: AnqsConfig) -> str:
    """The JSON text hashed into an entry's directory name."""
    if mol.config is None:
        raise ValueError(f"molecule {mol.name!r} has no MolConfig (read "
                         "from a packaged file): build it with "
                         "Molecule.create")
    return json.dumps([cfg.to_dict(), dataclasses.asdict(acfg),
                       mol.config.to_dict()], sort_keys=True, default=str)


def run_series(
    entries: Iterable[Tuple[Molecule, VMCConfig, AnqsConfig]],
    root_dir: str,
    iter_num: Optional[int] = None,
    steps_per_call: int = 1,
    on_result: Optional[Callable] = None,
    device="cuda",
):
    """Run every (molecule, VMC config, ansatz config) entry on ``device``,
    skipping entries whose run directory holds a ``FINISHED`` marker.
    Returns the (run_dir, best) pairs of this call, skipped entries
    included with their best read from ``best_energy.npy`` and
    ``skipped: True``. ``on_result(run_dir, best)`` follows each run that
    this call trains."""
    os.makedirs(root_dir, exist_ok=True)
    results = []
    for mol, cfg, acfg in entries:
        sig = entry_signature(mol, cfg, acfg)
        run_dir = os.path.join(root_dir,
                               hashlib.sha256(sig.encode()).hexdigest()[:16])
        marker = os.path.join(run_dir, "FINISHED")
        if os.path.exists(marker):
            e, it = np.load(os.path.join(run_dir, "best_energy.npy"))
            results.append((run_dir, {"energy": float(e), "iter": int(it),
                                      "skipped": True}))
            continue
        vmc = VMC(mol, cfg, acfg, device=device, run_dir=run_dir)
        _, _, best = vmc.run(iter_num=iter_num,
                             steps_per_call=steps_per_call,
                             checkpoint_every=None)
        with open(marker, "w") as f:
            f.write("done\n")
        best = dict(best, skipped=False)
        results.append((run_dir, best))
        if on_result is not None:
            on_result(run_dir, best)
    return results
