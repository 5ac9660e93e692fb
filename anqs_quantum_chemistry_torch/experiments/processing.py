"""Result harvesting and plotting across experiment trees.

The JAX package's ``experiments/processing.py`` on ``csv``, ``gzip`` and
numpy, without pandas (the card's machine has none): reads ``result.csv``
and ``result.csv.gz`` back from run directories, summarises each run beside
its ``config.json``, collapses seeds, and plots the optimisation energy
against the FCI reference with the chemical-accuracy band.

JAX's DataFrames become plain data with JAX's column names:

- a *table* is a dict of numpy columns (float64 where every value parses as
  a number, an empty field or ``nan`` as NaN; str otherwise), the rows of
  ``load_results`` and of one run (``by_run``);
- a *summary* is a list of dicts, one a row (``harvest``,
  ``aggregate_seeds``); a key a row lacks is NaN in JAX's DataFrame.

The plot functions import matplotlib when called; importing this module
needs neither pandas nor matplotlib.
"""

from __future__ import annotations

import csv
import glob
import gzip
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

CHEMICAL_ACCURACY = 1.6e-3  # Ha
RESULT_FILES = ("result.csv", "result.csv.gz")

Table = Dict[str, np.ndarray]


def _column(values: list) -> np.ndarray:
    """float64 where every field parses as a number (an empty one as NaN),
    else str."""
    try:
        return np.array([float(v) if v != "" else np.nan for v in values],
                        dtype=np.float64)
    except ValueError:
        return np.array(values, dtype=str)


def read_table(path: str) -> Table:
    """One ``result.csv`` or ``result.csv.gz`` as a table."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header, body = rows[0], [r for r in rows[1:] if r]
    return {name: _column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def _n_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def _concat(tables: List[Table]) -> Table:
    """Rows of ``tables`` one after another, under the union of their
    columns (in order of appearance); a column a table lacks is NaN (or ''
    in a str column) on its rows."""
    names = list(dict.fromkeys(k for t in tables for k in t))
    out = {}
    for name in names:
        parts = []
        is_str = any(t.get(name, np.zeros(0)).dtype.kind == "U"
                     for t in tables)
        for t in tables:
            n = _n_rows(t)
            if name in t:
                parts.append(t[name].astype(str) if is_str else t[name])
            else:
                parts.append(np.full(n, "" if is_str else np.nan,
                                     dtype=str if is_str else np.float64))
        out[name] = np.concatenate(parts)
    return out


def load_results(runs_root: str) -> Table:
    """Every ``result.csv`` (then ``result.csv.gz``) under ``runs_root``,
    one after another, with a ``run_dir`` column; a directory holding both
    is read once, from its ``result.csv``. ``{}`` where there is none."""
    tables, run_dirs = [], []
    for pattern in RESULT_FILES:
        for path in sorted(glob.glob(os.path.join(runs_root, "**", pattern),
                                     recursive=True)):
            run_dir = os.path.dirname(path)
            if run_dir in run_dirs:
                continue
            tables.append(read_table(path))
            run_dirs.append(run_dir)
    if not tables:
        return {}
    out = _concat(tables)
    out["run_dir"] = np.concatenate([
        np.full(_n_rows(t), d, dtype=object)
        for t, d in zip(tables, run_dirs)])
    return out


def by_run(table: Table) -> Dict[str, Table]:
    """{run_dir: that run's rows}, in sorted run_dir order (JAX's
    ``groupby('run_dir')``)."""
    if not table:
        return {}
    run_dirs = table["run_dir"]
    return {d: {k: v[run_dirs == d] for k, v in table.items()}
            for d in sorted(set(run_dirs.tolist()))}


def harvest(runs_root: str) -> List[dict]:
    """One summary row per run directory under ``runs_root``: its
    ``config.json`` scalars as ``cfg.<key>``, ``iters``, ``best_energy``,
    ``final_energy``, ``wall_time`` (the last), ``final_full_energy`` (the
    last recorded), and ``full_energy_f64`` and ``gap_to_fci_mHa`` from a
    ``full_energy_revalidation.json`` beside it."""
    rows = []
    for run_dir, df in by_run(load_results(runs_root)).items():
        row = {"run_dir": run_dir, "iters": _n_rows(df)}
        cfg_path = os.path.join(run_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            for k, v in cfg.items():
                if isinstance(v, (int, float, str, bool, type(None))):
                    row[f"cfg.{k}"] = v
        energy = df["energy"]
        row["best_energy"] = (float(np.nanmin(energy))
                              if np.any(~np.isnan(energy)) else math.nan)
        row["final_energy"] = float(energy[-1])
        if "wall_time" in df:
            row["wall_time"] = float(df["wall_time"][-1])
        if "full_energy" in df:
            fe = df["full_energy"][~np.isnan(df["full_energy"])]
            if len(fe):
                row["final_full_energy"] = float(fe[-1])
        reval = os.path.join(run_dir, "full_energy_revalidation.json")
        if os.path.exists(reval):
            with open(reval) as f:
                r = json.load(f)
            row["full_energy_f64"] = r.get("full_energy_f64")
            row["gap_to_fci_mHa"] = r.get("gap_to_fci_mHa")
        rows.append(row)
    return rows


def _missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _group_sort_key(key: tuple):
    """Group keys in pandas' order: missing values last."""
    return tuple((1, "") if _missing(v) else (0, v) for v in key)


def aggregate_seeds(summary: List[dict],
                    group_keys: Optional[List[str]] = None) -> List[dict]:
    """Collapse runs that differ only by ``cfg.seed``: per group of the
    ``cfg.*`` keys (``group_keys``), ``n_seeds``, and the min, mean and
    standard deviation (ddof 1; NaN for one seed) of ``best_energy``. A
    missing key groups as NaN."""
    if not summary:
        return []
    if group_keys is None:
        columns = dict.fromkeys(k for row in summary for k in row)
        group_keys = [c for c in columns
                      if c.startswith("cfg.") and c != "cfg.seed"]
    groups = {}
    for row in summary:
        key = tuple(None if _missing(row.get(k)) else row.get(k)
                    for k in group_keys)
        groups.setdefault(key, []).append(row)
    out = []
    for key in sorted(groups, key=_group_sort_key):
        rows = groups[key]
        best = np.array([r.get("best_energy", math.nan) for r in rows],
                        dtype=np.float64)
        best = best[~np.isnan(best)]
        agg = dict(zip(group_keys, (math.nan if v is None else v
                                    for v in key)))
        agg.update(
            n_seeds=sum(not _missing(r.get("run_dir")) for r in rows),
            best_energy=float(best.min()) if len(best) else math.nan,
            mean_best_energy=float(best.mean()) if len(best) else math.nan,
            std_best_energy=(float(best.std(ddof=1)) if len(best) > 1
                             else math.nan),
        )
        out.append(agg)
    return out


def time_to_chemical_accuracy(df: Table,
                              fci_energy: float) -> Optional[float]:
    """The first wall time at which one run's running-best energy is within
    ``CHEMICAL_ACCURACY`` of ``fci_energy``; None if it never is."""
    best = np.fmin.accumulate(df["energy"])
    hit = np.nonzero(best - fci_energy < CHEMICAL_ACCURACY)[0]
    if len(hit) == 0:
        return None
    return float(df["wall_time"][hit[0]])


def _pyplot():
    """matplotlib's pyplot on the Agg backend; raises ``ImportError`` where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plot functions need matplotlib") from e
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def plot_energy_vs_reference(
    df: Table,
    fci_energy: float,
    hf_energy: Optional[float] = None,
    cisd_energy: Optional[float] = None,
    ccsd_energy: Optional[float] = None,
    out_path: Optional[str] = None,
    logy: bool = True,
):
    """E - E_FCI against the iteration, one line a run of ``df``
    (``load_results``), with the chemical-accuracy band. Returns (figure,
    axes)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.grid(alpha=0.3)
    for run_dir, sub in by_run(df).items():
        ax.plot(sub["iter_idx"], sub["energy"] - fci_energy, lw=1,
                label=os.path.basename(run_dir))
    ax.axhspan(0, CHEMICAL_ACCURACY, color="grey", alpha=0.35,
               label="chemical accuracy")
    for name, e in [("HF", hf_energy), ("CISD", cisd_energy),
                    ("CCSD", ccsd_energy)]:
        if e is not None:
            ax.axhline(e - fci_energy, ls="--", lw=1, label=name)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("iteration")
    ax.set_ylabel(r"$E - E_{FCI}$ (Ha)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig, ax


def plot_dissociation_curve(csv_path: str, out_path: Optional[str] = None):
    """HF, CISD, FCI and VMC energies against the bond length, over a
    panel of the VMC - FCI gap (the CSV of ``dissociation_curve``: columns
    r_angstrom, hf, cisd, fci, vmc). Returns the figure."""
    plt = _pyplot()
    data = np.genfromtxt(csv_path, delimiter=",", names=True)
    fig, (ax, ax2) = plt.subplots(
        2, 1, figsize=(7, 6), sharex=True,
        gridspec_kw={"height_ratios": [3, 1]},
    )
    ax.grid(alpha=0.3)
    ax.plot(data["r_angstrom"], data["hf"], "s--", lw=1, label="HF")
    ax.plot(data["r_angstrom"], data["cisd"], "^--", lw=1, label="CISD")
    ax.plot(data["r_angstrom"], data["fci"], "k-", lw=1.5, label="FCI")
    ax.plot(data["r_angstrom"], data["vmc"], "o", ms=5, label="ANQS VMC")
    ax.set_ylabel("energy (Ha)")
    ax.legend(fontsize=9)

    ax2.grid(alpha=0.3)
    gap_mha = (data["vmc"] - data["fci"]) * 1e3
    ax2.axhspan(0, CHEMICAL_ACCURACY * 1e3, color="grey", alpha=0.35,
                label="chemical accuracy")
    ax2.plot(data["r_angstrom"], gap_mha, "o-", ms=5)
    ax2.set_xlabel("bond length (angstrom)")
    ax2.set_ylabel(r"$E_{VMC} - E_{FCI}$ (mHa)")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig
