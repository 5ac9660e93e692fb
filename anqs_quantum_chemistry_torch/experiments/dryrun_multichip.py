"""Data-parallel dry run: the VMC step on D ranks against one process.

The port's counterpart of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``. It spawns D ranks (``torch.multiprocessing``, spawn
start method, a ``file://`` rendezvous in a temporary directory, a timeout
on the group so that a hung collective fails), each running the same legs
on a ``parallel.mesh.Mesh``, and checks each leg as JAX asserts it:

- ``lih``: LiH/STO-3G (256 samples, qubit_per_qudit 3, MinSR top 16, MADE
  64): one step on the mesh against the same step in one process, every
  metric to 1e-5 + 1e-4 |a|;
- ``hash_dist``: the same step with the bucket-sharded table
  ('hash_dist') against the one-process step: energy to 1e-5 + 1e-4 |a|,
  the same pairs;
- ``n2``: the N2 flagship (``main_path_vmc``: 14,464 samples, MADE 512,
  qubit_per_qudit 10, sector membership, MinSR top 50; ``--flagship
  proxy`` cuts it to 1024 samples and MADE 128, as JAX's default does):
  every metric to 1e-4 + 3e-4 |a|, then 3 more steps on the mesh, finite;
  the parameters after the first step compared (reported, not checked);
- ``tight``: 'hash_dist' with both routing slacks at 1.0: the overflow is
  reported, or else the energy is the one-process energy.

Three more legs serve ``chip_smoke.py``'s ``mesh`` phase: ``li2o`` (the
Li2O toy model's state: 'hash_dist' local energies gathered, equal bit for
bit to one process's 'hash'), ``li2o_tight`` (that set's membership with
both slacks at 1.0: an overflow reported, no partner found that one
process misses, equal values where found) and ``n2_run`` (N2 through
``run()``, 6 steps in windows of 3: rank 0's rows against one process's,
every column to 1e-5 + 1e-4 |a|, each column's largest difference
reported). Every leg reports its ms a step and the launches of kernel #1,
kernel #2, the tag build and kernel #3 on each rank; ``n2`` also the time of the
trainer's per-step replica check.

    python -m anqs_quantum_chemistry_torch.experiments.dryrun_multichip \\
        [--ranks 4] [--backend gloo|nccl] [--device cuda|cpu]
        [--legs lih,hash_dist,n2,tight] [--flagship full|proxy]

``launch`` takes a plan of (ranks, legs) entries and runs them in one
spawn of as many ranks as the largest entry, each entry on the first ranks
(``make_mesh(n_devices)``), the others waiting. The kernels are built in
the parent before the spawn (one build, no race on ``_build/``), and so is
LiH (from atoms into ``--mols-dir`` unless it is
cached there). NCCL takes one rank a card; two or more ranks on one card
take gloo, whose collectives stage the card's tensors through the host. A
failure of any rank fails the run (exit code 1).
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..parallel.mesh import make_mesh

DEFAULT_LEGS = ("lih", "hash_dist", "n2", "tight")
LEGS = DEFAULT_LEGS + ("li2o", "li2o_tight", "n2_run")
# JAX's tolerances (__graft_entry__.py): (absolute, relative).
STEP_TOL = (1e-5, 1e-4)
FLAGSHIP_TOL = (1e-4, 3e-4)
# ``run()``'s rows on the mesh against one process's. The first row agrees
# to float32 sum order; each later row starts from parameters that differ
# (``leg_n2``), so every column drifts by ~1e-6 |a|, the training
# variance most. JAX's step tolerance holds them.
RUN_TOL = STEP_TOL
# Columns of a run's rows that are no metric of the step.
NOT_METRICS = ("iter_idx", "wall_time")
GROUP_TIMEOUT_S = 600


class DryrunFailure(RuntimeError):
    pass


def check(cond, msg):
    """Raise ``DryrunFailure(msg)`` unless ``cond`` (a check that ``-O``
    keeps)."""
    if not cond:
        raise DryrunFailure(msg)


def _entry(rank, n_ranks, init_method, backend, device, fn, args, out_dir,
           timeout_s):
    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(backend=backend,
                         device="cpu" if device == "cpu" else None)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, backend: str = "gloo", device: str = "cuda",
          args=(), timeout_s: float = GROUP_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned ranks of a fresh
    process group; returns every rank's return value, in rank order. ``fn``
    must be a module-level function; ``args`` are pickled to the ranks. A
    rank that raises fails the call."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(
            _entry, args=(n_ranks, init, backend, device, fn, args, tmp,
                          timeout_s),
            nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]


# ----------------------------------------------------------------------
# The legs
# ----------------------------------------------------------------------
def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernels():
    from ..ops.hash_lookup import fp_filter, hash_lookup, hash_tags
    from ..ops.matrix_elements import fused_matrix_elements

    return {"fused_matrix_elements": fused_matrix_elements,
            "hash_lookup": hash_lookup, "hash_tags": hash_tags,
            "fp_filter": fp_filter}


def _counted(fn, device):
    """(fn's result, ms on the host clock with the device synchronised,
    the kernels' launches in it)."""
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t)
    return out, ms, {name: k.launches for name, k in kernels.items()}


def metric_diffs(ref: dict, got: dict) -> dict:
    """{metric: |ref - got|} over the metrics of ``ref`` (0 where both
    are NaN)."""
    return {k: 0.0 if math.isnan(a) and math.isnan(got[k])
            else abs(a - got[k])
            for k, a in ref.items() if k not in NOT_METRICS}


def compare_metrics(ref: dict, got: dict, tol, label: str) -> float:
    """Assert every metric of ``ref`` within tol[0] + tol[1] |a| in
    ``got`` (both NaN passes); returns the largest difference."""
    diffs = metric_diffs(ref, got)
    for k, diff in diffs.items():
        check(diff == 0 or diff <= tol[0] + tol[1] * abs(ref[k]),
              f"{label}: {k} one process {ref[k]!r}, mesh {got[k]!r}")
    return max(diffs.values(), default=0.0)


def lih_vmc(device, mesh, mols_dir, membership=None, **engine):
    """JAX's dry-run stack (``__graft_entry__._build_stack``): LiH/STO-3G,
    256 samples, qubit_per_qudit 3, MinSR top 16, Adam 2e-3, MADE 64, on
    ``device``, on ``mesh`` or in one process (None)."""
    from ..chem.molecule import Molecule, MolConfig
    from ..optim.sr import SRConfig
    from ..models.anqs import AnqsConfig
    from .vmc import VMC, VMCConfig

    mol = Molecule.create(MolConfig(name="LiH"), mols_dir=mols_dir,
                          run_fci=False, run_cisd=False, device="cpu")
    overrides = dict(engine)
    if membership:
        overrides["membership"] = membership
    cfg = VMCConfig(sample_num=256, sampling_mode="gumbel",
                    qubit_per_qudit=3, sr=SRConfig(max_indices_num=16),
                    lr=2e-3, engine_overrides=overrides or None)
    return VMC(mol, cfg, AnqsConfig(hidden_widths=(64,)), device=device,
               mesh=mesh)


def _steps(vmc, device, steps=1):
    """``steps`` steps of ``vmc`` from its initial state: (the first
    step's metrics, the ms a step (the mean of the later steps where there
    are any, else the first's), the first step's launches, the later
    steps' metrics)."""
    state = vmc.init_state()
    metrics, ms, launches = _counted(lambda: vmc.step(state), device)
    later = []
    if steps > 1:
        later, ms, _ = _counted(
            lambda: [vmc.step(state) for _ in range(steps - 1)], device)
        ms /= steps - 1
    return metrics, ms, launches, later


def leg_lih(mesh, opts):
    def build(m):
        return lih_vmc(mesh.device, m, opts["mols_dir"])

    ref = _steps(build(None), mesh.device)[0]
    got, ms, launches, _ = _steps(build(mesh), mesh.device)
    return {"max_diff": compare_metrics(ref, got, STEP_TOL, "lih"),
            "energy": got["energy"], "ms": ms, "launches": launches}


def leg_hash_dist(mesh, opts):
    ref = _steps(lih_vmc(mesh.device, None, opts["mols_dir"]),
                 mesh.device)[0]
    got, ms, launches, _ = _steps(lih_vmc(
        mesh.device, mesh, opts["mols_dir"], "hash_dist"), mesh.device)
    a, b = ref["energy"], got["energy"]
    check(abs(a - b) <= STEP_TOL[0] + STEP_TOL[1] * abs(a),
          f"hash_dist: energy one process {a!r}, mesh {b!r}")
    check(got["found_pairs"] == ref["found_pairs"],
          f"hash_dist: pairs {got['found_pairs']}, one process "
          f"{ref['found_pairs']}")
    check(got["table_overflow"] == 0,
          f"hash_dist: overflow {got['table_overflow']}")
    return {"energy": b, "found_pairs": got["found_pairs"], "ms": ms,
            "launches": launches}


def leg_tight(mesh, opts):
    ref = _steps(lih_vmc(mesh.device, None, opts["mols_dir"]),
                 mesh.device)[0]
    got, ms, launches, _ = _steps(lih_vmc(
        mesh.device, mesh, opts["mols_dir"], "hash_dist",
        dist_entry_slack=1.0, dist_query_slack=1.0), mesh.device)
    overflow = int(got["table_overflow"])
    if overflow == 0:
        a, b = ref["energy"], got["energy"]
        check(abs(a - b) <= STEP_TOL[0] + STEP_TOL[1] * abs(a),
              f"tight: no overflow, yet energy {b!r} against {a!r}")
    return {"table_overflow": overflow, "energy": got["energy"], "ms": ms,
            "launches": launches}


def n2_vmc(device, mesh, flagship, run_dir=None, **overrides):
    """The N2 flagship (``main_path_vmc``) at ``flagship`` 'full' or
    'proxy' (1024 samples, MADE 128) on ``device``, on ``mesh`` or in one
    process (None)."""
    from .vmc import main_path_vmc

    width = 512 if flagship == "full" else 128
    if flagship != "full":
        overrides.setdefault("sample_num", 1024)
    return main_path_vmc(device=device, hidden_width=width,
                         run_dir=run_dir, mesh=mesh, **overrides)


def leg_n2(mesh, opts):
    """4 steps on the mesh and in one process: the first step's metrics
    compared, the later steps finite, and the parameters after the first
    step compared. The first step's metrics can agree bit for bit while
    those parameters differ: the mesh's gradient is the all-reduced sum of
    the ranks' partial sums, summed in another order than one process's
    backward pass sums it, and Adam's first step divides each entry by its
    own magnitude, so an entry whose gradient is at rounding level moves
    by up to the learning rate either way."""
    runs = {}
    for name, m in (("solo", None), ("mesh", mesh)):
        vmc = n2_vmc(mesh.device, m, opts["flagship"])
        state = vmc.init_state()
        first, _, launches = _counted(lambda: vmc.step(state), mesh.device)
        params = torch.cat([p.detach().reshape(-1).float()
                            for p in vmc.anqs.parameters()])
        later, ms, _ = _counted(
            lambda: [vmc.step(state) for _ in range(3)], mesh.device)
        runs[name] = (vmc, first, params, ms / 3, launches, later)
    ref, p_solo, solo_ms = runs["solo"][1], runs["solo"][2], runs["solo"][3]
    vmc, got, p_mesh, ms, launches, later = runs["mesh"]
    check(all(math.isfinite(row["energy"]) for row in later),
          f"n2: energies {[row['energy'] for row in later]}")
    moved = (p_mesh - p_solo).abs()
    # The per-step replica check alone (part of every step's ms).
    _, check_ms, _ = _counted(
        lambda: [vmc.check_replicas() for _ in range(5)], mesh.device)
    return {"max_diff": compare_metrics(ref, got, FLAGSHIP_TOL, "n2"),
            "energy": got["energy"], "ms": ms, "solo_ms": solo_ms,
            "check_ms": check_ms / 5, "launches": launches,
            "params_differ": int(torch.sum(moved > 0)),
            "params": moved.numel(), "param_max_diff": float(moved.max()),
            "later_energies": [row["energy"] for row in later]}


def _li2o_state(mesh, opts):
    """The Li2O toy model's sorted set at its seed's weights, whole on
    every rank: (trainer, words, log|psi|, phase, valid); made once a
    ``run_legs`` call (kept in ``opts['cache']``)."""
    from .vmc import li2o_vmc

    cache = opts["cache"]
    if "li2o" not in cache:
        vmc = li2o_vmc(device=mesh.device)
        state = vmc.init_state()
        with torch.no_grad():
            words, _, valid, _ = vmc._support(state.generator)
            la, ph = vmc.anqs.log_psi(words)
        cache["li2o"] = (vmc, words, la, ph, valid)
    return cache["li2o"]


def leg_li2o(mesh, opts):
    from ..observables.pauli import PauliEngine
    from ..parallel.mesh import replicate, shard_rows

    vmc, words, la, ph, valid = _li2o_state(mesh, opts)
    with torch.no_grad():
        vmc.engine.local_energy_proxy(words, la, ph, valid)  # warm-up
        ref, hash_ms, _ = _counted(
            lambda: vmc.engine.local_energy_proxy(words, la, ph, valid),
            mesh.device)
        eng = PauliEngine(vmc.ham, device=mesh.device,
                          membership="hash_dist", mesh=mesh)
        rows = shard_rows((words, la, ph, valid), mesh)
        eng.local_energy_proxy(*rows)  # warm-up
        e, ms, launches = _counted(lambda: eng.local_energy_proxy(*rows),
                                   mesh.device)
    e_re, e_im = replicate((e.e_re, e.e_im), mesh)
    check(torch.equal(e_re, ref.e_re) and torch.equal(e_im, ref.e_im),
          "li2o: hash_dist local energies differ from hash's: max "
          f"{float((e_re - ref.e_re).abs().max())}")
    check(int(e.found_pairs) == int(ref.found_pairs),
          f"li2o: pairs {int(e.found_pairs)}, hash {int(ref.found_pairs)}")
    check(int(e.table_overflow) == int(ref.table_overflow),
          f"li2o: overflow {int(e.table_overflow)}, hash "
          f"{int(ref.table_overflow)}")
    return {"found_pairs": int(e.found_pairs), "rows": int(rows[0].shape[0]),
            "ms": ms, "hash_ms": hash_ms, "launches": launches}


def leg_li2o_tight(mesh, opts):
    from ..parallel.dist_membership import NEG, hash_membership_dist
    from ..parallel.mesh import shard_rows

    vmc, words, la, ph, valid = _li2o_state(mesh, opts)
    a_words = vmc.engine.a_words
    with torch.no_grad():
        la_r, ph_r, _ = hash_membership_dist(None, words, la, ph, valid,
                                             a_words)
        rows = shard_rows((words, la, ph, valid), mesh)
        (la_d, ph_d, overflow), ms, launches = _counted(
            lambda: hash_membership_dist(mesh, *rows, a_words,
                                         entry_slack=1.0, query_slack=1.0),
            mesh.device)
    la_r, ph_r = shard_rows((la_r, ph_r), mesh)
    found_d, found_r = la_d > 0.5 * NEG, la_r > 0.5 * NEG
    check(not bool(torch.any(found_d & ~found_r)), "li2o_tight: a false hit")
    check(torch.equal(la_d[found_d], la_r[found_d])
          and torch.equal(ph_d[found_d], ph_r[found_d]),
          "li2o_tight: values differ where found")
    check(int(overflow) > 0 or torch.equal(found_d, found_r),
          "li2o_tight: no overflow reported, yet partners missed")
    return {"overflow": int(overflow),
            "missed": int(torch.sum(found_r & ~found_d)), "ms": ms,
            "launches": launches}


def leg_n2_run(mesh, opts):
    """N2 through ``run()``: 6 steps in windows of 3, the full energy and a
    checkpoint every 3; rank 0's ``result.csv`` against one process's, to
    ``RUN_TOL``."""
    import csv

    root = opts["workdir"]
    cfg = dict(full_energy_period=3)
    kw = dict(checkpoint_every=3, steps_per_call=3, log_every=0)
    solo_dir = os.path.join(root, "run_solo")
    if mesh.rank == 0:
        n2_vmc(mesh.device, None, opts["flagship"], solo_dir, **cfg).run(
            6, **kw)
    mesh.barrier()
    mesh_dir = os.path.join(root, "run_mesh")
    vmc = n2_vmc(mesh.device, mesh, opts["flagship"], mesh_dir, **cfg)
    (_, rows, _), ms, launches = _counted(lambda: vmc.run(6, **kw),
                                          mesh.device)
    out = {"ms": ms / len(rows), "launches": launches,
           "energies": [r["energy"] for r in rows]}
    if mesh.rank == 0:
        def read(path):
            with open(os.path.join(path, "result.csv")) as f:
                return [{k: float(v) for k, v in r.items()}
                        for r in csv.DictReader(f)]

        solo, meshed = read(solo_dir), read(mesh_dir)
        check(len(solo) == len(meshed) == 6,
              f"n2_run: {len(solo)} and {len(meshed)} rows")
        check(os.path.exists(os.path.join(mesh_dir, "ckpt_6")),
              "n2_run: no ckpt_6")
        out["max_diff"] = max(compare_metrics(a, b, RUN_TOL,
                                              f"n2_run row {i}")
                              for i, (a, b) in enumerate(zip(solo, meshed)))
        diffs = [metric_diffs(a, b) for a, b in zip(solo, meshed)]
        out["col_diffs"] = {k: max(d[k] for d in diffs) for k in diffs[0]
                            if any(d[k] for d in diffs)}
        out["rows_differ"] = [i for i, d in enumerate(diffs)
                              if any(d.values())]
        # The largest difference as a share of its column's tolerance.
        shares = [(d[k] / (RUN_TOL[0] + RUN_TOL[1] * abs(a[k])), k, i)
                  for i, (a, d) in enumerate(zip(solo, diffs))
                  for k in d if d[k]]
        out["tol_share"] = max(shares, default=(0.0, None, None))
    return out


LEG_FUNCS = {"lih": leg_lih, "hash_dist": leg_hash_dist, "n2": leg_n2,
             "tight": leg_tight, "li2o": leg_li2o,
             "li2o_tight": leg_li2o_tight, "n2_run": leg_n2_run}


def run_legs(mesh, legs, opts):
    """Every leg of ``legs`` on this rank of ``mesh``; returns {leg:
    report}."""
    if "cache" not in opts:
        opts = dict(opts, cache={})
    reports = {}
    for leg in legs:
        t = time.perf_counter()
        reports[leg] = LEG_FUNCS[leg](mesh, opts)
        reports[leg]["leg_s"] = time.perf_counter() - t
    return reports


def run_plan(world, plan, opts):
    """Each (ranks, legs) entry of ``plan`` in turn on a mesh of the
    world's first ``ranks`` ranks (``make_mesh(ranks)``; the others wait);
    returns {ranks: {leg: report}} of the entries this rank took part in.
    The legs share one cache, so the Li2O state is made once a rank."""
    opts = dict(opts, cache={})
    out = {}
    for n, legs in plan:
        mesh = world if n == world.size else make_mesh(
            n, backend=world.backend, device=world.device)
        if mesh is not None:
            out[n] = run_legs(mesh, legs, opts)
        world.barrier()
    return out


def prepare(legs, device: str, mols_dir: str):
    """What the ranks share, made once in the parent: the kernels (on the
    card) and LiH's molecule file."""
    if device != "cpu":
        from ..ops import cuda_build

        cuda_build.build(["fused_me", "hash_lookup"])
    if {"lih", "hash_dist", "tight"} & set(legs):
        from ..chem.molecule import Molecule, MolConfig

        Molecule.create(MolConfig(name="LiH"), mols_dir=mols_dir,
                        run_fci=False, run_cisd=False, device="cpu")


def launch(plan, backend: str, device: str, flagship: str = "full",
           mols_dir: str = None):
    """Prepare, spawn max(ranks) ranks and run ``plan``'s (ranks, legs)
    entries on them (``run_plan``); returns every rank's reports."""
    legs = {leg for _, entry in plan for leg in entry}
    unknown = sorted(legs - set(LEGS))
    if unknown:
        raise ValueError(f"legs {unknown}: expected some of {LEGS}")
    with tempfile.TemporaryDirectory() as work:
        mols_dir = mols_dir or os.path.join(work, "mols")
        prepare(legs, device, mols_dir)
        opts = {"mols_dir": mols_dir, "flagship": flagship, "workdir": work}
        return spawn(run_plan, max(n for n, _ in plan), backend, device,
                     args=(tuple(plan), opts))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--legs", default=",".join(DEFAULT_LEGS))
    parser.add_argument("--flagship", default=None, choices=("full", "proxy"),
                        help="the N2 leg's size (default: full on the card, "
                        "proxy on the CPU)")
    parser.add_argument("--mols-dir", default=None,
                        help="where LiH is read or built (default: a "
                        "temporary directory)")
    args = parser.parse_args(argv)
    flagship = args.flagship or ("full" if args.device == "cuda"
                                 else "proxy")
    t = time.perf_counter()
    plan = ((args.ranks, tuple(args.legs.split(","))),)
    reports = launch(plan, args.backend, args.device, flagship,
                     args.mols_dir)
    for rank, rep in enumerate(reports):
        print(json.dumps({"rank": rank, **rep[args.ranks]}, default=float),
              flush=True)
    print(f"dryrun_multichip ok: {args.ranks} ranks, {args.backend}, "
          f"{args.device}, legs {args.legs} "
          f"[{time.perf_counter() - t:.1f} s]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
