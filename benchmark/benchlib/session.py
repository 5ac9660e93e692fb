"""One run of one cell on one process (a rank of the mesh, in a
data-parallel cell): set-up, the measured window, the traced stretch, then,
once the program's state is freed, the comparison with the reference."""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from . import inputs, judge, program, work
from .manifest import ansatz_of
from .trace import profiled


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sharded(mesh):
    return mesh is not None and mesh.size > 1


def _agree(mesh, value: float, op: str) -> float:
    """``value`` reduced over the ranks (sum or max); itself alone."""
    if not _sharded(mesh):
        return value
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group)
    return float(t.item())


def _gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a set, gathered whole in rank order."""
    if not _sharded(mesh):
        return t
    import torch.distributed as dist

    parts = [None] * mesh.size
    dist.all_gather_object(parts, t.cpu(), group=mesh.group)
    return torch.cat(parts).to(t.device)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(manifest, cell_name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, mesh=None):
    """The result of the run (a dict; on rank 0 only, None on the other
    ranks). ``t_start``: the wall clock when the process (or the launcher
    of the ranks) started."""
    cell = manifest.cell(cell_name)
    config = manifest.config(cell["config"])
    rank0 = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else torch.device(device)
    k = int(cell["steps_per_call"])
    n_follow = judge.FOLLOWED_STEPS

    # Set-up: the trainer, its first window (which the reference follows).
    t_build = time.time()
    vmc, state, params0 = program.build(config, cell, seed, device, mesh)
    first = program.FirstSteps(vmc, state, n_follow)
    window = vmc._multi_step(k)
    t_warm = time.time()
    state, warm = window(state)
    _sync(device)
    first.close()
    energies = [float(e) for e in warm["energy"][:n_follow]]
    setup_s = time.time() - t_start
    if rank0:
        print(f"set-up {setup_s:.3f} s: to the trainer {t_build - t_start:.3f}"
              f", trainer {t_warm - t_build:.3f}, first window "
              f"{setup_s - (t_warm - t_start):.3f}", file=sys.stderr)

    # The measured window: whole calls until ``seconds`` have passed.
    failed = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        state, m = window(state)
        _sync(device)
        ends.append(time.perf_counter() - t0)
        failed += program.step_failures(m)
        go = ends[-1] < seconds
        if _sharded(mesh):
            go = _rank0_says(mesh, go)
        if not go:
            break
    calls, elapsed = len(ends), ends[-1]
    if rank0:
        per = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
        print(f"window: {calls} calls of {k} steps, s a call "
              + " ".join(f"{x:.4f}" for x in per), file=sys.stderr)
    attempted = calls * k
    step_s = elapsed / attempted

    stages = tr = None
    if trace:
        if not _sharded(mesh):
            stages = vmc.profile_stages(int(cell["stage_reps"]))
        _, tr = profiled(lambda: window(state), device)
    busy_s = None
    if tr is not None:
        busy_s = _agree(mesh, tr.busy_s, "sum") / (mesh.size if _sharded(mesh)
                                                   else 1)
    peak_bytes = int(_agree(mesh, torch.cuda.max_memory_allocated(device)
                            if device.type == "cuda" else 0, "max"))

    full_sets = [tuple(_gather_rows(mesh, t) for t in step)
                 for step in first.sets]
    grad1, params_n = first.grad1, first.params_n
    del vmc, state, window, first
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not rank0:
        return None

    sets = [step[0][step[1]] for step in full_sets]
    rows = [tuple(t[step[1]] for t in step[2:]) for step in full_sets]
    values, _ = judge.readings(config, cell, params0, sets, energies,
                               grad1, params_n, rows, device)
    limits = cell["limits"]
    result = {"correct": judge.verdict(values, limits),
              "attempted": attempted, "failed": failed}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    chips = mesh.size if mesh is not None else 1
    if not trace:
        result["metrics"] = {
            "step_s": {"value": step_s, "unit": "s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        rows = full_sets[0][0].shape[0]
        net = ansatz_of(config)
        sizes = inputs.molecule_sizes(config)
        vmc_cfg = {**config["vmc"], **cell.get("vmc", {})}
        counts = net.flops(net.shape(config, sizes),
                           int(vmc_cfg.get("sample_num", rows)),
                           vmc_cfg.get("sampling_mode") != "exact")
        ctx = {
            "trace": tr, "busy_s": busy_s, "stages": stages,
            "step_s": step_s, "chips": chips, "traced_steps": k,
            "flops": work.step_flops(counts, rows,
                                     int(config["sr"]["max_indices_num"])),
            "peak": _peak(kind),
            "kernel1": {"rows": rows,
                        "n_words": -(-sizes["qubit_num"] // 32),
                        "n_terms": sizes["n_terms"],
                        "n_groups": sizes["n_groups"]},
        }
        result["metrics"] = {}
        for name, (read, unit) in manifest.readers(cell_name).items():
            value = read(ctx)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": kind, "count": chips, "memory_peak_bytes": peak_bytes,
        "power": _power_limit() if device.type == "cuda" else "none"}
    if tr is not None:
        result["device"].update(busy_s=busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = {name: {"value": values[name], "limit": limits[name]}
                          for name in limits}
    return result


def _rank0_says(mesh, go: bool) -> bool:
    """Rank 0's decision, so that every rank runs the same calls."""
    import torch.distributed as dist

    flag = torch.tensor([float(go)], dtype=torch.float64, device=mesh.device)
    dist.broadcast(flag, src=0, group=mesh.group)
    return bool(flag.item())


def _peak(kind: str):
    try:
        return work.peaks(kind)
    except KeyError:
        return None

