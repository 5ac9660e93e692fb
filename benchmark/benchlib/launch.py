"""The ranks of a data-parallel cell: one process a card, spawned fresh, a
``file://`` rendezvous in a new directory under ``TMPDIR``, a timeout on the
group, no tensors passed between the processes. Rank 0's result comes back
through a file in that directory; a rank that fails fails the run."""

from __future__ import annotations

import datetime
import json
import os
import shutil
import tempfile

GROUP_TIMEOUT_S = 300


def run_rank(rank, n, init, backend, device, manifest_paths, cell, seed,
          seconds, trace, t_start, out_dir):
    import torch
    import torch.distributed as dist

    from anqs_quantum_chemistry_torch.parallel.mesh import make_mesh

    from .manifest import Manifest
    from .session import run

    # The host's cores shared among the ranks, not each rank's pool over
    # all of them.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = make_mesh(backend=backend,
                         device="cpu" if device == "cpu" else None)
        result = run(Manifest(*manifest_paths), cell, seed, seconds, trace,
                     device, t_start, mesh)
        if result is not None:
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, manifest_paths: tuple, cell: str, seed: int,
              seconds: float, trace: bool, device: str, t_start: float):
    """Rank 0's result of the cell run on ``n`` ranks: NCCL with one card a
    rank, or gloo on the CPU (``device='cpu'``)."""
    import torch.multiprocessing as mp

    backend = "gloo" if device == "cpu" else "nccl"
    # NCCL's shared-memory transport leaves segments in /dev/shm; the
    # cards' direct path needs none.
    os.environ["NCCL_SHM_DISABLE"] = "1"
    out_dir = tempfile.mkdtemp(prefix="bench_ranks_")
    try:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        mp.start_processes(
            run_rank, args=(n, init, backend, device, manifest_paths, cell, seed,
                         seconds, trace, t_start, out_dir),
            nprocs=n, join=True, start_method="spawn")
        with open(os.path.join(out_dir, "result.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        # The spawn start method leaves a resource-tracker process behind;
        # stop it and wait for it, so that the run ends every process it
        # started.
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()
