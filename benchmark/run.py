"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is named in ``BENCHMARK.json``; its files are
``benchmark/workloads/<cell>.json`` and the configuration that names. A run
builds the port's trainer (``anqs_quantum_chemistry_torch``) from the seed,
warms up with one window call of the cell's own shapes, drives
``VMC._multi_step(k)`` for ``--seconds``, and with ``--trace 1`` then times
the stages and profiles one more call. Once the window has closed and the
program is freed, a plain reference follows the program's first steps and
decides ``correct``. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error. A run needs as many CUDA cards as the cell asks for, and
fails without them.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, CHECKOUT)
sys.path.insert(0, BENCH_DIR)
# Python's bytecode of everything a run imports (PyTorch's own modules
# among them) is cached at a fixed path inside the checkout, so that only
# the first run there compiles it; spawned ranks inherit the setting.
PYCACHE = os.path.join(CHECKOUT, ".bench_cache", "pycache")
sys.pycache_prefix = PYCACHE
sys.dont_write_bytecode = False
os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

from benchlib.manifest import Manifest, ansatz_of  # noqa: E402

# Top-level module names that the process printing the result may not
# have loaded once the window has closed, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "anqs_quantum_chemistry_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", manifest: Manifest = None) -> int:
    """Run the cell; returns the exit code. ``device='cpu'`` (tests only)
    skips the look for cards and runs on the CPU."""
    args = parse(argv)
    manifest = manifest or Manifest()
    cell = manifest.cell(args.workload)
    chips = int(cell["chips"])
    try:
        ansatz_of(manifest.config(cell["config"]))
    except ValueError as e:
        print(f"configuration {cell['config']!r} refused: {e}",
              file=sys.stderr)
        return 2
    import torch

    if device == "cuda":
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            print(f"the cell needs {chips} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from anqs_quantum_chemistry_torch.ops import cuda_build

        cuda_build.build(["fused_me", "hash_lookup"])
    if chips > 1:
        from benchlib.launch import run_ranks

        result = run_ranks(chips, (manifest.path, manifest.workloads_dir,
                            manifest.metrics_dir),
                           args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    else:
        from benchlib.session import run

        result = run(manifest, args.workload, args.seed, args.seconds,
                     bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
