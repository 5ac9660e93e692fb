"""The readings that the limits of ``correct`` are set from, for one cell on
one card, several seeds in one process:

- ``sound``: the program against the float32 reference, as a run compares
  them (the program's first window only: the readings need no measured
  window);
- ``control``: the reference computed with TF32 matmuls (the nearest
  precision below the configuration's float32 with TF32 off) put in the
  program's place;
- ``half``, ``quarter``, ``altered``: faults planted in the reference put
  in the program's place -- half of each set left out (the estimates taken
  over the rest), a rank's quarter alone (the exchange between four ranks
  left out), one row's local energy left without its partners. A state
  left unchanged reads 1 on ``change_gap`` by its definition.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--sound 0]

Prints one JSON line a seed. Needs a CUDA card (TF32 exists only there).
"""

import argparse
import gc
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))
sys.path.insert(0, BENCH_DIR)

import torch  # noqa: E402

from benchlib import inputs, judge, program  # noqa: E402
from benchlib.manifest import Manifest  # noqa: E402
from reference import hamiltonian as ref_ham  # noqa: E402
from reference.vmc import follow  # noqa: E402


class RowWithoutPartners(ref_ham.GroupedPauliHamiltonian):
    """A fault: the first row's numerator keeps its diagonal term only."""

    def local_energy_numerators(self, words, la, ph):
        t_re, t_im = super().local_energy_numerators(words, la, ph)
        i, j, h = self.pairs(words[:1])
        diag = float(h[(i == 0) & (j == 0)].sum())
        a0 = torch.exp(la[0].to(torch.float64))
        t_re = t_re.clone()
        t_im = t_im.clone()
        t_re[0] = (self.constant + diag) * a0
        t_im[0] = 0.0
        return t_re, t_im


def program_first_steps(manifest, cell, config, seed, device):
    vmc, state, params0 = program.build(config, cell, seed, device)
    first = program.FirstSteps(vmc, state, judge.FOLLOWED_STEPS)
    state, warm = vmc._multi_step(int(cell["steps_per_call"]))(state)
    first.close()
    out = {"params0": params0,
           "sets": [step[0][step[1]] for step in first.sets],
           "rows": [tuple(t[step[1]] for t in step[2:])
                    for step in first.sets],
           "energies": [float(e) for e in
                        warm["energy"][:judge.FOLLOWED_STEPS]],
           "grad1": first.grad1, "params_n": first.params_n}
    del vmc, state, first
    gc.collect()
    torch.cuda.empty_cache()
    return out


def as_program(follow_out):
    return (follow_out["energies"], follow_out["grad1"],
            follow_out["params"], follow_out["rows"])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sound", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    config = manifest.config(cell["config"])
    device = torch.device("cuda")
    from anqs_quantum_chemistry_torch.ops import cuda_build

    cuda_build.build(["fused_me", "hash_lookup"])
    parts = judge.reference_parts(config, device)
    net, ham, cfg = parts
    fault_ham = RowWithoutPartners(inputs.molecule_path(config), device)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = program_first_steps(manifest, cell, config, seed, device)
        p0, sets = run["params0"], run["sets"]
        row = {"workload": args.workload, "seed": seed}
        if args.sound:
            row["sound"], ref = judge.readings(
                config, cell, p0, sets, run["energies"], run["grad1"],
                run["params_n"], run["rows"], device, parts=parts)
        else:
            ref = follow(net, ham, p0, sets, cfg)
        half = [s[: s.shape[0] // 2] for s in sets]
        quarter = [s[: s.shape[0] // 4] for s in sets]
        planted = {
            "control": (sets, follow(net, ham, p0, sets, cfg, tf32=True)),
            "half": (half, follow(net, ham, p0, half, cfg)),
            "quarter": (quarter, follow(net, ham, p0, quarter, cfg)),
            "altered": (sets, follow(net, fault_ham, p0, sets, cfg)),
        }
        for name, (own, out) in planted.items():
            row[name], _ = judge.readings(config, cell, p0, own,
                                          *as_program(out), device,
                                          parts=parts, ref=ref)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
