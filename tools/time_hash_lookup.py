"""Times kernel #2 (``ops/hash_lookup.py`` ``hash_lookup``) of a checkout,
on one card: at the Li2O toy model's table (8192 sampled rows, one-word
keys: K 2, E 32, 25.2M queries) and at a table of 8192 random two-word
keys (16.8M random queries).

    python tools/time_hash_lookup.py [ROOT]

``ROOT`` (default: this checkout) is a tree holding ``chip_smoke.py`` and
``anqs_quantum_chemistry_torch``, e.g. a parent commit unpacked with ``git
archive <commit> chip_smoke.py anqs_quantum_chemistry_torch``; run each
tree in its own process, in turns, within one call to compare two. Prints
one JSON line: the wrapper's whole call (median of 5 x 20, tag build
included) and the lookup kernel's device time (``torch.profiler``).
"""

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from anqs_quantum_chemistry_torch.experiments.vmc import li2o_vmc  # noqa
from anqs_quantum_chemistry_torch.ops import cuda_build  # noqa: E402
from anqs_quantum_chemistry_torch.ops.hash_lookup import (  # noqa: E402
    hash_lookup,
)


def figures(tab, cols):
    return (cs.median_ms(lambda: hash_lookup(tab, *cols)),
            cs.kernel_device_ms(lambda: hash_lookup(tab, *cols),
                                ("hash_lookup_kernel",))[
                                    "hash_lookup_kernel"])


def main():
    if not torch.cuda.is_available():
        sys.exit("time_hash_lookup: needs a CUDA device")
    cuda_build.build(["hash_lookup"])
    vmc = li2o_vmc(device="cuda")
    words, valid, la, ph = cs.li2o_sample(torch, vmc, 0)
    eng = vmc.engine
    tab = eng._hash_build(words, la, ph, valid)[0]
    cols = [c for c in eng._hash_queries(words) if c is not None]
    out = {"root": ROOT, "device": torch.cuda.get_device_name(0)}
    out["li2o_ms"], out["li2o_device_ms"] = figures(tab, cols)
    rng = np.random.default_rng(7)
    n = 8192
    keys = torch.from_numpy(rng.integers(0, 1 << 32, (n, 2))).cuda()
    zeros = torch.zeros(n, device="cuda")
    tab2 = eng._hash_build(keys, zeros, zeros,
                           torch.ones(n, dtype=torch.bool,
                                      device="cuda"))[0]
    q = torch.from_numpy(rng.integers(0, 1 << 32, (1 << 24, 2)).astype(
        np.uint32).view(np.int32)).cuda()
    out["w2_ms"], out["w2_device_ms"] = figures(
        tab2, [q[:, 0].contiguous(), q[:, 1].contiguous()])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
