"""The inputs both sides get: the molecule's npz file and the initial
weights, made from ``--seed`` or read from a packaged state."""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch

from .manifest import REPO_DIR, ansatz_of


def molecule_path(config: dict) -> str:
    return os.path.join(REPO_DIR, config["molecule"])


def molecule_sizes(config: dict) -> dict:
    with np.load(molecule_path(config)) as f:
        return {"qubit_num": int(f["qubit_num"]),
                "n_alpha": int(f["n_alpha"]), "n_beta": int(f["n_beta"]),
                "n_terms": int(f["ham_weights"].shape[0]),
                "n_groups": int(f["ham_a_masks"].shape[0])}


def seed64(seed: int) -> int:
    return int(seed) % (1 << 63)


def initial_params(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 parameters on ``device``, named and shaped as the ansatz's
    file says: Glorot-normal weights and zero biases from one normal draw
    of a generator on the device seeded ``seed``, or the packaged state the
    configuration names."""
    net = ansatz_of(config)
    shapes = net.param_shapes(net.shape(config, molecule_sizes(config)))
    init = config["init"]["weights"]
    if init != "glorot_normal":
        with np.load(os.path.join(REPO_DIR, init)) as f:
            return {k: torch.as_tensor(np.asarray(f[k], np.float32),
                                       device=device) for k in shapes}
    weights = [s for s in shapes.values() if len(s) == 2]
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    z = torch.randn(sum(a * b for a, b in weights), generator=gen,
                    device=device, dtype=torch.float32)
    params, off = {}, 0
    for name, s in shapes.items():
        if len(s) == 1:
            params[name] = torch.zeros(s, device=device)
            continue
        a, b = s
        params[name] = math.sqrt(2.0 / (a + b)) * z[off:off + a * b].reshape(
            a, b)
        off += a * b
    return params
