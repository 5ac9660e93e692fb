"""Parameters of the JAX package -> parameters of the port.

The JAX ansatz keeps its weights in a nested dict pytree
(``{"main": {"w0", "b0", ...}, "aux": {...}}``); the port's ``ANQS`` module
holds the same arrays under dotted names (``"main.w0"``) in the same
``(fan_in, fan_out)`` layout, whatever the options: layers without a bias
have no ``b{i}`` in either, the 'log_psi' head has no ``aux``, NADE's
subnets are ``main.qudit{q}.*``, and a stacked ensemble tree (a leading
replica axis on every leaf) gives ``models/ensemble.py``'s stacked dict.
The tests use this to run both packages from one set of weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy(-convertible) arrays -> flat ``state_dict``."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, prefix=f"{name}."))
        else:
            out[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """A flat npz of dotted names (``tools/export_jax_params.py``'s output)
    -> the port's state dict."""
    with np.load(path) as data:
        return params_from_jax(dict(data))
