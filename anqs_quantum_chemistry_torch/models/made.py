"""MADE masked MLP over qudits.

Counterpart of the JAX package's ``models/made.py``: static 0/1 causal masks
multiply the weights (``w_eff = w * mask``), so one forward pass yields the
conditional outputs of every qudit at once, output q depending only on the
inputs of qudits < q. Weights keep the JAX layout ``(fan_in, fan_out)`` so
``convert.params_from_jax`` copies them as they are. Float32 throughout;
the matmuls multiply at ``spec.matmul_precision`` (``precision.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .precision import matmul


@dataclasses.dataclass(frozen=True)
class MadeSpec:
    qubit_num: int
    qudit_starts: Tuple[int, ...]  # qudit block boundaries over qubits
    qudit_ends: Tuple[int, ...]
    max_qudit_dim: int  # D: outputs per qudit (2**max width)
    hidden_widths: Tuple[int, ...] = (512,)
    n_channels: int = 1
    # 'bfloat16' or None (float32): ``precision.check_precision``'s value.
    matmul_precision: Optional[str] = None

    @property
    def qudit_num(self) -> int:
        return len(self.qudit_starts)

    @property
    def out_dim(self) -> int:
        return self.qudit_num * self.max_qudit_dim * self.n_channels


def _degrees(spec: MadeSpec):
    """Input qudit-ids, per-hidden-layer degrees, output qudit-ids."""
    q_in = np.concatenate(
        [
            np.full(e - s, q, dtype=np.int32)
            for q, (s, e) in enumerate(
                zip(spec.qudit_starts, spec.qudit_ends)
            )
        ]
    )
    n_deg = max(spec.qudit_num - 1, 1)
    hidden_degs = [
        np.arange(w, dtype=np.int32) % n_deg for w in spec.hidden_widths
    ]
    q_out = np.repeat(
        np.arange(spec.qudit_num, dtype=np.int32),
        spec.max_qudit_dim * spec.n_channels,
    )
    return q_in, hidden_degs, q_out


def made_masks(spec: MadeSpec):
    """Static 0/1 causal masks for each layer, as float32 numpy arrays."""
    q_in, hidden_degs, q_out = _degrees(spec)
    masks = []
    prev = q_in
    for degs in hidden_degs:
        masks.append((prev[:, None] <= degs[None, :]).astype(np.float32))
        prev = degs
    # Output connects to hidden with degree < its qudit id (strict causality).
    masks.append((prev[:, None] < q_out[None, :]).astype(np.float32))
    return masks


def made_init(spec: MadeSpec, generator: torch.Generator) -> Dict:
    """Glorot-normal weights, zero biases, on the CPU from ``generator``."""
    dims = [spec.qubit_num, *spec.hidden_widths, spec.out_dim]
    params = {}
    for i in range(len(dims) - 1):
        scale = math.sqrt(2.0 / (dims[i] + dims[i + 1]))
        params[f"w{i}"] = scale * torch.randn(
            dims[i], dims[i + 1], generator=generator, dtype=torch.float32
        )
        params[f"b{i}"] = torch.zeros(dims[i + 1], dtype=torch.float32)
    return params


def made_apply(spec: MadeSpec, params: Dict, masks, bits) -> torch.Tensor:
    """bits (B, n) in {0,1} -> (B, Q, D, C) raw conditional outputs.

    Input encoding x -> 1 - 2x; tanh hidden layers with biases and, from
    the second hidden layer on, residual connections where the widths
    match -- the JAX package's default MADE.
    """
    n_layers = len(spec.hidden_widths)
    prec = spec.matmul_precision
    h = 1.0 - 2.0 * bits.to(torch.float32)
    for i in range(n_layers):
        z = torch.tanh(matmul(h, params[f"w{i}"] * masks[i], prec)
                       + params[f"b{i}"])
        if i > 0 and z.shape == h.shape:
            z = z + h
        h = z
    out = matmul(h, params[f"w{n_layers}"] * masks[n_layers], prec)
    out = out + params[f"b{n_layers}"]
    return out.reshape(
        *bits.shape[:-1], spec.qudit_num, spec.max_qudit_dim, spec.n_channels
    )


class MADE(nn.Module):
    """``made_apply`` with its parameters (``w{i}``, ``b{i}``) and masks."""

    def __init__(self, spec: MadeSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        for name, value in made_init(spec, generator).items():
            self.register_parameter(name, nn.Parameter(value))
        self._n_masks = len(spec.hidden_widths) + 1
        for i, m in enumerate(made_masks(spec)):
            self.register_buffer(f"mask{i}", torch.from_numpy(m),
                                 persistent=False)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            for name, value in made_init(self.spec, generator).items():
                getattr(self, name).copy_(value)

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        params = dict(self.named_parameters(recurse=False))
        masks = [getattr(self, f"mask{i}") for i in range(self._n_masks)]
        return made_apply(self.spec, params, masks, bits)
