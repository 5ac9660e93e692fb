"""NADE ansatz: one independent MLP per qudit over the visible prefix.

Counterpart of the JAX package's ``models/nade.py``: subnet q sees the
input encoding ``1 - 2 * bits`` with the qubits of qudits >= q zeroed (a
static visibility mask, in place of MADE's weight masks), so its output
depends only on the qudits before q. The layers follow MADE's per-layer
patterns (``made.mlp_apply``: activation, bias, residual, compute dtype;
JAX ``models/nade.py:25-97``). The Q subnets run as a loop of small
GEMMs. Parameters keep JAX's names (``qudit{q}.w{i}``, ``b{i}``) and
``(fan_in, fan_out)`` layout, so ``convert.params_from_jax`` carries a JAX
tree across unchanged. Interface-compatible with ``made.MADE``: bits (B, n)
-> (B, Q, D, C). Float32 throughout; the matmuls multiply at
``spec.matmul_precision`` (``precision.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .made import bias_pattern, check_patterns, glorot_layers, mlp_apply


@dataclasses.dataclass(frozen=True)
class NadeSpec:
    qubit_num: int
    qudit_starts: Tuple[int, ...]
    qudit_ends: Tuple[int, ...]
    max_qudit_dim: int
    hidden_widths: Tuple[int, ...] = (64,)
    n_channels: int = 1
    # 'bfloat16' or None (float32): ``precision.check_precision``'s value.
    matmul_precision: Optional[str] = None
    activation: object = "tanh"  # str | Tuple[str, ...] | 'sanqs_paper'
    bias: object = True  # bool | Tuple[bool, ...] (depth + 1 entries)
    residual: bool = True
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    @property
    def qudit_num(self) -> int:
        return len(self.qudit_starts)

    @property
    def dims(self) -> Tuple[int, ...]:
        """Layer widths of every subnet, input to output."""
        return (self.qubit_num, *self.hidden_widths,
                self.max_qudit_dim * self.n_channels)


def nade_init(spec: NadeSpec, generator: torch.Generator) -> Dict:
    """Glorot-normal weights and zero biases (where the pattern keeps them)
    of every subnet, qudit by qudit and layer by layer (JAX ``nade_init``'s
    order), on the CPU from ``generator``: ``{"qudit{q}": {"w{i}",
    "b{i}"}}``."""
    use_bias = bias_pattern(spec.bias, len(spec.dims) - 1)
    return {f"qudit{q}": glorot_layers(spec.dims, use_bias, generator)
            for q in range(spec.qudit_num)}


def visibility(spec: NadeSpec) -> np.ndarray:
    """(Q, n) float32: 1 on the qubits of qudits < q, else 0."""
    vis = np.zeros((spec.qudit_num, spec.qubit_num), dtype=np.float32)
    for q, start in enumerate(spec.qudit_starts):
        vis[q, :start] = 1.0
    return vis


def nade_apply(spec: NadeSpec, params: Dict, vis, bits) -> torch.Tensor:
    """bits (B, n) in {0,1} -> (B, Q, D, C) raw conditional outputs (JAX
    ``nade_apply``); ``vis`` is ``visibility(spec)`` as a tensor."""
    n_weights = len(spec.hidden_widths) + 1
    x = 1.0 - 2.0 * bits.to(torch.float32)
    outs = []
    for q in range(spec.qudit_num):
        sub = params[f"qudit{q}"]
        weights = [sub[f"w{i}"] for i in range(n_weights)]
        outs.append(mlp_apply(spec, sub, weights, x * vis[q]))
    out = torch.stack(outs, dim=-2)
    return out.reshape(*bits.shape[:-1], spec.qudit_num, spec.max_qudit_dim,
                       spec.n_channels)


class NADE(nn.Module):
    """``nade_apply`` with its parameters, one submodule ``qudit{q}`` a
    subnet holding ``w{i}`` and the ``b{i}`` its pattern keeps, and the
    visibility mask."""

    def __init__(self, spec: NadeSpec, generator: torch.Generator):
        super().__init__()
        check_patterns(spec)
        self.spec = spec
        for q, sub in nade_init(spec, generator).items():
            module = nn.Module()
            for name, value in sub.items():
                module.register_parameter(name, nn.Parameter(value))
            self.add_module(q, module)
        self.register_buffer("vis", torch.from_numpy(visibility(spec)),
                             persistent=False)

    def _tree(self) -> Dict:
        return {f"qudit{q}": dict(getattr(self, f"qudit{q}")
                                  .named_parameters(recurse=False))
                for q in range(self.spec.qudit_num)}

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            tree = self._tree()
            for q, sub in nade_init(self.spec, generator).items():
                for name, value in sub.items():
                    tree[q][name].copy_(value)

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        return nade_apply(self.spec, self._tree(), self.vis, bits)
