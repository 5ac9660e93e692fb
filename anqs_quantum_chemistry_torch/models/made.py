"""MADE masked MLP over qudits.

Counterpart of the JAX package's ``models/made.py``: static 0/1 causal masks
multiply the weights (``w_eff = w * mask``), so one forward pass yields the
conditional outputs of every qudit at once, output q depending only on the
inputs of qudits < q. Weights keep the JAX layout ``(fan_in, fan_out)`` so
``convert.params_from_jax`` copies them as they are. The per-layer patterns
of JAX's ``MadeSpec`` (reference PatternConfig family, mlp.py:13-70):
``activation`` (one name, a per-hidden-layer tuple, or 'sanqs_paper'),
``bias`` (a bool or a depth + 1 tuple; a layer without a bias has no
``b{i}``), ``residual`` and ``compute_dtype`` (``precision.store``).
Float32 tensors throughout; the matmuls multiply at
``spec.matmul_precision`` (``precision.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import check_compute_dtype, matmul, store

# JAX ``_ACTIVATIONS`` (``models/made.py:128-134``); ``jax.nn.gelu`` is the
# tanh approximation by default.
ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "silu": F.silu,
}


@dataclasses.dataclass(frozen=True)
class MadeSpec:
    qubit_num: int
    qudit_starts: Tuple[int, ...]  # qudit block boundaries over qubits
    qudit_ends: Tuple[int, ...]
    max_qudit_dim: int  # D: outputs per qudit (2**max width)
    hidden_widths: Tuple[int, ...] = (512,)
    n_channels: int = 1  # 2 for the log_psi head (log|psi|, phase)
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


def activation_pattern(activation, depth: int) -> Tuple[str, ...]:
    """One activation name a hidden layer (JAX ``activation_pattern``): a
    name repeated, 'sanqs_paper' (tanh, then leaky_relu), or a tuple of
    ``depth`` names. Raises ``ValueError`` on an unknown name or a tuple of
    another length."""
    if activation == "sanqs_paper":
        pattern = ("tanh",) + ("leaky_relu",) * max(depth - 1, 0)
    elif isinstance(activation, str):
        pattern = (activation,) * depth
    else:
        pattern = tuple(activation)
    if len(pattern) != depth:
        raise ValueError(f"activation pattern {pattern} for {depth} hidden "
                         "layers")
    unknown = sorted(set(pattern) - set(ACTIVATIONS))
    if unknown:
        raise ValueError(f"unknown activation(s) {unknown}: expected "
                         f"{tuple(ACTIVATIONS)} or 'sanqs_paper'")
    return pattern


def bias_pattern(bias, depth_plus_1: int) -> Tuple[bool, ...]:
    """Bias on or off a layer, the output layer last (JAX
    ``bias_pattern``). Raises ``ValueError`` on a tuple of another
    length."""
    if isinstance(bias, bool):
        return (bias,) * depth_plus_1
    pattern = tuple(bool(b) for b in bias)
    if len(pattern) != depth_plus_1:
        raise ValueError(f"bias pattern {pattern} for {depth_plus_1} layers")
    return pattern


def check_patterns(spec) -> None:
    """Raise ``ValueError`` where a MADE or NADE spec's activation, bias or
    compute dtype is not one the nets take."""
    depth = len(spec.hidden_widths)
    activation_pattern(spec.activation, depth)
    bias_pattern(spec.bias, depth + 1)
    check_compute_dtype(spec.compute_dtype)


def mlp_apply(spec, params: Dict, weights, h) -> torch.Tensor:
    """The hidden layers and the output layer of a MADE or NADE net on the
    encoded input ``h``; ``weights[i]`` is layer i's (masked) weight and
    ``params`` holds the biases the pattern keeps (JAX ``made_apply``'s
    loop): activation, then the residual where the widths match from the
    second hidden layer on, each activation stored at the compute dtype."""
    n_layers = len(spec.hidden_widths)
    acts = activation_pattern(spec.activation, n_layers)
    prec, cdt = spec.matmul_precision, spec.compute_dtype
    h = store(h, cdt)
    for i in range(n_layers):
        z = matmul(h, store(weights[i], cdt), prec)
        if f"b{i}" in params:
            z = z + params[f"b{i}"]
        z = ACTIVATIONS[acts[i]](z)
        if spec.residual and i > 0 and z.shape == h.shape:
            z = z + h
        h = store(z, cdt)
    out = matmul(h, store(weights[n_layers], cdt), prec)
    if f"b{n_layers}" in params:
        out = out + params[f"b{n_layers}"]
    return out


def glorot_layers(dims, use_bias, generator: torch.Generator) -> Dict:
    """Glorot-normal ``w{i}`` (fan_in, fan_out) and zero ``b{i}`` where
    ``use_bias[i]``, layer by layer, on the CPU from ``generator``."""
    params = {}
    for i in range(len(dims) - 1):
        scale = math.sqrt(2.0 / (dims[i] + dims[i + 1]))
        params[f"w{i}"] = scale * torch.randn(
            dims[i], dims[i + 1], generator=generator, dtype=torch.float32
        )
        if use_bias[i]:
            params[f"b{i}"] = torch.zeros(dims[i + 1], dtype=torch.float32)
    return params


def made_init(spec: MadeSpec, generator: torch.Generator) -> Dict:
    """Glorot-normal weights, zero biases where the pattern keeps them, on
    the CPU from ``generator``."""
    dims = [spec.qubit_num, *spec.hidden_widths, spec.out_dim]
    return glorot_layers(dims, bias_pattern(spec.bias, len(dims) - 1),
                         generator)


def made_apply(spec: MadeSpec, params: Dict, masks, bits) -> torch.Tensor:
    """bits (B, n) in {0,1} -> (B, Q, D, C) raw conditional outputs.

    Input encoding x -> 1 - 2x; the layers of ``mlp_apply`` with each
    weight multiplied by its causal mask.
    """
    n_layers = len(spec.hidden_widths)
    weights = [params[f"w{i}"] * masks[i] for i in range(n_layers + 1)]
    out = mlp_apply(spec, params, weights, 1.0 - 2.0 * bits.to(torch.float32))
    return out.reshape(
        *bits.shape[:-1], spec.qudit_num, spec.max_qudit_dim, spec.n_channels
    )


class MADE(nn.Module):
    """``made_apply`` with its parameters (``w{i}``, ``b{i}``) and masks."""

    def __init__(self, spec: MadeSpec, generator: torch.Generator):
        super().__init__()
        check_patterns(spec)
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
