"""Causal transformer ansatz over qudit tokens.

Counterpart of the JAX package's ``models/transformer.py``: tokens are qudits
(up to 2^width values each), a learned start token shifts the sequence right
so that position q attends only to qudits < q, and the head emits (D, C)
conditional channels a position. Pre-LN blocks (biased-variance LayerNorm,
eps 1e-5), causal logits filled with -1e30 before the softmax, and the
tanh-approximate GELU (``jax.nn.gelu``'s default). Parameters keep the JAX
names and layouts -- ``embed`` (Q, D, d), ``pos`` (Q, d), ``start`` (d),
``layer{i}.{wq,wk,wv,wo,ln1_*,ln2_*,ff1,ff1_b,ff2,ff2_b}`` with weights as
(fan_in, fan_out), ``head`` (d, D*C) and ``head_b`` -- so
``convert.params_from_jax`` loads a JAX parameter tree as it is. Float32
tensors throughout (TF32 is off for the process,
``anqs_quantum_chemistry_torch``); the matmuls multiply at
``spec.matmul_precision`` (``precision.py``). At ``compute_dtype``
'bfloat16' the operands JAX casts to bfloat16 are rounded where JAX casts
them (``precision.store``; JAX ``models/transformer.py:130-179``): the
embedded input, each layer norm's output, the weights, the attention
weights, the context, the feed-forward activation and the head's input; the
layer norms, the projections' outputs and the residual stream after the
first attention block stay float32.

Interface of ``made.MADE``: ``forward(bits (B, n)) -> (B, Q, D, C)``.
Each forward is a span ``tx.forward`` (``utils/spans.py``) counting its
rows ``tx_rows`` (B) and the positions it ran through the stack
``tx_positions`` (B x Q), from shapes alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import spans
from .precision import check_compute_dtype, einsum, matmul, store

LN_EPS = 1e-5
MASKED_LOGIT = -1e30  # causal fill: finite, as in the JAX package


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    qubit_num: int
    qudit_starts: Tuple[int, ...]
    qudit_ends: Tuple[int, ...]
    max_qudit_dim: int
    n_channels: int = 1
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    # 'bfloat16' or None (float32): ``precision.check_precision``'s value.
    matmul_precision: Optional[str] = None
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    @property
    def qudit_num(self) -> int:
        return len(self.qudit_starts)


def transformer_init(spec: TransformerSpec,
                     generator: torch.Generator) -> Dict:
    """JAX's initial scales, drawn on the CPU from ``generator`` in JAX's
    key order: Glorot normal sqrt(2 / (fan_in + fan_out)) for every weight,
    0.02 normal for ``pos`` and ``start``, LayerNorm scales 1, biases 0.
    Returns a nested dict (``layer{i}`` entries are dicts)."""
    q, d = spec.qudit_num, spec.d_model

    def normal(shape, scale):
        return scale * torch.randn(*shape, generator=generator,
                                   dtype=torch.float32)

    def glorot(shape):
        return normal(shape, math.sqrt(2.0 / (shape[-2] + shape[-1])))

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32)

    params = {
        "embed": glorot((q, spec.max_qudit_dim, d)),
        "pos": normal((q, d), 0.02),
        "start": normal((d,), 0.02),
    }
    for layer in range(spec.n_layers):
        p = {name: glorot((d, d)) for name in ("wq", "wk", "wv", "wo")}
        for ln in ("ln1", "ln2"):
            p[f"{ln}_scale"] = torch.ones(d, dtype=torch.float32)
            p[f"{ln}_bias"] = zeros(d)
        p["ff1"] = glorot((d, spec.d_ff))
        p["ff1_b"] = zeros(spec.d_ff)
        p["ff2"] = glorot((spec.d_ff, d))
        p["ff2_b"] = zeros(d)
        params[f"layer{layer}"] = p
    out = spec.max_qudit_dim * spec.n_channels
    params["head"] = glorot((d, out))
    params["head_b"] = zeros(out)
    return params


def _layer_norm(x, scale, bias):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


class _Block(nn.Module):
    """One pre-LN block's parameters (``layer{i}.*``)."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))


class Transformer(nn.Module):
    """``transformer_apply`` of the JAX package with its parameters."""

    def __init__(self, spec: TransformerSpec, generator: torch.Generator):
        super().__init__()
        if spec.d_model % spec.n_heads:
            raise ValueError(f"d_model {spec.d_model} is not a multiple of "
                             f"n_heads {spec.n_heads}")
        check_compute_dtype(spec.compute_dtype)
        self.spec = spec
        for name, value in transformer_init(spec, generator).items():
            if isinstance(value, dict):
                self.add_module(name, _Block(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def reset_parameters(self, generator: torch.Generator):
        fresh = transformer_init(self.spec, generator)
        with torch.no_grad():
            for name, value in fresh.items():
                if isinstance(value, dict):
                    block = getattr(self, name)
                    for pname, pvalue in value.items():
                        getattr(block, pname).copy_(pvalue)
                else:
                    getattr(self, name).copy_(value)

    def qudit_values(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, n) 0/1 -> (B, Q) qudit values (bit j of a qudit = 2^j)."""
        spec = self.spec
        shifts = torch.arange(max(e - s for s, e in zip(spec.qudit_starts,
                                                        spec.qudit_ends)),
                              device=bits.device)
        return torch.stack([
            torch.sum(bits[:, s:e].to(torch.int64) << shifts[:e - s], dim=-1)
            for s, e in zip(spec.qudit_starts, spec.qudit_ends)
        ], 1)

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        """bits (B, n) in {0, 1} -> (B, Q, D, C) conditional outputs."""
        with spans.span("tx.forward"):
            spans.count("tx_rows", bits.shape[0])
            spans.count("tx_positions", bits.shape[0] * self.spec.qudit_num)
            return self._forward(bits)

    def _forward(self, bits: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        b, q_num, d = bits.shape[0], spec.qudit_num, spec.d_model
        n_heads = spec.n_heads
        d_head = d // n_heads
        vals = self.qudit_values(bits)
        qi = torch.arange(q_num, device=bits.device)
        emb = self.embed[qi[None, :], vals]  # (B, Q, d)
        h = torch.cat([self.start.expand(b, 1, d), emb[:, :q_num - 1]], 1)
        prec, cdt = spec.matmul_precision, spec.compute_dtype
        h = store(h + self.pos[None], cdt)
        causal = torch.tril(torch.ones(q_num, q_num, dtype=torch.bool,
                                       device=bits.device))

        def mm(x, w):
            return matmul(store(x, cdt), store(w, cdt), prec)

        for layer in range(spec.n_layers):
            p = getattr(self, f"layer{layer}")
            x = _layer_norm(h, p.ln1_scale, p.ln1_bias)

            def proj(w):
                return mm(x, w).reshape(b, q_num, n_heads, d_head)

            qh, kh, vh = proj(p.wq), proj(p.wk), proj(p.wv)
            logits = einsum("bqhe,bkhe->bhqk", qh, kh, prec) / math.sqrt(
                d_head)
            logits = torch.where(causal, logits, MASKED_LOGIT)
            attn = torch.softmax(logits, dim=-1)
            ctx = einsum("bhqk,bkhe->bqhe", store(attn, cdt), vh,
                         prec).reshape(b, q_num, d)
            h = h + mm(ctx, p.wo)
            x = _layer_norm(h, p.ln2_scale, p.ln2_bias)
            ff = F.gelu(mm(x, p.ff1) + p.ff1_b, approximate="tanh")
            h = h + mm(ff, p.ff2) + p.ff2_b
        out = mm(h, self.head) + self.head_b
        return out.reshape(b, q_num, spec.max_qudit_dim, spec.n_channels)
