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

Incremental decoding for an ancestral draw: ``decode(cache, prev, q)``
runs position q alone for B rows against a ``DecodeCache`` (each layer's
keys and values of positions < q) and returns ``forward``'s column q of the
same prefixes up to float32 summation order, rounded where ``forward``
rounds; the draw reorders the cache's rows by each survivor's parent
(``DecodeCache.advance``). Each step is a span ``tx.decode`` counting
``tx_rows`` and ``tx_positions`` (both B).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import spans
from .precision import addmm, check_compute_dtype, einsum, matmul, store

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
        self._decode_cache = None  # the draws' ``DecodeCache``
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

    def decode_cache(self, rows: int, device) -> "DecodeCache":
        """The net's ``DecodeCache`` for draws of up to ``rows`` frontier
        rows on ``device``, holding the weights as they are now: kept from
        the last draw while its rows, device and parameter storage are the
        same (its CUDA graphs read them), else made anew."""
        cache = self._decode_cache
        if cache is None or not cache.serves(self, rows, device):
            cache = self._decode_cache = DecodeCache(self, rows, device)
        else:
            cache.refresh(self)
        return cache

    def decode(self, cache: "DecodeCache", prev: torch.Tensor,
               q: int) -> torch.Tensor:
        """Position ``q`` alone for B rows: ``prev`` (B,) int64 holds each
        row's value at qudit q - 1 (at q = 0 only its length is read: the
        start token). Writes the position's keys and values into rows :B of
        ``cache``, attends to the q + 1 cached positions and returns the
        (B, D, C) output, ``forward``'s column q of the same prefixes. On a
        CUDA device each (q, B) is one CUDA graph, captured at its first
        call and replayed after (``DecodeCache.replay``)."""
        with spans.span("tx.decode"):
            spans.count("tx_rows", prev.shape[0])
            spans.count("tx_positions", prev.shape[0])
            if cache.kv.is_cuda:
                return cache.replay(self, prev, q)
            return self._decode(cache, prev, q)

    def _decode(self, cache, prev, q):
        spec = self.spec
        b, d, n_heads = prev.shape[0], spec.d_model, spec.n_heads
        d_head = d // n_heads
        prec, cdt = spec.matmul_precision, spec.compute_dtype
        tok = self.start.expand(b, d) if q == 0 else self.embed[q - 1][prev]
        h = store(tok + self.pos[q], cdt)
        for layer, (wqkv, wo, ff1, ff2) in enumerate(cache.weights):
            p = getattr(self, f"layer{layer}")
            x = store(F.layer_norm(h, (d,), p.ln1_scale, p.ln1_bias, LN_EPS),
                      cdt)
            qkv = matmul(x, wqkv, prec)  # (B, 3d): queries, keys, values
            kv = cache.kv[layer, :, :b]  # (2, B, H, Q, d_head)
            kv[:, :, :, q] = qkv[:, d:].view(b, 2, n_heads,
                                             d_head).transpose(0, 1)
            qh = qkv[:, :d].reshape(b * n_heads, 1, d_head)
            keys, values = (t[:, :, :q + 1].reshape(b * n_heads, q + 1,
                                                    d_head) for t in kv)
            logits = matmul(qh, keys.transpose(1, 2), prec) / math.sqrt(
                d_head)
            attn = store(torch.softmax(logits, dim=-1), cdt)
            ctx = matmul(attn, values, prec).view(b, d)
            h = addmm(h, store(ctx, cdt), wo, prec)
            x = store(F.layer_norm(h, (d,), p.ln2_scale, p.ln2_bias, LN_EPS),
                      cdt)
            ff = F.gelu(addmm(p.ff1_b, x, ff1, prec), approximate="tanh")
            h = addmm(h, store(ff, cdt), ff2, prec) + p.ff2_b
        out = addmm(self.head_b, store(h, cdt), cache.head, prec)
        return out.reshape(b, spec.max_qudit_dim, spec.n_channels)


class DecodeCache:
    """A net's state for ``Transformer.decode``, kept across draws.
    ``kv``: one float32 buffer (L, 2, rows, n_heads, Q, d_head), allocated
    at the draws' capacity, whose ``kv[l, 0]`` and ``kv[l, 1]`` are layer
    l's keys and values; a draw writes each row's positions before it reads
    them, and rows past its frontier hold what they held (the draw gates
    them dead). ``weights``: each layer's (q|k|v side by side, wo, ff1,
    ff2) and ``head``, at the compute dtype, copied in at the start of
    each draw (``refresh``). On a CUDA device, one CUDA graph a (q, B),
    all in one memory pool: a decode is then one launch, where its ~45
    kernels would each cost the host a launch."""

    def __init__(self, net: Transformer, rows: int, device):
        spec = net.spec
        self.kv = torch.zeros(
            (spec.n_layers, 2, rows, spec.n_heads, spec.qudit_num,
             spec.d_model // spec.n_heads),
            dtype=torch.float32, device=device)
        with torch.no_grad():
            self.weights = [tuple(w.clone() for w in ws)
                            for ws in _decode_weights(net)]
            self.head = store(net.head, spec.compute_dtype).clone()
        self._storage = _storage(net)
        self._graphs = {}
        self._pool = None

    def serves(self, net: Transformer, rows: int, device) -> bool:
        """Whether draws of ``rows`` rows on ``device`` can keep this
        cache: the same capacity and device, and the parameters where the
        graphs read them."""
        return (self.kv.shape[2] == rows
                and self.kv.device == torch.empty(0, device=device).device
                and self._storage == _storage(net))

    @torch.no_grad()
    def refresh(self, net: Transformer):
        """Copy the net's present weights in."""
        for held, now in zip(self.weights, _decode_weights(net)):
            for a, b in zip(held, now):
                a.copy_(b)
        self.head.copy_(store(net.head, net.spec.compute_dtype))

    def advance(self, parent: torch.Tensor, q: int):
        """After qudit ``q``'s top-k: row i takes the keys and values of
        positions 0..q of row ``parent[i]``, as the frontier's words do."""
        n = parent.shape[0]
        self.kv[:, :, :n, :, :q + 1] = self.kv[:, :, parent, :, :q + 1]

    def replay(self, net: Transformer, prev: torch.Tensor,
               q: int) -> torch.Tensor:
        """``net._decode`` as the CUDA graph of (q, B): captured at the
        first call, after one eager run on a side stream (which initialises
        the libraries outside the capture), replayed from a copy of
        ``prev`` in its input buffer; the output is a copy of the graph's."""
        entry = self._graphs.get((q, prev.shape[0]))
        if entry is None:
            held = prev.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                net._decode(self, held, q)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool):
                out = net._decode(self, held, q)
            self._pool = graph.pool()
            entry = self._graphs[(q, prev.shape[0])] = (held, graph, out)
        held, graph, out = entry
        held.copy_(prev)
        graph.replay()
        return out.clone()


def _decode_weights(net: Transformer):
    """Each layer's decode weights (``DecodeCache.weights``), at the
    compute dtype."""
    cdt = net.spec.compute_dtype
    for layer in range(net.spec.n_layers):
        p = getattr(net, f"layer{layer}")
        yield tuple(store(w, cdt) for w in (
            torch.cat([p.wq, p.wk, p.wv], 1), p.wo, p.ff1, p.ff2))


def _storage(net: Transformer):
    return tuple(p.data_ptr() for p in net.parameters())
