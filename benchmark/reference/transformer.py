"""A causal transformer autoregressive neural quantum state over qudit
tokens, in plain PyTorch.

The determinant's qubits are cut into Q qudits as in ``ansatz.py``; qudit q
holds the value v_q = sum_j 2^j x_(start_q + j), one of D values. Each of
two decoders (``main``: conditional log|psi|; ``aux``: conditional phase,
times pi) maps the values to raw (Q, D) outputs, where row q depends on
v_0 .. v_(q-1) only:

    h_0 = start + pos_0,   h_q = embed[q - 1, v_(q-1)] + pos_q  (q >= 1)

(a learned start token shifts the sequence right; each position has its
own table of D embeddings, ``embed`` (Q, D, d)). Then L pre-LN blocks,

    a = LN1(h),  Q_h, K_h, V_h = a W_q, a W_k, a W_v  split into H heads of d/H
    h <- h + concat_h(softmax_k(Q_h K_h^T / sqrt(d/H), k <= q) V_h) W_o
    h <- h + gelu(LN2(h) W_1 + b_1) W_2 + b_2

with LN(x) = (x - mean) / sqrt(var + 1e-5) * scale + bias (the biased
variance), gelu(u) = u/2 (1 + tanh(sqrt(2/pi) (u + 0.044715 u^3))) and no
biases on the four projections; the head is out = h W_head + b_head, (Q, D).
No layer norm before the head. The conditionals are then capped, centred,
masked to the sector and normalised as ``ansatz.MadeAnqs`` does.

Everything runs in float32 with TF32 off (set when a network is made); the
rows go through in blocks of ``ROW_BLOCK``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .ansatz import MadeAnqs

# Rows a decoder computes at once.
ROW_BLOCK = 2048
LN_EPS = 1e-5


class TransformerAnqs(MadeAnqs):
    """log|psi| and phase of determinants given as (B, n) 0/1 bits, with
    the two decoders of the module doc in place of MADE's networks."""

    def __init__(self, qubit_num: int, n_alpha: int, n_beta: int,
                 qubit_per_qudit: int, logit_cap: Optional[float],
                 n_heads: int, n_layers: int, device="cpu"):
        super().__init__(qubit_num, n_alpha, n_beta, qubit_per_qudit,
                         logit_cap, device)
        self.n_heads, self.n_layers = int(n_heads), int(n_layers)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def made(self, p: Dict[str, torch.Tensor], prefix: str, x):
        """Raw (B, Q, D) outputs of the decoder ``prefix`` on the +-1
        inputs x = 1 - 2 bits."""
        vals = self.values((x < 0).to(torch.int64))
        return torch.cat([self.decoder(p, prefix, vals[i:i + ROW_BLOCK])
                          for i in range(0, vals.shape[0], ROW_BLOCK)])

    def decoder(self, p: Dict[str, torch.Tensor], prefix: str, vals):
        """(B, Q, D) raw outputs of one decoder on (B, Q) qudit values."""
        b, q = vals.shape
        embed = p[f"{prefix}.embed"]
        d = embed.shape[-1]
        heads = self.n_heads
        dh = d // heads
        tokens = embed[torch.arange(q, device=vals.device)[None, :], vals]
        start = p[f"{prefix}.start"].expand(b, 1, d)
        h = torch.cat([start, tokens[:, :q - 1]], 1) + p[f"{prefix}.pos"]
        allowed = torch.ones(q, q, dtype=torch.bool,
                             device=vals.device).tril()
        for layer in range(self.n_layers):
            w = {k: p[f"{prefix}.layer{layer}.{k}"] for k in (
                "wq", "wk", "wv", "wo", "ln1_scale", "ln1_bias",
                "ln2_scale", "ln2_bias", "ff1", "ff1_b", "ff2", "ff2_b")}
            a = layer_norm(h, w["ln1_scale"], w["ln1_bias"])
            qh, kh, vh = ((a @ w[k]).reshape(b, q, heads, dh).transpose(1, 2)
                          for k in ("wq", "wk", "wv"))
            scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
            scores = scores.masked_fill(~allowed, float("-inf"))
            ctx = torch.softmax(scores, -1) @ vh
            h = h + ctx.transpose(1, 2).reshape(b, q, d) @ w["wo"]
            a = layer_norm(h, w["ln2_scale"], w["ln2_bias"])
            u = a @ w["ff1"] + w["ff1_b"]
            g = 0.5 * u * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                            * (u + 0.044715 * u ** 3)))
            h = h + g @ w["ff2"] + w["ff2_b"]
        return h @ p[f"{prefix}.head"] + p[f"{prefix}.head_b"]


def layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias
