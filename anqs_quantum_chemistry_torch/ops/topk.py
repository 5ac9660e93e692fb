"""Exact top-k selection in ``jax.lax.top_k``'s order.

Counterpart of the JAX package's ``ops/topk.py`` (``exact_top_k``). JAX
finds the k-th largest value by a value-domain bisection over an
order-preserving integer image of the values, because ``lax.top_k`` is
costly on the TPU. A stable sort costs no such thing on the GPU, so here
the images are sorted: a stable descending sort of one-to-one images gives
``lax.top_k``'s result for NaN-free input -- values descending, ties to
the lowest index, -0.0 below 0.0 -- where a sort of the floats themselves
(the samplers' ordered top-k, ``sampler._top_k``) ties the two zeros.

The images live in ``int64`` (the port's packed-word rule: this torch
build refuses unsigned shifts and compares), signed: a float maps to its
bit pattern read as a signed integer of its width, with the magnitude of
negatives reversed (the signed form of JAX's sign-magnitude fix-up); an
integer is its own image.
"""

from __future__ import annotations

import torch


def _ordered_int(x: torch.Tensor) -> torch.Tensor:
    """The int64 image of ``x``: x < y <=> image(x) < image(y), one to
    one."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    if x.dtype == torch.float64:
        b, bits = x.view(torch.int64), 64
    else:  # float32; float16 and bfloat16 widen to it exactly
        b, bits = x.to(torch.float32).view(torch.int32).to(torch.int64), 32
    # A non-negative float orders as its bits; a negative one (its sign bit
    # makes it a negative integer) backwards in its magnitude bits.
    magnitude = b & ((1 << (bits - 1)) - 1)
    return torch.where(b >= 0, b, ~magnitude)


def exact_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of 1-D ``x``, values
    descending and ties to the lowest index: ``jax.lax.top_k``'s order.
    ``x`` is float (NaN-free) or integer; ``k`` an int, at most
    ``x.numel()``."""
    n = x.shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"k={k} for {n} values")
    idx = torch.sort(_ordered_int(x), descending=True, stable=True).indices
    idx = idx[:k]
    return x[idx], idx
