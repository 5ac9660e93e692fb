"""The multiply precision of the nets' matmuls (``AnqsConfig.matmul_precision``).

The JAX package runs each net's whole apply under
``jax.default_matmul_precision(prec)`` (JAX ``models/anqs.py``), so every dot
and einsum of MADE, NADE and the transformer multiplies at that precision.
The port routes each of those products through ``matmul`` / ``einsum`` here
with the net's precision, and flips no process-wide flag:
``torch.backends.cuda.matmul.allow_tf32`` stays off for the energy-critical
products of ``observables/pauli.py``.

- ``None``, 'default', 'float32', 'highest': strict IEEE float32, on the
  card and on the CPU alike. This is the port's only arithmetic otherwise.
  (On the TPU, JAX's ``None`` means the backend default, one bf16 pass.)
- 'bfloat16': each operand rounded to bfloat16 (round to nearest even, as
  XLA converts), the products summed in float32 -- the TPU's one-pass
  arithmetic. A product of two bfloat16 values is exact in float32, so a
  float32 matmul of the rounded operands computes just that.

Other values raise ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch

FLOAT32 = (None, "default", "float32", "highest")
PRECISIONS = FLOAT32 + ("bfloat16",)


def check_precision(precision) -> Optional[str]:
    """``precision`` -> 'bfloat16' or None (strict float32); raises
    ``ValueError`` on a value that is not in ``PRECISIONS``."""
    if precision in FLOAT32:
        return None
    if precision == "bfloat16":
        return precision
    raise ValueError(f"matmul_precision={precision!r}: expected one of "
                     f"{PRECISIONS}")


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: Optional[str] = None) -> torch.Tensor:
    """``a @ b`` at ``precision`` (a value ``check_precision`` returned)."""
    if precision is None:
        return a @ b
    return _round(a) @ _round(b)


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor,
           precision: Optional[str] = None) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` at ``precision``."""
    if precision is None:
        return torch.einsum(equation, a, b)
    return torch.einsum(equation, _round(a), _round(b))
