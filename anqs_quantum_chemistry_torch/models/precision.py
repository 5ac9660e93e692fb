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

``AnqsConfig.compute_dtype`` is another knob: with 'bfloat16' the JAX nets
cast each matmul operand to bfloat16 and *store* each layer's activation in
bfloat16 (``h = z.astype(cdt)``, JAX ``models/made.py:157``), so residual
adds and the next layer read rounded values. ``store`` rounds a float32
tensor to the values bfloat16 can hold and keeps it float32; the matmuls
then stay strict float32, in which products of bfloat16 values are exact.
Both knobs may be set at once (rounding twice is rounding once).
"""

from __future__ import annotations

from typing import Optional

import torch

FLOAT32 = (None, "default", "float32", "highest")
PRECISIONS = FLOAT32 + ("bfloat16",)
COMPUTE_DTYPES = ("float32", "bfloat16")


def check_precision(precision) -> Optional[str]:
    """``precision`` -> 'bfloat16' or None (strict float32); raises
    ``ValueError`` on a value that is not in ``PRECISIONS``."""
    if precision in FLOAT32:
        return None
    if precision == "bfloat16":
        return precision
    raise ValueError(f"matmul_precision={precision!r}: expected one of "
                     f"{PRECISIONS}")


def check_compute_dtype(compute_dtype) -> str:
    """``compute_dtype`` as given; raises ``ValueError`` on a value that is
    not in ``COMPUTE_DTYPES``."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={compute_dtype!r}: expected one of "
                         f"{COMPUTE_DTYPES}")
    return compute_dtype


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def store(x: torch.Tensor, compute_dtype: str = "float32") -> torch.Tensor:
    """``x`` as the JAX nets hold it at ``compute_dtype``: rounded to
    bfloat16 (round to nearest even) and kept float32, or unchanged."""
    return _round(x) if compute_dtype == "bfloat16" else x


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: Optional[str] = None) -> torch.Tensor:
    """``a @ b`` at ``precision`` (a value ``check_precision`` returned)."""
    if precision is None:
        return a @ b
    return _round(a) @ _round(b)


def addmm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          precision: Optional[str] = None) -> torch.Tensor:
    """``c + matmul(a, b, precision)`` in one call (``torch.addmm``; the
    product is float32 either way, so the sum rounds once)."""
    if precision is None:
        return torch.addmm(c, a, b)
    return torch.addmm(c, _round(a), _round(b))


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor,
           precision: Optional[str] = None) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` at ``precision``."""
    if precision is None:
        return torch.einsum(equation, a, b)
    return torch.einsum(equation, _round(a), _round(b))
