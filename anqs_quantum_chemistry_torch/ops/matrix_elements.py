"""Grouped Pauli matrix elements: the CUDA kernel, its wrapper and its plain
version.

``fused_matrix_elements(words, tables)`` returns the (B, M) float32 elements
``<x ^ A_m | H | x>`` of packed sources ``words`` -- what the JAX package's
Pallas kernel ``ops/pallas_kernels.py`` ``fused_matrix_elements`` computes
(``PauliEngine.matrix_elements``, ``weights_matmul='pallas'``). On a CUDA
tensor it launches ``csrc/fused_me.cu`` or raises; on a CPU tensor it runs
``matrix_elements_plain``. It counts its launches in
``fused_matrix_elements.launches``.

``matrix_elements_plain`` is the JAX package's ``'split'`` form in torch:
unpack, sign matmul, ``mod 2``, then the three bf16 residual splits of the
weight-folded group one-hot, each product rounded once to float32 and the
three added as (s0 + s1) + s2. Each split product is summed in float64
before that rounding, so the result does not depend on the order in which
the matmul underneath (MKL, cuBLAS, XLA) sums; the kernel keeps the same
contract, and on the N2 sector both equal the JAX split path bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import bits as bitops
from . import cuda_build


class MatrixElementTables(NamedTuple):
    """The kernel's operands; the plain version builds its dense ones from
    these (``plain_operands``)."""

    qubit_num: int
    b_words: torch.Tensor  # (T, W) int64 sign masks (32-bit words)
    splits: torch.Tensor  # (3, T) bfloat16 residual splits of f32 weights
    group_starts: torch.Tensor  # (M + 1,) int32 CSR offsets

    @property
    def n_groups(self) -> int:
        return self.group_starts.shape[0] - 1


def bf16_splits(x: torch.Tensor) -> torch.Tensor:
    """Three successive bf16 residual rounds of float32 ``x``: their f32
    sum reproduces ``x`` to its full mantissa (JAX ``pauli.py:233-241``)."""
    parts, residual = [], x.to(torch.float32)
    for _ in range(3):
        part = residual.to(torch.bfloat16)
        parts.append(part)
        residual = residual - part.to(torch.float32)
    return torch.stack(parts)


def build_tables(ham, device) -> MatrixElementTables:
    """Device tables of a ``PauliHamiltonian``."""
    weights = torch.from_numpy(np.asarray(ham.weights).astype(np.float32))
    starts = np.asarray(ham.group_starts).astype(np.int32)
    return MatrixElementTables(
        qubit_num=ham.qubit_num,
        b_words=torch.from_numpy(
            np.asarray(ham.b_words).astype(np.int64)
        ).to(device),
        splits=bf16_splits(weights).to(device),
        group_starts=torch.from_numpy(starts).to(device),
    )


def plain_operands(tables: MatrixElementTables):
    """The dense operands of the JAX engine (``b_bits``,
    ``group_weight_splits``): the (n, T) float32 0/1 sign masks and the
    (3, T, M) bfloat16 weight-folded group one-hots."""
    n_terms = tables.b_words.shape[0]
    j = torch.arange(tables.qubit_num, device=tables.b_words.device)
    b_bits = ((tables.b_words[:, j // 32] >> (j % 32)) & 1).T
    group_id = torch.repeat_interleave(
        torch.arange(tables.n_groups, device=j.device),
        torch.diff(tables.group_starts.to(torch.int64)),
    )
    dense = torch.zeros((3, n_terms, tables.n_groups), dtype=torch.bfloat16,
                        device=j.device)
    dense[:, torch.arange(n_terms, device=j.device), group_id] = tables.splits
    return b_bits.to(torch.float32), dense


def matrix_elements_plain(words: torch.Tensor,
                          tables: MatrixElementTables) -> torch.Tensor:
    """(B, W) packed sources -> (B, M) float32, the JAX 'split' form."""
    b_bits, group_splits = plain_operands(tables)
    x = bitops.unpack(words, tables.qubit_num, dtype=torch.float32)
    p = x @ b_bits  # exact: 0/1 operands, small integer sums
    sign = (1.0 - 2.0 * torch.remainder(p, 2.0)).to(torch.float64)
    me = None
    for part in group_splits:
        term = (sign @ part.to(torch.float64)).to(torch.float32)
        me = term if me is None else me + term
    return me


def _library():
    lib = cuda_build.load("fused_me")
    if lib.fused_me_launch.argtypes is None:
        lib.fused_me_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.fused_me_launch.restype = ctypes.c_int
    return lib


def fused_matrix_elements(words: torch.Tensor,
                          tables: MatrixElementTables) -> torch.Tensor:
    """(B, W) int64 packed sources -> (B, M) float32 matrix elements."""
    if words.device.type == "cpu":
        return matrix_elements_plain(words, tables)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    dev = words.device
    check = cuda_build.check_operand
    check("words", words, torch.int64, 2, dev)
    check("b_words", tables.b_words, torch.int64, 2, dev)
    check("splits", tables.splits, torch.bfloat16, 2, dev)
    check("group_starts", tables.group_starts, torch.int32, 1, dev)
    n_rows, n_words = words.shape
    n_terms = tables.b_words.shape[0]
    if tables.b_words.shape[1] != n_words or tables.splits.shape != (
        3, n_terms
    ):
        raise ValueError(
            f"shape mismatch: words {tuple(words.shape)}, b_words "
            f"{tuple(tables.b_words.shape)}, splits "
            f"{tuple(tables.splits.shape)}"
        )
    out = torch.empty((n_rows, tables.n_groups), dtype=torch.float32,
                      device=dev)
    if n_rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fused_me_launch(
            words.data_ptr(), tables.b_words.data_ptr(),
            tables.splits.data_ptr(), tables.group_starts.data_ptr(),
            out.data_ptr(), n_rows, n_words, n_terms, tables.n_groups,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_me_launch failed: cudaError_t {rc}")
    fused_matrix_elements.launches += 1
    return out


fused_matrix_elements.launches = 0
