"""Grouped Pauli matrix elements: the CUDA kernel, its wrapper and its plain
version.

``fused_matrix_elements(words, tables)`` returns the (B, M) float32 elements
``<x ^ A_m | H | x>`` of packed sources ``words`` -- what the JAX package's
Pallas kernel ``ops/pallas_kernels.py`` ``fused_matrix_elements`` computes
(``PauliEngine.matrix_elements``, ``weights_matmul='pallas'``). On a CUDA
tensor it launches ``csrc/fused_me.cu`` or raises; on a CPU tensor it runs
``matrix_elements_plain``. It counts its launches in
``fused_matrix_elements.launches``, and reports the function's work to an
active ``utils.cost.WorkCounter`` (``me_work``) whichever of the two runs.
It runs inside ``utils/spans.py``'s span ``fused_matrix_elements``, which
counts its ``rows``.

``matrix_elements_plain`` is the JAX package's ``'split'`` form in torch:
unpack, sign matmul, ``mod 2``, then the three bf16 residual splits of the
weight-folded group one-hot, each product rounded once to float32 and the
three added as (s0 + s1) + s2. Each split product is summed in float64
before that rounding, and +-bf16 values of one group sum exactly in float64
(the sums of the packaged molecules need at most 33 of its 53 bits), so the
result does not depend on the order in which the matmul underneath (MKL,
cuBLAS, XLA) sums, nor on how the groups are cut into chunks: the plain
version walks chunks of consecutive groups, each with a dense one-hot of
its own term range only, so that it runs at any term count. The kernel
keeps the same contract and equals it bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import cost, spans
from . import bits as bitops
from . import cuda_build

# The kernel's partition (csrc/fused_me.cu's own constants, which its
# launcher checks): tiles of consecutive groups, at most TILE_GROUPS of them
# and at most TILE_TERMS terms unless a single group holds more; each tile's
# term range cut into SEG_WARPS segments, one a warp.
TILE_GROUPS = 64
TILE_TERMS = 1024
SEG_WARPS = 8
# A segment boundary within seg / SNAP_DIV terms of a group's end moves
# there, so that few groups are cut between segments.
SNAP_DIV = 8
# Terms of one chunk of the plain version (a single group may hold more).
PLAIN_TERM_CHUNK = 1024


class KernelOperands(NamedTuple):
    """What ``csrc/fused_me.cu`` reads besides the rows and group offsets."""

    # (T, 4) int64 for W <= 2, (T, 6) for W <= 4: a term's three splits as
    # float64 bits, then its sign-mask words two to an int64, low first.
    records: torch.Tensor
    # (n_tiles + 1, 2) int32: each tile boundary's group and term offsets.
    tile_starts: torch.Tensor
    # (n_tiles, SEG_WARPS, 4) int32, a warp's part of its tile: its term
    # range [s0, s1), the tile-local group holding s0, and the cut slots
    # (owner warps) of its first and last groups, first | last << 16.
    segments: torch.Tensor


class MatrixElementTables(NamedTuple):
    """The plain version's operands (it builds its dense ones from these:
    ``plain_operands``) and, on a CUDA device only, the kernel's."""

    qubit_num: int
    b_words: torch.Tensor  # (T, W) int64 sign masks (32-bit words)
    splits: torch.Tensor  # (3, T) bfloat16 residual splits of f32 weights
    group_starts: torch.Tensor  # (M + 1,) int32 CSR offsets
    kernel: KernelOperands | None

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


def group_runs(starts, max_terms: int, max_groups: int = 0) -> np.ndarray:
    """Cut the CSR groups into runs of consecutive groups: each run holds
    at most ``max_terms`` terms (unless it is a single group) and, if
    ``max_groups`` > 0, at most that many groups. Returns the run
    boundaries as group indices, from 0 to M."""
    starts = np.asarray(starts, dtype=np.int64)
    bounds = [0]
    for m in range(len(starts) - 1):
        m0 = bounds[-1]
        if m > m0 and (m - m0 == max_groups
                       or starts[m + 1] - starts[m0] > max_terms):
            bounds.append(m)
    bounds.append(len(starts) - 1)
    return np.asarray(bounds, dtype=np.int64)


def term_records(b_words: np.ndarray, splits: torch.Tensor) -> torch.Tensor:
    """The kernel's per-term records (``KernelOperands.records``)."""
    b = np.asarray(b_words).astype(np.uint64)
    n_terms, n_words = b.shape
    rec = np.zeros((n_terms, 4 if n_words <= 2 else 6), dtype=np.uint64)
    rec[:, :3] = splits.to(torch.float64).T.numpy().view(np.uint64)
    for j in range(n_words):
        rec[:, 3 + j // 2] |= b[:, j] << np.uint64(32 * (j % 2))
    return torch.from_numpy(rec.view(np.int64))


def tile_segments(g: np.ndarray) -> np.ndarray:
    """The (SEG_WARPS, 4) parts (``KernelOperands.segments``) of one tile
    whose groups start at ``g[:-1]`` and end at ``g[-1]``: its term range
    cut into SEG_WARPS segments of equal length, blind to groups, except
    that a boundary within seg / SNAP_DIV terms of a group's end moves
    there. A group cut between segments is owned by the first warp whose
    segment starts inside it: the others add their partial sums into that
    warp's slot, and it rounds the total."""
    t0, t1 = int(g[0]), int(g[-1])
    seg = -(-(t1 - t0) // SEG_WARPS)
    snap = seg // SNAP_DIV
    s = [t0]
    for k in range(1, SEG_WARPS):
        b = min(t0 + k * seg, t1)
        m = np.searchsorted(g, b, side="right") - 1
        if b < t1:
            down, up = b - g[m], g[m + 1] - b
            if down <= up and down <= snap:
                b = int(g[m])
            elif up < down and up <= snap:
                b = int(g[m + 1])
        s.append(b)
    s.append(t1)
    s = np.asarray(s, dtype=np.int64)
    first = np.searchsorted(g, s[:-1], side="right") - 1
    last = np.searchsorted(g, s[1:] - 1, side="right") - 1
    busy = s[:-1] < s[1:]
    owner = {}
    for k in np.flatnonzero(busy & (g[first] < s[:-1])):
        owner.setdefault(int(first[k]), int(k))
    parts = np.zeros((SEG_WARPS, 4), dtype=np.int64)
    for k in np.flatnonzero(busy):
        parts[k] = (s[k], s[k + 1], first[k],
                    owner.get(int(first[k]), 0)
                    | owner.get(int(last[k]), 0) << 16)
    return parts


def kernel_operands(ham, splits: torch.Tensor, starts: np.ndarray,
                    device) -> KernelOperands:
    """The kernel's operands of a ``PauliHamiltonian``: its term records
    and the partition of its groups into tiles and of each tile's terms
    into warp segments."""
    tiles = group_runs(starts, TILE_TERMS, TILE_GROUPS)
    segments = np.stack([tile_segments(starts[m0:m1 + 1])
                         for m0, m1 in zip(tiles[:-1], tiles[1:])])
    tiles = np.stack([tiles, starts[tiles]], axis=1)
    return KernelOperands(
        records=term_records(ham.b_words, splits).to(device),
        tile_starts=torch.from_numpy(tiles.astype(np.int32)).to(device),
        segments=torch.from_numpy(segments.astype(np.int32)).to(device),
    )


def build_tables(ham, device) -> MatrixElementTables:
    """Device tables of a ``PauliHamiltonian``; the kernel's operands only
    on a CUDA device, the only one that reads them."""
    weights = torch.from_numpy(np.asarray(ham.weights).astype(np.float32))
    starts = np.asarray(ham.group_starts).astype(np.int64)
    if np.any(np.diff(starts) < 1):
        raise ValueError("every group needs at least one term")
    splits = bf16_splits(weights)
    kernel = (kernel_operands(ham, splits, starts, device)
              if torch.device(device).type == "cuda" else None)
    return MatrixElementTables(
        qubit_num=ham.qubit_num,
        b_words=torch.from_numpy(
            np.asarray(ham.b_words).astype(np.int64)
        ).to(device),
        splits=splits.to(device),
        group_starts=torch.from_numpy(starts.astype(np.int32)).to(device),
        kernel=kernel,
    )


def _sign_bits(b_words: torch.Tensor, qubit_num: int) -> torch.Tensor:
    """(T, W) sign masks -> (n, T) float32 0/1."""
    j = torch.arange(qubit_num, device=b_words.device)
    return ((b_words[:, j // 32] >> (j % 32)) & 1).T.to(torch.float32)


def _one_hot(splits: torch.Tensor, group_starts: torch.Tensor,
             dtype) -> torch.Tensor:
    """(3, T) splits of T consecutive terms and the (M + 1,) offsets of
    their groups (from 0) -> the (3, T, M) weight-folded group one-hots."""
    n_terms, n_groups = splits.shape[1], group_starts.shape[0] - 1
    dev = splits.device
    group_id = torch.repeat_interleave(
        torch.arange(n_groups, device=dev),
        torch.diff(group_starts.to(torch.int64)),
    )
    dense = torch.zeros((3, n_terms, n_groups), dtype=dtype, device=dev)
    dense[:, torch.arange(n_terms, device=dev), group_id] = splits.to(dtype)
    return dense


def plain_operands(tables: MatrixElementTables):
    """The dense operands of the JAX engine (``b_bits``,
    ``group_weight_splits``): the (n, T) float32 0/1 sign masks and the
    (3, T, M) bfloat16 weight-folded group one-hots."""
    return (_sign_bits(tables.b_words, tables.qubit_num),
            _one_hot(tables.splits, tables.group_starts, torch.bfloat16))


def matrix_elements_plain(words: torch.Tensor,
                          tables: MatrixElementTables) -> torch.Tensor:
    """(B, W) packed sources -> (B, M) float32, the JAX 'split' form, one
    chunk of consecutive groups of at most ``PLAIN_TERM_CHUNK`` terms at a
    time."""
    x = bitops.unpack(words, tables.qubit_num, dtype=torch.float32)
    starts = tables.group_starts.cpu().numpy().astype(np.int64)
    out = torch.empty((words.shape[0], tables.n_groups),
                      dtype=torch.float32, device=words.device)
    bounds = group_runs(starts, PLAIN_TERM_CHUNK)
    for m0, m1 in zip(bounds[:-1], bounds[1:]):
        t0, t1 = starts[m0], starts[m1]
        # exact: 0/1 operands, small integer sums
        p = x @ _sign_bits(tables.b_words[t0:t1], tables.qubit_num)
        sign = (1.0 - 2.0 * torch.remainder(p, 2.0)).to(torch.float64)
        dense = _one_hot(tables.splits[:, t0:t1],
                         tables.group_starts[m0:m1 + 1] - int(t0),
                         torch.float64)
        me = None
        for part in dense:
            term = (sign @ part).to(torch.float32)
            me = term if me is None else me + term
        out[:, m0:m1] = me
    return out


def _library():
    lib = cuda_build.load("fused_me")
    if lib.fused_me_launch.argtypes is None:
        lib.fused_me_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        lib.fused_me_launch.restype = ctypes.c_int
    return lib


def me_work(n_rows: int, n_words: int, tables: MatrixElementTables):
    """(flops, bytes) of the function on ``n_rows`` rows of ``n_words``
    words, as the kernel table's bound counts them: three float64 FMAs a
    (row, term) pair; each operand read once -- 4 B a 32-bit word, a
    term's W sign-mask words and three bf16 splits (4W + 6 B), the group
    offsets -- and the (B, M) float32 output written once."""
    n_terms = tables.splits.shape[1]
    return (6 * n_rows * n_terms,
            4 * n_rows * n_words + n_terms * (4 * n_words + 6)
            + 4 * tables.group_starts.numel() + 4 * n_rows * tables.n_groups)


def fused_matrix_elements(words: torch.Tensor,
                          tables: MatrixElementTables) -> torch.Tensor:
    """(B, W) int64 packed sources -> (B, M) float32 matrix elements."""
    with spans.span("fused_matrix_elements"):
        if words.shape[0]:
            cost.report("fused_matrix_elements",
                        *me_work(*words.shape, tables))
            spans.count("rows", words.shape[0])
        with cost.suspended():
            return _fused_matrix_elements(words, tables)


def _fused_matrix_elements(words, tables):
    if words.device.type == "cpu":
        return matrix_elements_plain(words, tables)
    if words.device.type != "cuda":
        raise ValueError(f"no kernel for device {words.device}")
    dev = words.device
    kern = tables.kernel
    if kern is None:
        raise ValueError("tables without kernel operands (built for the "
                         "CPU)")
    check = cuda_build.check_operand
    check("words", words, torch.int64, 2, dev)
    check("records", kern.records, torch.int64, 2, dev)
    check("group_starts", tables.group_starts, torch.int32, 1, dev)
    check("tile_starts", kern.tile_starts, torch.int32, 2, dev)
    check("segments", kern.segments, torch.int32, 3, dev)
    n_rows, n_words = words.shape
    if (n_words != -(-tables.qubit_num // 32)
            or kern.records.shape[1] != (4 if n_words <= 2 else 6)):
        raise ValueError(
            f"shape mismatch: words {tuple(words.shape)} for "
            f"{tables.qubit_num} qubits, records "
            f"{tuple(kern.records.shape)}"
        )
    out = torch.empty((n_rows, tables.n_groups), dtype=torch.float32,
                      device=dev)
    if n_rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fused_me_launch(
            words.data_ptr(), kern.records.data_ptr(),
            tables.group_starts.data_ptr(), kern.tile_starts.data_ptr(),
            kern.segments.data_ptr(), out.data_ptr(), n_rows, n_words,
            tables.n_groups, kern.segments.shape[0], TILE_GROUPS, SEG_WARPS,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_me_launch failed: cudaError_t {rc}")
    fused_matrix_elements.launches += 1
    return out


fused_matrix_elements.launches = 0
