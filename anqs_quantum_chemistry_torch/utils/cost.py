"""The counted work of a piece of the program: flops, transcendentals and
bytes accessed, by the conventions of XLA's ``HloCostAnalysis``, so that
the port's counts sit beside the JAX package's ``step_cost_analysis``.

``WorkCounter`` is a ``TorchDispatchMode``: entered around a training step
(``VMC.step_cost_analysis``), it sees every aten op that runs, forward and
backward, under ``torch.func`` transforms too, and counts each by

- **matmul class** (``torch.utils.flop_counter``'s formulas -- ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention -- and
  ``MATMUL_EXTRA``: ``mv``, ``addmv``, ``dot`` and the LU solve): 2 m n k
  flops, the solve 2/3 n^3 + 2 n^2 k;
- **transcendentals** (``TRANSCENDENTAL``: exp, log, sin, cos, tanh,
  sigmoid, sqrt, rsqrt, pow and their kin): one a element, under
  ``transcendentals`` and not under flops, as XLA counts them;
- **every other floating-point op**: one flop a element of the larger of
  its output and its largest operand (an elementwise op its output, a
  reduction its input); an op with no floating-point operand or output
  (integer and bool ops: the packed words' bit work, sorts of keys, masks)
  and the data movement of ``NO_FLOPS`` (copies, gathers, concatenations,
  fills, random draws) count no flops;
- **bytes accessed**: each tensor operand's bytes read once and each
  output's written once (an in-place op's written operands where it
  returns nothing); views, metadata ops, allocations (``empty``) and ops
  outside the ``aten`` namespace count nothing.

The hand-written kernels' wrappers (``ops/matrix_elements.py``,
``ops/hash_lookup.py``) report their own counts with ``report`` and run
inside ``suspended()``, so the aten ops of a plain version are not
counted: a count does not depend on whether the kernel or its plain
version ran. Outside a counter both are no-ops.

``region(name)`` files the aten ops counted inside it under ``name/``
(``'minsr_jacobians/aten.mm'``), so that a part of the step reads apart in
``by_source``, and opens ``utils/spans.py``'s ``span(name)``: a region and
its span share one name.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from . import spans

BYTES = "bytes accessed"  # JAX's key name


def _mv(args, out):
    m, n = args[0].shape[-2:]
    return 2 * m * n


def _addmv(args, out):
    return _mv(args[1:], out)


def _dot(args, out):
    return 2 * args[0].numel()


def _solve(args, out):
    a, b = args[0], args[1]
    n = a.shape[-1]
    batch = math.prod(a.shape[:-2])
    rhs = 1 if b.dim() == a.dim() - 1 else b.shape[-1]
    return batch * (2 * n ** 3 // 3 + 2 * n * n * rhs)


# Ops of the matmul class beyond ``flop_registry``: name -> flops of
# (args, out).
MATMUL_EXTRA = {"mv": _mv, "addmv": _addmv, "dot": _dot, "vdot": _dot,
                "_linalg_solve_ex": _solve}
TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos",
    "tan", "tanh", "sigmoid", "sqrt", "rsqrt", "pow", "atan2", "asin",
    "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh", "erf",
    "erfc", "erfinv", "logsumexp", "_softmax", "_log_softmax", "logit",
    "gelu", "silu"))
NO_FLOPS = frozenset((
    "copy", "_to_copy", "clone", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "scatter", "index_put", "_index_put_impl",
    "repeat", "roll", "flip", "constant_pad_nd", "fill", "zero", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
    "new_ones", "new_full", "arange", "rand", "randn", "rand_like",
    "randn_like", "randint", "uniform", "normal", "exponential",
    "bernoulli", "binomial", "lift_fresh_copy", "take", "embedding",
    "_local_scalar_dense", "masked_select", "nonzero", "repeat_interleave",
    "scalar_tensor", "_unsafe_index", "select_scatter", "slice_scatter",
    "diagonal_scatter", "as_strided_scatter", "eye", "tril", "triu",
    "_linalg_check_errors", "_assert_async", "resize", "set"))
# Allocations, and views and metadata ops that their schemas do not mark
# as views.
NOTHING = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided", "_unsafe_view", "_reshape_alias",
                     "sym_size", "sym_stride", "sym_numel",
                     "sym_storage_offset", "is_same_size"))


def _base_name(func) -> str:
    """``aten.add_.Tensor`` -> 'add'; ``aten._foreach_sqrt_`` -> 'sqrt'."""
    name = func._overloadpacket.__name__
    if name.startswith("_foreach_"):
        name = name[len("_foreach_"):]
    return name[:-1] if name.endswith("_") and name != "_" else name


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _numel(arg) -> int:
    return sum(t.numel() for t in _tensors(arg))


def _floating(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _active() -> List["WorkCounter"]:
    """The counters entered in this thread (torch's dispatch mode stack)."""
    return [mode for mode in _get_current_dispatch_mode_stack()
            if isinstance(mode, WorkCounter)]


def report(name: str, flops: int = 0, bytes_accessed: int = 0,
           transcendentals: int = 0):
    """Add a hand-written kernel's counts to every active counter."""
    for counter in _active():
        counter.add(name, "kernel", flops, transcendentals, bytes_accessed)


@contextlib.contextmanager
def suspended():
    """Count no aten op inside (a kernel wrapper's own, whichever
    implementation runs)."""
    counters = _active()
    for counter in counters:
        counter.suspended += 1
    try:
        yield
    finally:
        for counter in counters:
            counter.suspended -= 1


@contextlib.contextmanager
def region(name: str):
    """File the aten ops counted inside under ``name/`` in every active
    counter (the backward ops too: they read the counter's prefix on
    whichever thread runs them), inside ``spans.span(name)``."""
    counters = _active()
    saved = [counter.prefix for counter in counters]
    for counter in counters:
        counter.prefix = f"{name}/"
    try:
        with spans.span(name):
            yield
    finally:
        for counter, prefix in zip(counters, saved):
            counter.prefix = prefix


class WorkCounter(TorchDispatchMode):
    """Counts the work of the aten ops run inside it (module docstring).
    ``totals()`` and ``by_source()`` read the counts."""

    def __init__(self):
        super().__init__()
        self.suspended = 0
        self.prefix = ""
        self.sources: Dict[str, Dict] = {}

    def add(self, name, kind, flops, transcendentals, n_bytes):
        entry = self.sources.setdefault(name, {
            "kind": kind, "calls": 0, "flops": 0, "transcendentals": 0,
            BYTES: 0})
        entry["calls"] += 1
        entry["flops"] += int(flops)
        entry["transcendentals"] += int(transcendentals)
        entry[BYTES] += int(n_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (not self.suspended and func.namespace == "aten"
                and not func.is_view):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        base = _base_name(func)
        if base in NOTHING:
            return
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        outs = _tensors(out)
        if not outs:  # an in-place op that returns nothing
            outs = [t for a, arg in zip(func._schema.arguments, args)
                    if a.alias_info is not None and a.alias_info.is_write
                    for t in _tensors(arg)]
        n_bytes = _nbytes(ins) + _nbytes(outs)
        packet = func._overloadpacket
        flops = trans = 0
        kind = "op"
        if packet in flop_registry:
            kind = "matmul"
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif base in MATMUL_EXTRA:
            kind = "matmul"
            flops = MATMUL_EXTRA[base](args, out)
        elif base not in NO_FLOPS and any(map(_floating, ins + outs)):
            elements = max([_numel(outs)] + [
                _numel(a) for a in args if any(map(_floating, _tensors(a)))])
            if base in TRANSCENDENTAL:
                trans = elements
            else:
                flops = elements
        self.add(f"{self.prefix}aten.{packet.__name__}", kind, flops, trans, n_bytes)

    def totals(self) -> Dict[str, int]:
        """{'flops', 'transcendentals', 'bytes accessed'} over every
        source."""
        return {key: sum(e[key] for e in self.sources.values())
                for key in ("flops", "transcendentals", BYTES)}

    def by_source(self) -> Dict[str, Dict]:
        """{source: its counts}, the most flops first (then bytes): an aten
        op by its name ('aten.mm', inside a ``region`` 'name/aten.mm'), a
        kernel by its wrapper's."""
        return dict(sorted(self.sources.items(), key=lambda kv: (
            -kv[1]["flops"], -kv[1][BYTES], kv[0])))


def matmul_flops(by_source: Dict[str, Dict], region: str = "") -> int:
    """The matmul-class flops of a ``by_source`` table (of its ``region``
    alone, where one is named)."""
    return sum(e["flops"] for k, e in by_source.items()
               if e["kind"] == "matmul" and k.startswith(
                   f"{region}/" if region else ""))
