"""Named spans and counters inside the program, on the clock of the device.

``span(name)`` marks a stretch of the program (a stage of ``VMC.step``, a
prefilter stage, a kernel's wrapper) and ``count(name, n)`` adds to a
counter of the innermost open span. A span has three states:

- **off** (no recording open, no ``torch.profiler`` running): one check,
  then nothing -- no ``record_function``, no CUDA event, no clock read, no
  allocation;
- **under a running ``torch.profiler``**: a ``record_function(name)``
  range and nothing more, which lands in the profiler's trace on the clock
  of the device's kernels, so that an idle stretch of the device can be put
  down to the span the host was in. A counter counted there adds to a
  total by its name (``profiled_counts()``), whichever span counted it;
- **inside ``recording()``** (with or without a profiler): each span is
  recorded with its name, its parent, the step it belongs to (a span opened
  with no span open starts a step: ``VMC.step``'s ``vmc.step``), its host
  start and end (``time.perf_counter``) and, on a CUDA device, a pair of
  CUDA events on the stream that was current when the recording opened
  (the program's one stream). Events are read only when the summary
  is asked for, after the caller's own read-back, so the recording adds no
  synchronisation. While a step is open on a CUDA device,
  ``torch.cuda.set_sync_debug_mode`` is at 'warn', and each synchronizing
  call is counted against the innermost open span (its warning is
  swallowed); the previous mode comes back when the step closes.

``Recording.summary(steps)`` gives, per span name and per step: device ms
(event to event; host ms on the CPU), host ms, self ms (device ms less
what its child spans cover), calls, synchronizing calls and counters.
Spans stay in memory; the profiler's trace is the timeline.

Spans and counters belong to one thread: the program's own.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional

import torch

# The text of the warning that ``set_sync_debug_mode('warn')`` raises.
SYNC_WARNING = "called a synchronizing CUDA operation"

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_recording: Optional["Recording"] = None  # the open recording()'s
_profiled_counts: Dict[str, int] = {}  # counted under a profiler alone


class SpanRecord:
    """One recorded span. ``parent``: the index of its parent in
    ``Recording.spans`` (None at a step's root); ``step``: the index of
    its step; ``counts``: {counter: total}; ``syncs``: synchronizing calls
    made while it was the innermost open span."""

    __slots__ = ("name", "parent", "step", "t0", "t1", "events", "counts",
                 "syncs", "_device_ms")

    def __init__(self, name: str, parent: Optional[int], step: int,
                 stream):
        self.name, self.parent, self.step = name, parent, step
        self.events = None
        if stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.counts: Dict[str, int] = {}
        self.syncs = 0
        self.t1 = None
        self._device_ms = None
        self.t0 = time.perf_counter()

    def close(self, stream):
        if stream is not None:
            self.events[1].record(stream)
        self.t1 = time.perf_counter()

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def device_ms(self) -> float:
        """Event to event on a CUDA device (waits for the end event), the
        host clock otherwise."""
        if self.events is None:
            return self.host_ms
        if self._device_ms is None:
            self.events[1].synchronize()
            self._device_ms = self.events[0].elapsed_time(self.events[1])
        return self._device_ms


class Recording:
    """The spans recorded while it was open, in the order they opened.
    ``device``: where the spans' work runs (CUDA events there); default a
    CUDA device if this process has initialised one, else the CPU."""

    def __init__(self, device=None):
        if device is None:
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        else:
            cuda = torch.device(device).type == "cuda"
        self.cuda = cuda
        # Looked up once: ``current_stream()`` costs as much as a launch.
        self._stream = torch.cuda.current_stream() if cuda else None
        self.spans: List[SpanRecord] = []
        self.steps = 0
        self._stack: List[int] = []
        self._armed = None

    def _open(self, name: str):
        parent = self._stack[-1] if self._stack else None
        if parent is None:
            self.steps += 1
            self._arm()
        self._stack.append(len(self.spans))
        self.spans.append(SpanRecord(name, parent, self.steps - 1,
                                     self._stream))

    def _close(self):
        self.spans[self._stack.pop()].close(self._stream)
        if not self._stack:
            self._disarm()

    def _count(self, name: str, n: int):
        if self._stack:
            counts = self.spans[self._stack[-1]].counts
            counts[name] = counts.get(name, 0) + n

    def _arm(self):
        """Count synchronizing calls while a step is open (CUDA only)."""
        if not self.cuda:
            return
        catcher = warnings.catch_warnings()
        catcher.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        forward = warnings.showwarning

        def shown(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                if self._stack:
                    self.spans[self._stack[-1]].syncs += 1
                return
            forward(message, category, filename, lineno, file, line)

        warnings.showwarning = shown
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        self._armed = (catcher, mode)

    def _disarm(self):
        if self._armed is None:
            return
        catcher, mode = self._armed
        self._armed = None
        torch.cuda.set_sync_debug_mode(mode)
        catcher.__exit__(None, None, None)

    def summary(self, steps: Optional[int] = None) -> Dict[str, Dict]:
        """{span name: {'device_ms', 'host_ms', 'self_ms', 'calls',
        'syncs', 'counts': {counter: value}}}, each summed over the
        closed spans of that name and divided by ``steps`` (default the
        steps recorded)."""
        steps = steps or self.steps or 1
        closed = [s.t1 is not None for s in self.spans]
        children = [0.0] * len(self.spans)
        for s, done in zip(self.spans, closed):
            if done and s.parent is not None:
                children[s.parent] += s.device_ms
        out: Dict[str, Dict] = {}
        for s, done, below in zip(self.spans, closed, children):
            if not done:
                continue
            e = out.setdefault(s.name, {
                "device_ms": 0.0, "host_ms": 0.0, "self_ms": 0.0,
                "calls": 0, "syncs": 0, "counts": {}})
            e["device_ms"] += s.device_ms
            e["host_ms"] += s.host_ms
            e["self_ms"] += s.device_ms - below
            e["calls"] += 1
            e["syncs"] += s.syncs
            for k, v in s.counts.items():
                e["counts"][k] = e["counts"].get(k, 0) + v
        for e in out.values():
            for key in ("device_ms", "host_ms", "self_ms", "calls", "syncs"):
                e[key] /= steps
            e["counts"] = {k: v / steps for k, v in e["counts"].items()}
        return out


class _Span:
    __slots__ = ("name", "_range", "_rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._rec = _recording
        if self._rec is not None:
            self._rec._open(self.name)

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._close()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking ``name`` (module docstring)."""
    if _recording is None and not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int):
    """Add ``n`` (a Python int: never a device value, whose read would
    synchronise) to the counter ``name`` of the innermost open span while
    spans are recorded, or to ``profiled_counts()[name]`` under a profiler
    with no recording open."""
    if _recording is not None:
        _recording._count(name, n)
    elif _profiler_enabled():
        _profiled_counts[name] = _profiled_counts.get(name, 0) + n


def profiled_counts() -> Dict[str, int]:
    """{counter: its total over everything counted under a
    ``torch.profiler`` with no recording open, since the process
    started}. Counter names are the program's, one meaning each:
    ``hash_lookup``'s ``launches``, ``queries``, ``key_words``,
    ``buckets``, ``entries`` and ``table_words``,
    ``fused_matrix_elements``' ``rows``, ``pf.stage1``'s ``partners``,
    ``fp_filter``'s ``fp_launches`` and ``fp_smem_launches``,
    ``tx.forward``'s and ``tx.decode``'s ``tx_rows`` and ``tx_positions``
    (the transformer's rows and the positions it ran through its stack)
    and the sampler's ``tx_sample_positions`` (``ANQS.cond_for_qudit_dyn``
    and ``cond_for_qudit_cached``: the positions the transformer computed
    to answer a qudit's conditional)."""
    return dict(_profiled_counts)


@contextlib.contextmanager
def recording(device=None):
    """Record every span opened inside (module docstring); yields the
    ``Recording``. One at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = _recording = Recording(device)
    try:
        yield rec
    finally:
        _recording = None
        rec._disarm()
