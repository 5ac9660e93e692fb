"""A profiled stretch of the window and what the per-layer metrics read of
it: the device's busy time as the union of its operations' intervals (not
the sum of their times, which counts overlapping streams twice), each
kernel's time by name, and the idle gaps labelled by the host op that ran
in them."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def profiled(fn, device):
    """Run ``fn()`` under ``torch.profiler`` (the card's activity too on a
    CUDA device); returns (fn's result, ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, Trace(events)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """Times in seconds; the window is the ``bench.window`` range."""

    def __init__(self, events):
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = [(e["name"], float(e["ts"]), float(e["ts"])
                        + float(e["dur"])) for e in spans
                       if e.get("cat") in DEVICE_CATS]
        self.host = [(e["name"], float(e["ts"]), float(e["ts"])
                      + float(e["dur"])) for e in spans
                     if e.get("cat") in HOST_CATS and e["name"] != WINDOW]
        self.busy = _merge((max(s, self.t0), min(e, self.t1))
                           for _, s, e in self.device
                           if e > self.t0 and s < self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel_times(self, part: str):
        """Seconds of each device operation whose name holds ``part``."""
        return [(e - s) * 1e-6 for name, s, e in self.device if part in name]

    def top_ops(self, n: int = 10):
        total = defaultdict(float)
        for name, s, e in self.device:
            total[name[:160]] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest idle stretches of the device in the window,
        each named by the innermost host op running at its middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            around = [(he - hs, name) for name, hs, he in self.host
                      if hs <= mid <= he]
            out.append([min(around)[1] if around else "no host op",
                        (e - s) * 1e-6])
        return out
