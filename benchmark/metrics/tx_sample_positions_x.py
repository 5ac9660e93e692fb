"""Positions the transformer computed to draw a step's set, over the
positions a draw with a key/value cache needs: the program's counter
``tx_sample_positions`` (``anqs_quantum_chemistry_torch/utils/spans.py``
``profiled_counts``; ``ANQS.cond_for_qudit_dyn`` counts, at each qudit, the
frontier rows times the positions the main net ran through) over the
traced window's steps, divided by those steps times the frontier rows the
cell's draw holds at each qudit, summed (``work.frontier_rows``, as the
ansatz file counts the sampler's work): one position a frontier row a
qudit. A full recompute of the Q positions at each qudit reads about Q.

The frontier comes from the cell's configuration, which ``benchlib/
session.py`` holds in the frame that calls ``read(ctx)`` and does not pass
in ``ctx``. A program that counts nothing under the profiler, or a caller
without that frame, gives no reading."""

import inspect

from benchlib.work import frontier_rows


def _counts():
    try:
        from anqs_quantum_chemistry_torch.utils.spans import profiled_counts
    except ImportError:
        return {}
    return profiled_counts()


def cached_positions(ctx):
    """Positions a cached draw needs in one step of the run whose readers
    get ``ctx``, or None where no caller's frame holds its cell."""
    frame = inspect.currentframe()
    while frame is not None:
        found = frame.f_locals
        if found.get("ctx") is ctx and {"net", "config", "sizes",
                                        "vmc_cfg"} <= set(found):
            sample_num = found["vmc_cfg"].get("sample_num")
            if sample_num is None:
                return None
            shape = found["net"].shape(found["config"], found["sizes"])
            return sum(frontier_rows(shape["widths"], int(sample_num)))
        frame = frame.f_back
    return None


def read(ctx):
    counted = _counts().get("tx_sample_positions")
    if not counted:
        return None
    per_step = cached_positions(ctx)
    if not per_step:
        return None
    return counted / (ctx["traced_steps"] * per_step)
