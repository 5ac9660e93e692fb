"""Share of the traced window in which no operation ran on the device: the
union of the kernel, copy and set intervals (``benchlib/trace.py``), the
busy time averaged over the ranks of a data-parallel cell."""


def read(ctx):
    if ctx["trace"] is None or not ctx["trace"].device:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace"].window_s)
