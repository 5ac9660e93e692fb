"""Kernel #1 (``fused_me_kernel``) against the least time its work could
take (``benchlib/work.py`` ``me_least_seconds``: its inputs read once and
its (B, M) float32 output written once at the card's bandwidth, or a
multiply-add a (row, term) pair at its float32 rate, whichever is longer),
over the mean of its launches in the traced stretch."""

from benchlib.work import me_least_seconds

KERNEL = "fused_me_kernel"


def read(ctx):
    if ctx["trace"] is None or ctx["peak"] is None:
        return None
    times = ctx["trace"].kernel_times(KERNEL)
    if not times:
        return None
    k = ctx["kernel1"]
    least, _ = me_least_seconds(k["rows"], k["n_words"], k["n_terms"],
                                k["n_groups"], ctx["peak"])
    return 100.0 * least / (sum(times) / len(times))
