"""A step's algorithmic flops (``benchlib/work.py`` ``step_flops``) over the
unprofiled window's seconds a step, as a share of the float32 peak of the
cards the cell uses."""


def read(ctx):
    if ctx["peak"] is None:
        return None
    rate = ctx["flops"] / ctx["step_s"]
    return 100.0 * rate / (ctx["chips"] * ctx["peak"]["float32_flops_per_s"])
