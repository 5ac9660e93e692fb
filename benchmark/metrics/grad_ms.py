"""The program's own stage time ``grad_ms`` (``VMC.profile_stages``: the
stage run alone, CUDA events, the mean of the cell's ``stage_reps``)."""


def read(ctx):
    stages = ctx["stages"]
    if not stages or "grad_ms" not in stages:
        return None
    return float(stages["grad_ms"])
