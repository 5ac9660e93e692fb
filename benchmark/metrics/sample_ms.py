"""The program's own stage time ``sample_ms`` (``VMC.profile_stages``: the
stage run alone, CUDA events, the mean of the cell's ``stage_reps``)."""


def read(ctx):
    stages = ctx["stages"]
    if not stages or "sample_ms" not in stages:
        return None
    return float(stages["sample_ms"])
