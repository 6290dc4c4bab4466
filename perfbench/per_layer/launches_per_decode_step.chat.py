"""Kernels launched by a traced decode step, on average (counted from the
device trace by the host call that launched each)."""


def read(ctx):
    if ctx.trace is None:
        return None
    idx = [i for i in ctx.trace.steps
           if ctx.record.steps[i].kind == "decode"]
    if not idx:
        return None
    return sum(ctx.trace.launches.get(i, 0) for i in idx) / len(idx)
