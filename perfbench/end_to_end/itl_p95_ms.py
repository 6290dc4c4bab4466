"""95th percentile of every gap between two consecutive tokens of a
request, both inside the window."""
from perfbench.readers import in_window, percentile


def read(ctx):
    gaps = []
    for s in ctx.record.sent:
        t = [x for x in s.token_times if in_window(ctx, x)]
        gaps += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return percentile(gaps, 95) if gaps else None
