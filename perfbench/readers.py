"""Arithmetic the metric files share.

A metric file (``perfbench/end_to_end/<name>.py``,
``perfbench/per_layer/<name>.py``) holds ``read(ctx) -> float | None``;
``ctx`` is a :class:`Context`, which carries the configuration's
reference module for the model's layer and FLOP counts
(:mod:`perfbench.reference.decoder`).  A reader that finds nothing to
read returns None, and the run leaves that metric out of its line.
"""
from __future__ import annotations

import dataclasses
import math
import re
import statistics
from typing import Optional

from .roofline import counts


@dataclasses.dataclass
class Context:
    arch: dict
    ref: object                  # the configuration's reference module
    traffic: dict
    record: object               # client.Record
    setup_s: float
    trace: Optional[object] = None   # trace.Summary, in a traced run


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list (a copy
    of ``repro_torch.serve.metrics.percentile``)."""
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[i])


def window_steps(ctx: Context, kind: Optional[str] = None) -> list:
    return [s for s in ctx.record.steps if s.phase == "window"
            and (kind is None or s.kind == kind)]


def traced_steps(ctx: Context, kind: Optional[str] = None) -> list:
    """The steps the profiler saw, in order (a traced run only)."""
    if ctx.trace is None:
        return []
    steps = ctx.record.steps
    return [steps[i] for i in ctx.trace.steps
            if kind is None or steps[i].kind == kind]


def in_window(ctx: Context, t: float) -> bool:
    return ctx.record.t0 <= t <= ctx.record.t1


def step_ms(ctx: Context, kind: str) -> Optional[float]:
    """Median wall milliseconds of the window's steps of one kind (each
    ends on the host's read of its sampled tokens, so it is synchronised)."""
    xs = [(s.t1 - s.t0) * 1e3 for s in window_steps(ctx, kind)]
    return statistics.median(xs) if xs else None


def kernel_seconds(ctx: Context, names: tuple) -> float:
    """Device seconds of the traced kernels named one of ``names`` (the
    function's name, in any namespace, with any template arguments)."""
    pat = re.compile(r"(^|[\s:])(" + "|".join(map(re.escape, names))
                     + r")\b")
    return sum(v for k, v in ctx.trace.kernel_s.items() if pat.search(k))


def paged_attention_roofline(ctx: Context, names: tuple) -> Optional[float]:
    if ctx.trace is None:
        return None
    secs = kernel_seconds(ctx, names)
    steps = traced_steps(ctx, "decode")
    if secs <= 0 or not steps:
        return None
    page = ctx.traffic["engine"]["page_size"]
    layers = ctx.ref.attention_layers(ctx.arch)
    flops = nbytes = 0
    for s in steps:
        f, b = counts.paged_attention(ctx.arch, s.rows, page, layers)
        flops, nbytes = flops + f, nbytes + b
    return counts.roofline_pct(flops, nbytes, secs)


def dispatch_combine_roofline(ctx: Context, names: tuple
                              ) -> Optional[float]:
    layers = ctx.ref.moe_layers(ctx.arch)
    if ctx.trace is None or not layers:
        return None
    secs = kernel_seconds(ctx, names)
    steps = traced_steps(ctx)
    if secs <= 0 or not steps:
        return None
    flops = nbytes = 0
    for s in steps:
        rows = len(s.rows) if s.kind == "decode" else s.n_valid
        f, b = counts.dispatch_combine(ctx.arch, rows, layers)
        flops, nbytes = flops + f, nbytes + b
    return counts.roofline_pct(flops, nbytes, secs)


def device_idle_pct(ctx: Context) -> Optional[float]:
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(ctx: Context) -> Optional[float]:
    """Model FLOPs of every token the window's steps processed, over the
    window's seconds at the card's bf16 peak."""
    steps = window_steps(ctx)
    if not steps:
        return None
    flops = sum(ctx.ref.step_flops(ctx.arch, s.kind, s.rows, s.start,
                                   s.n_valid) for s in steps)
    secs = ctx.record.t1 - ctx.record.t0
    return 100.0 * flops / (secs * counts.peaks()["bf16_flops_per_s"])
