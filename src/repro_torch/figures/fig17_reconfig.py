"""Fig. 17: cache-reconfiguration gains, real vs random input data, with
and without runahead (paper: +4.59%/+7.79% real no-RA; +3.22%/+6.02% real
w/ RA; +2.10%/+5.26% random no-RA; +1.58%/+2.73% random w/ RA).  The twin
of ``benchmarks/fig17_reconfig.py``; each kernel's §3.4 profile runs on
``device`` (``cache_grid_scan`` on the card when None)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import presets
from repro_torch.core.cgra.trace import REAL_DATA_KERNELS

from . import common

WINDOW = 8192


def kernels(quick: bool) -> list[str]:
    names = common.paper_kernels(quick)
    return names[:3] if quick else names


def points(quick: bool = False) -> list:
    """Sweep axes: the baseline Reconfig system, runahead off/on, per kernel.
    The reconfigured counterpart configs depend on the (cached) §3.4
    profiling loop, so ``run()`` warms them in a second batch once
    profiling is done."""
    return [(name, dataclasses.replace(presets.RECONFIG, runahead=ra))
            for name in kernels(quick) for ra in (False, True)]


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    base = presets.RECONFIG
    names = kernels(quick)
    # profile + DP per kernel (store-backed), then one sweep over the
    # resulting per-kernel reconfigured configs
    reconfigured = {name: common.reconfig(name, base, window=WINDOW,
                                          device=device)
                    for name in names}
    common.warm([(name, dataclasses.replace(res.config, runahead=ra))
                 for name, res in reconfigured.items() for ra in (False, True)])

    gains: dict[str, list[float]] = {"real_nora": [], "real_ra": [],
                                     "rand_nora": [], "rand_ra": []}
    for name in names:
        res = reconfigured[name]
        kind = "real" if name in REAL_DATA_KERNELS else "rand"
        for ra in (False, True):
            b = dataclasses.replace(base, runahead=ra)
            n = dataclasses.replace(res.config, runahead=ra)
            s_b = common.sim(name, b)
            s_n = common.sim(name, n)
            gain = (s_b.cycles - s_n.cycles) / s_b.cycles
            gains[f"{kind}_{'ra' if ra else 'nora'}"].append(gain)
            common.row(
                f"fig17/{name}/{'runahead' if ra else 'no_runahead'}",
                s_n.cycles,
                f"gain={gain:+.2%};alloc={'/'.join(map(str, res.allocations))};"
                f"lines={'/'.join(map(str, res.lines))}")
    summary = {}
    paper = {"real_nora": "4.59%", "real_ra": "3.22%",
             "rand_nora": "2.10%", "rand_ra": "1.58%"}
    for key, vals in gains.items():
        if vals:
            avg = sum(vals) / len(vals)
            summary[key] = avg
            common.row(f"fig17/avg_{key}", 0,
                       f"{avg:+.2%};paper={paper[key]}", cycles=False)
    return summary
