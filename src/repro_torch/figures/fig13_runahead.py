"""Fig. 13: runahead speedup per kernel (paper: avg 3.04x, max 6.91x).
The twin of ``benchmarks/fig13_runahead.py``."""
from __future__ import annotations

from repro_torch.core.cgra import presets

from . import common


def points(quick: bool = False) -> list:
    """Sweep axes: every paper kernel, Cache+SPM vs the same hardware with
    runahead enabled."""
    return [(name, cfg) for name in common.paper_kernels(quick)
            for cfg in (presets.CACHE_SPM, presets.RUNAHEAD)]


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    speedups = []
    for name in common.paper_kernels(quick):
        cache = common.sim(name, presets.CACHE_SPM)
        ra = common.sim(name, presets.RUNAHEAD)
        sp = cache.cycles / ra.cycles
        speedups.append(sp)
        common.row(f"fig13/{name}", ra.cycles,
                   f"runahead_speedup={sp:.2f}x;entries={ra.runahead_entries}")
    gm = common.geomean(speedups)
    common.row("fig13/geomean", 0, f"{gm:.2f}x;max={max(speedups):.2f}x;"
               f"paper=3.04x/6.91x", cycles=False)
    return {"geomean": gm, "max": max(speedups)}
