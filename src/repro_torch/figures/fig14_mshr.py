"""Fig. 14: runahead speedup vs MSHR size (paper: saturates ~16).
The twin of ``benchmarks/fig14_mshr.py``."""
from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import presets

from . import common

MSHRS = (1, 2, 4, 8, 16, 32)


def kernels(quick: bool) -> list[str]:
    names = common.paper_kernels(quick)
    return names[:2] if quick else names[:4]


def points(quick: bool = False) -> list:
    """Sweep axes: the Fig. 14 kernels x (Cache+SPM baseline + runahead with
    each MSHR size)."""
    names = kernels(quick)
    pts = [(name, presets.CACHE_SPM) for name in names]
    pts += [(name, dataclasses.replace(presets.RUNAHEAD, mshr=m))
            for name in names for m in MSHRS]
    return pts


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    sat = {}
    for name in kernels(quick):
        base = common.sim(name, presets.CACHE_SPM)
        prev = None
        for mshr in MSHRS:
            cfg = dataclasses.replace(presets.RUNAHEAD, mshr=mshr)
            s = common.sim(name, cfg)
            sp = base.cycles / s.cycles
            common.row(f"fig14/{name}/mshr_{mshr}", s.cycles,
                       f"runahead_speedup={sp:.2f}x;"
                       f"prefetches={s.prefetch_issued}")
            if prev is not None and sp < prev * 1.02 and name not in sat:
                sat[name] = mshr
            prev = sp
    common.row("fig14/saturation_points", 0,
               ";".join(f"{k}@{v}" for k, v in sat.items()) + ";paper=16",
               cycles=False)
    return sat
