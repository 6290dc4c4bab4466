"""Fig. 16: runahead coverage (paper: average 87%; poor-locality kernels
cover less).  The twin of ``benchmarks/fig16_coverage.py``."""
from __future__ import annotations

from repro_torch.core.cgra import presets

from . import common


def points(quick: bool = False) -> list:
    """Sweep axes: every paper kernel under the runahead configuration."""
    return [(name, presets.RUNAHEAD) for name in common.paper_kernels(quick)]


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    covs = []
    for name in common.paper_kernels(quick):
        s = common.sim(name, presets.RUNAHEAD)
        covs.append(s.coverage)
        common.row(f"fig16/{name}", 0,
                   f"coverage={s.coverage:.1%};"
                   f"residual={s.uncovered_misses}", cycles=False)
    avg = sum(covs) / len(covs)
    common.row("fig16/avg_coverage", 0, f"{avg:.1%};paper=87%", cycles=False)
    return {"avg_coverage": avg}
