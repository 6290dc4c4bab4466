"""Fig. 2 / Fig. 5: SPM-only utilization collapse + irregular-access
fraction.  The twin of ``benchmarks/motivation.py``.

Paper claims: 4x4 HyCUBE w/ 4K SPM averages 1.43% utilization on GCN/Cora
(Fig. 2); across workloads irregular access drives utilization to ~1.7%
(Fig. 5)."""
from __future__ import annotations

from repro_torch.core.cgra import presets

from . import common


def points(quick: bool = False) -> list:
    """Sweep axes: every paper kernel on the Fig. 2 SPM-only 4K system."""
    return [(name, presets.SPM_ONLY_4K)
            for name in common.paper_kernels(quick)]


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    utils = []
    for name in common.paper_kernels(quick):
        s = common.sim(name, presets.SPM_ONLY_4K)
        irregular = common.trace_meta(name)["irregular_fraction"]
        utils.append(s.utilization)
        common.row(
            f"fig2_spm_only_4k/{name}", s.cycles,
            f"util={s.utilization:.3%};irregular={irregular:.2f}")
    avg = sum(utils) / len(utils)
    common.row("fig2_spm_only_4k/avg_utilization", 0,
               f"util={avg:.3%};paper=1.43-1.7%", cycles=False)
    return {"avg_utilization": avg}
