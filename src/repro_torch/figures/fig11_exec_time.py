"""Fig. 11a/b: execution time across memory systems + access distribution.
The twin of ``benchmarks/fig11_exec_time.py``.

Paper claims: Cache+SPM ~10x over the size-equivalent SPM-only design with
77% fewer DRAM accesses; runahead adds 3.04x (up to 6.91x).  The A72/SIMD
CPU baselines are out of scope (they need a CPU microarchitecture
simulator, orthogonal to the paper's contribution).
"""
from __future__ import annotations

from repro_torch.core.cgra import presets

from . import common

CONFIGS = (presets.SPM_ONLY_133K, presets.CACHE_SPM, presets.RUNAHEAD)


def points(quick: bool = False) -> list:
    """Sweep axes: every paper kernel x the three Fig. 11 memory systems."""
    return [(name, cfg) for name in common.paper_kernels(quick)
            for cfg in CONFIGS]


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    speed_cache, speed_ra, dram_drop = [], [], []
    for name in common.paper_kernels(quick):
        spm = common.sim(name, presets.SPM_ONLY_133K)
        cache = common.sim(name, presets.CACHE_SPM)
        ra = common.sim(name, presets.RUNAHEAD)
        sc = spm.cycles / cache.cycles
        sr = cache.cycles / ra.cycles
        speed_cache.append(sc)
        speed_ra.append(sr)
        if spm.dram_accesses:
            dram_drop.append(1 - cache.dram_accesses / spm.dram_accesses)
        common.row(f"fig11a/{name}/spm_only_133k", spm.cycles, "norm=1.0")
        common.row(f"fig11a/{name}/cache_spm", cache.cycles,
                   f"speedup_vs_spm={sc:.2f}x")
        common.row(f"fig11a/{name}/runahead", ra.cycles,
                   f"speedup_vs_cache={sr:.2f}x")
        common.row(
            f"fig11b/{name}", 0,
            f"spm_acc={cache.spm_accesses};l1_hit={cache.l1_hits};"
            f"l2_hit={cache.l2_hits};dram={cache.dram_accesses};"
            f"dram_spm_only={spm.dram_accesses}", cycles=False)
    gm_c = common.geomean(speed_cache)
    gm_r = common.geomean(speed_ra)
    avg_drop = sum(dram_drop) / max(1, len(dram_drop))
    common.row("fig11a/geomean_cache_vs_spm", 0,
               f"{gm_c:.2f}x;paper=10x", cycles=False)
    common.row("fig11a/geomean_runahead", 0,
               f"{gm_r:.2f}x;paper=3.04x", cycles=False)
    common.row("fig11b/avg_dram_reduction", 0,
               f"{avg_drop:.0%};paper=77%", cycles=False)
    return {"cache_speedup": gm_c, "runahead_speedup": gm_r,
            "dram_reduction": avg_drop}
