"""Fig. 18 (repo extension): the irregular-workload frontier.  The twin of
``benchmarks/fig18_frontier.py``.

The paper's Table-1 kernels end at moderate irregularity (GCN gathers,
radix scatters).  This figure pushes the same systems into the three
workload domains the paper's motivation cites but never measures —
power-law BFS/PageRank frontier expansion, skewed hash-join probes, and
unstructured-mesh gathers under good (RCM) vs adversarial (shuffled)
numberings (:mod:`repro_torch.core.cgra.workloads`) — and reports where
the paper's two remedies (runahead execution, §3.4 cache reconfiguration)
keep winning and where they stop paying.

Per kernel, against the Table-3 systems:

* ``cache_vs_spm``  — Cache+SPM speedup over the 4K SPM-only baseline;
* ``runahead_speedup`` — Runahead over Cache+SPM;
* ``reconfig_gain_nora`` / ``reconfig_gain_ra`` — §3.4 reconfigured
  system vs the stock Reconfig system, runahead off/on (the profile on
  ``device``: ``cache_grid_scan`` on the card when None);
* a ``verdict`` classifying the kernel as ``win`` (both levers help),
  ``runahead_only``, ``reconfig_only``, or ``lose`` (neither moves it
  more than the 2% noise floor).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import presets
from repro_torch.core.cgra.workloads import FRONTIER_KERNELS

from . import common

#: the frontier kernels in full mode, and the quick subset
KERNELS = list(FRONTIER_KERNELS)
QUICK_KERNELS = ["bfs_powerlaw", "hash_join_skew", "mesh_shuffled"]

WINDOW = 8192

#: the gain below which a lever is "not paying" on this workload
NOISE_FLOOR = 0.02

SYSTEMS = {
    "spm_only": presets.SPM_ONLY_4K,
    "cache_spm": presets.CACHE_SPM,
    "runahead": presets.RUNAHEAD,
    "reconfig": presets.RECONFIG,
    "reconfig_ra": presets.RECONFIG_RA,
}


def kernels(quick: bool) -> list[str]:
    return list(QUICK_KERNELS if quick else KERNELS)


def points(quick: bool = False) -> list:
    """Frontier kernels x Table-3 systems.  The §3.4 reconfigured
    counterparts depend on the cached profiling loop, so ``run()`` warms
    those in a second batch (same pattern as fig17)."""
    return [(name, cfg) for name in kernels(quick) for cfg in SYSTEMS.values()]


def _verdict(ra_speedup: float, reconfig_gain: float) -> str:
    ra = ra_speedup >= 1.0 + NOISE_FLOOR
    rc = reconfig_gain >= NOISE_FLOOR
    if ra and rc:
        return "win"
    if ra:
        return "runahead_only"
    if rc:
        return "reconfig_only"
    return "lose"


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    names = kernels(quick)
    reconfigured = {name: common.reconfig(name, presets.RECONFIG,
                                          window=WINDOW, device=device)
                    for name in names}
    common.warm([(name, dataclasses.replace(res.config, runahead=ra))
                 for name, res in reconfigured.items()
                 for ra in (False, True)])

    summary: dict[str, dict] = {}
    for name in names:
        s = {sysname: common.sim(name, cfg)
             for sysname, cfg in SYSTEMS.items()}
        res = reconfigured[name]
        gains = {}
        for ra, key in ((False, "nora"), (True, "ra")):
            stock = s["reconfig_ra" if ra else "reconfig"]
            tuned = common.sim(name, dataclasses.replace(res.config,
                                                         runahead=ra))
            gains[key] = (stock.cycles - tuned.cycles) / stock.cycles
        ra_speedup = s["cache_spm"].cycles / s["runahead"].cycles
        rec = {
            "cycles_cache_spm": s["cache_spm"].cycles,
            "cache_vs_spm": s["spm_only"].cycles / s["cache_spm"].cycles,
            "runahead_speedup": ra_speedup,
            "reconfig_gain_nora": gains["nora"],
            "reconfig_gain_ra": gains["ra"],
            "verdict": _verdict(ra_speedup, max(gains["nora"], gains["ra"])),
        }
        summary[name] = rec
        common.row(
            f"fig18/{name}", s["runahead"].cycles,
            f"ra_speedup={ra_speedup:.2f}x;"
            f"cache_vs_spm={rec['cache_vs_spm']:.2f}x;"
            f"reconfig={gains['nora']:+.2%}/{gains['ra']:+.2%};"
            f"verdict={rec['verdict']}")
    common.row(
        "fig18/geomean_runahead_speedup", 0,
        f"{common.geomean([r['runahead_speedup'] for r in summary.values()]):.2f}x",
        cycles=False)
    return summary
