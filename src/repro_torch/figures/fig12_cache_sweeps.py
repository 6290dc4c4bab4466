"""Fig. 12: cache-parameter sweeps + the 1.27% storage-equivalence result.
The twin of ``benchmarks/fig12_cache_sweeps.py``.

Paper claims: associativity saturates ~8 (12a), line size ~64B (12b), MSHR
~4 for demand misses (12d), SPM size has little effect (12e), and Cache+SPM
matches a scaled SPM-only system with only 1.27% of the storage (12f).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cgra import presets

from . import common

ASSOCS = (1, 2, 4, 8, 16)
LINES = (16, 32, 64, 128)
L1_GEOMS = ((4, 256), (4, 512), (4, 1024), (4, 2048), (8, 2048))
MSHRS = (1, 2, 4, 8, 16)
SPM_SIZES = (512, 1024, 2048, 4096, 8192)
SPM_ONLY_KB = (8, 16, 32, 64, 96, 128, 160, 192, 224, 256, 320)


def sweep_kernels(quick: bool) -> list[str]:
    kernels = common.paper_kernels(quick)
    return kernels[:2] if quick else kernels[:4]


def _cfg(base, **l1kw):
    return dataclasses.replace(base, l1=base.l1.replace(**l1kw))


def _line_cfg(base, line):
    return dataclasses.replace(
        base, l1=base.l1.replace(line=line),
        l2=base.l2.replace(line=max(line, base.l2.line)))


def _spm_only_cfg(spm_kb):
    return dataclasses.replace(presets.SPM_ONLY_133K, spm_bytes=spm_kb * 1024)


def points(quick: bool = False) -> list:
    """Sweep axes: assoc (12a), line (12b), L1 size (12c), MSHR (12d), SPM
    size (12e) over the sweep kernels, plus the Cora storage-equivalence
    scan (12f)."""
    base = presets.CACHE_SPM
    pts = []
    for name in sweep_kernels(quick):
        pts += [(name, _cfg(base, ways=a)) for a in ASSOCS]
        pts += [(name, _line_cfg(base, line)) for line in LINES]
        pts += [(name, _cfg(base, ways=w, way_bytes=wb)) for w, wb in L1_GEOMS]
        pts += [(name, dataclasses.replace(base, mshr=m)) for m in MSHRS]
        pts += [(name, dataclasses.replace(base, spm_bytes=s))
                for s in SPM_SIZES]
    pts.append(("gcn_cora", presets.STORAGE_EXP))
    pts += [("gcn_cora", _spm_only_cfg(kb)) for kb in SPM_ONLY_KB]
    return pts


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    base = presets.CACHE_SPM
    kernels = sweep_kernels(quick)
    out = {}

    for assoc in ASSOCS:
        for name in kernels:
            s = common.sim(name, _cfg(base, ways=assoc))
            common.row(f"fig12a/{name}/assoc_{assoc}", s.cycles,
                       f"hit_rate={s.l1_hit_rate:.3f}")

    for line in LINES:
        cfg = _line_cfg(base, line)
        for name in kernels:
            s = common.sim(name, cfg)
            common.row(f"fig12b/{name}/line_{line}", s.cycles,
                       f"hit_rate={s.l1_hit_rate:.3f}")

    for ways, way_bytes in L1_GEOMS:
        size = ways * way_bytes
        for name in kernels:
            s = common.sim(name, _cfg(base, ways=ways, way_bytes=way_bytes))
            common.row(f"fig12c/{name}/l1_{size}B", s.cycles,
                       f"hit_rate={s.l1_hit_rate:.3f}")

    for mshr in MSHRS:
        for name in kernels:
            s = common.sim(name, dataclasses.replace(base, mshr=mshr))
            common.row(f"fig12d/{name}/mshr_{mshr}", s.cycles, "demand-only")

    for spm in SPM_SIZES:
        for name in kernels:
            s = common.sim(name, dataclasses.replace(base, spm_bytes=spm))
            common.row(f"fig12e/{name}/spm_{spm}B", s.cycles, "")

    # 12f: scale SPM-only until it matches the small Cache+SPM system (Cora)
    target = common.sim("gcn_cora", presets.STORAGE_EXP)
    cache_storage = presets.STORAGE_EXP.storage_bytes()
    match_bytes = None
    for spm_kb in SPM_ONLY_KB:
        s = common.sim("gcn_cora", _spm_only_cfg(spm_kb))
        common.row(f"fig12f/spm_only_{spm_kb}KB", s.cycles,
                   f"vs_cache_spm={s.cycles / target.cycles:.2f}x")
        if match_bytes is None and s.cycles <= target.cycles:
            match_bytes = spm_kb * 1024
    if match_bytes:
        ratio = cache_storage / match_bytes
        common.row("fig12f/storage_ratio", 0,
                   f"{ratio:.2%};paper=1.27%", cycles=False)
        out["storage_ratio"] = ratio
    return out
