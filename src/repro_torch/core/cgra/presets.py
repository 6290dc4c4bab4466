"""A copy of ``repro.core.cgra.presets`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).

Hardware configuration presets (paper Table 3 + baselines)."""
from __future__ import annotations

from .cache import CacheConfig
from .simulator import SimConfig

#: Fig. 2 motivation system: 4x4 HyCUBE with a 4K SPM, no caches.
SPM_ONLY_4K = SimConfig(spm_bytes=4 * 1024, spm_only=True)

#: Fig. 11a SPM-only baseline: the original HyCUBE with a 133 KB SPM.
SPM_ONLY_133K = SimConfig(spm_bytes=133 * 1024, spm_only=True)

#: Table 3 "Base": 4x4 HyCUBE, 2x512B SPM, 4KB/32B 4-way L1, 128KB/32B L2.
BASE = SimConfig(
    spm_bytes=2 * 512,
    n_caches=1,
    l1=CacheConfig(ways=4, line=32, way_bytes=1024),
    l2=CacheConfig(ways=8, line=32, way_bytes=16 * 1024),
    mshr=16,
    runahead=False,
)

#: Table 3 "Cache+SPM/Runahead": as Base but 64B lines.
CACHE_SPM = SimConfig(
    spm_bytes=2 * 512,
    n_caches=1,
    l1=CacheConfig(ways=4, line=64, way_bytes=1024),
    l2=CacheConfig(ways=8, line=64, way_bytes=16 * 1024),
    mshr=16,
    runahead=False,
)

#: Runahead-enhanced Cache+SPM (same hardware, runahead on).
RUNAHEAD = CACHE_SPM.__class__(**{**CACHE_SPM.__dict__, "runahead": True})

#: Table 3 "Reconfig": 8x8 HyCUBE, 4x2KB SPM, 4x(4KB/64B 8-way) L1,
#: 128KB/128B L2, 4x16 MSHR.
RECONFIG = SimConfig(
    spm_bytes=4 * 2048,
    n_caches=4,
    l1=CacheConfig(ways=8, line=64, way_bytes=512),
    l2=CacheConfig(ways=8, line=128, way_bytes=16 * 1024),
    mshr=16,
    runahead=False,
)

#: Reconfig system with runahead on — the full-featured point the frontier
#: workloads (benchmarks/fig18_frontier.py) measure against.
RECONFIG_RA = SimConfig(**{**RECONFIG.__dict__, "runahead": True})

#: Fig. 12f storage-equivalence experiment: 2KB L1, 1KB SPM, 64B line, no L2.
STORAGE_EXP = SimConfig(
    spm_bytes=1024,
    n_caches=1,
    l1=CacheConfig(ways=4, line=64, way_bytes=512),
    l2=None,
    mshr=16,
    runahead=False,
)
