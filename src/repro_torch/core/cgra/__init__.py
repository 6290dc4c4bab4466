"""The paper's CGRA memory subsystem (the twin of ``repro.core.cgra``):
the cycle-level simulator, its traces and presets (copies of the
reference's NumPy modules), the §3.4 reconfiguration loop
(:mod:`.reconfig`), its grid profiler on the card (:mod:`.cache_grid`),
and the crash-safe parallel sweep service over them (:mod:`.sweep`,
:mod:`.journal`)."""
from .cache import Cache, CacheConfig, OracleCache
from .simulator import SimConfig, Stats, plan_spm, simulate
from .trace import (KERNELS, RANDOM_DATA_KERNELS, REAL_DATA_KERNELS, Array,
                    Trace, gcn_aggregate, grad, perm_sort, radix_hist,
                    radix_update, random_access, rgb, src2dest)
from .workloads import (FRONTIER_KERNELS, bfs_frontier, hash_join,
                        mesh_gather, pagerank_push, random_trace)
from . import presets
from . import sweep

__all__ = [
    "Cache", "CacheConfig", "OracleCache", "SimConfig", "Stats", "plan_spm",
    "simulate", "KERNELS", "REAL_DATA_KERNELS", "RANDOM_DATA_KERNELS",
    "Array", "Trace", "gcn_aggregate", "grad", "perm_sort", "radix_hist",
    "radix_update", "random_access", "rgb", "src2dest",
    "FRONTIER_KERNELS", "bfs_frontier", "pagerank_push", "hash_join",
    "mesh_gather", "random_trace", "presets", "sweep",
]
