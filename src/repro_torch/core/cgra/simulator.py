"""A copy of ``repro.core.cgra.simulator`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).

Cycle-level CGRA memory-subsystem simulator with runahead execution.

Models the paper's system (§3, Table 3):

* a statically scheduled CGRA issuing each loop iteration every II cycles;
  *any* demand **load** miss stalls the whole array (lock-step PEs, §2.2);
  store misses are absorbed by the store buffer / Load-Store Table (§3.4.1)
  and do not stall unless the MSHR is full;
* an SPM holding compiler-pinned arrays (greedy by access density);
* one or more non-blocking L1 caches (MSHR-limited, LRU, write-allocate)
  fronting a shared non-inclusive L2 and a bandwidth-limited DRAM;
* multi-cache "virtual SPM" mapping: PE -> L1 cache (§3.3);
* **runahead execution** (§3.2): on a demand-load-miss stall the simulator
  walks the future trace for the duration of the stall window, propagating
  dummy-ness through address dependencies (``addr_dep``), converting stores
  to prefetch-reads, redirecting valid stores to temporary storage, and
  issuing *precise* prefetches bounded by free MSHR entries.

Timing constants default to Table 3: L1 hit 1 cycle (pipelined into the II),
L2 hit 8, L2 miss (DRAM) 80, DRAM bus service interval models the bandwidth
pressure the paper mentions for large lines (§4.3).

This module is the *orchestration* layer: configuration (:class:`SimConfig`),
result statistics (:class:`Stats`), and the :func:`simulate` /
:func:`simulate_batch` entry points.  The scalar stall/runahead walk lives
in :mod:`repro_torch.core.cgra._engine`; the lane-parallel batched engine (many
demand configs over one trace per pass) lives in
:mod:`repro_torch.core.cgra._batch_engine`; the columnar lane-lockstep runahead
engine (all runahead lanes of an L1 shape advance together over shared
trace columns) lives in :mod:`repro_torch.core.cgra._runahead_engine`; both are
bit-identical to the scalar walk.  Parallel/cached execution over many
(trace, config) points (the reference's ``sweep``) is not in the port.
"""
from __future__ import annotations

import dataclasses

from .cache import CacheConfig
from .trace import Trace, plan_spm

__all__ = ["SimConfig", "Stats", "plan_spm", "simulate", "simulate_batch"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One hardware configuration (a Table-3 column)."""

    spm_bytes: int = 1024
    n_caches: int = 1
    l1: CacheConfig = CacheConfig(ways=4, line=64, way_bytes=1024)
    l1_per_cache: tuple[CacheConfig, ...] | None = None  # reconfig override
    l2: CacheConfig | None = CacheConfig(ways=8, line=64, way_bytes=16 * 1024)
    mshr: int = 16
    runahead: bool = False
    l2_hit_latency: int = 8
    dram_latency: int = 80
    dram_bus_bytes_per_cycle: int = 16  # line transfer occupancy (BW cap);
                                        # the paper's "bandwidth pressure from
                                        # larger cache lines" (§4.3)
    spm_only: bool = False      # no caches; non-SPM accesses go straight to DRAM

    def l1_configs(self) -> list[CacheConfig]:
        if self.l1_per_cache is not None:
            assert len(self.l1_per_cache) == self.n_caches
            return list(self.l1_per_cache)
        return [self.l1] * self.n_caches

    def storage_bytes(self) -> int:
        total = self.spm_bytes
        if not self.spm_only:
            total += sum(c.ways * c.way_bytes for c in self.l1_configs())
            if self.l2 is not None:
                total += self.l2.ways * self.l2.way_bytes
        return total


@dataclasses.dataclass
class Stats:
    """Simulation outcome + derived metrics."""

    name: str = ""
    cycles: int = 0
    compute_cycles: int = 0          # n_iters * II  (ideal, stall-free)
    stall_cycles: int = 0
    spm_accesses: int = 0
    l1_hits: int = 0
    l1_misses: int = 0
    l2_hits: int = 0
    dram_accesses: int = 0
    prefetch_issued: int = 0
    prefetch_used: int = 0
    prefetch_evicted: int = 0        # useful but evicted before use (Fig. 15)
    prefetch_useless: int = 0        # never needed by the program
    covered_misses: int = 0          # would-be misses hidden by prefetch
    uncovered_misses: int = 0        # residual demand misses (Fig. 16)
    runahead_entries: int = 0

    @property
    def utilization(self) -> float:
        return self.compute_cycles / max(1, self.cycles)

    @property
    def l1_hit_rate(self) -> float:
        total = self.l1_hits + self.l1_misses
        return self.l1_hits / max(1, total)

    @property
    def coverage(self) -> float:
        tot = self.covered_misses + self.uncovered_misses
        return self.covered_misses / max(1, tot)

    @property
    def prefetch_accuracy(self) -> float:
        """Useful prefetches / all prefetches (used + evicted are 'needed')."""
        if self.prefetch_issued == 0:
            return 1.0
        return (self.prefetch_used + self.prefetch_evicted) / self.prefetch_issued

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Stats":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def simulate(trace: Trace, cfg: SimConfig) -> Stats:
    """Run one kernel trace through one hardware configuration."""
    from . import _engine

    stats = Stats(name=trace.name)
    _engine.run(trace, cfg, stats)
    return stats


def simulate_batch(trace: Trace, cfgs) -> list[Stats]:
    """Run one kernel trace through many configurations in one pass.

    Bit-identical to ``[simulate(trace, cfg) for cfg in cfgs]`` but far
    faster for sweeps: non-runahead lanes advance together through the
    batched engine (shared content phase + per-lane timing replay, with
    vectorized SPM-only and iteration-advance fast paths); runahead lanes
    advance per L1-shape group through the columnar lockstep runahead
    engine (all lanes of a group step together over shared trace columns).
    """
    from . import _batch_engine

    stats_list = [Stats(name=trace.name) for _ in cfgs]
    _batch_engine.run_batch(trace, list(cfgs), stats_list)
    return stats_list
