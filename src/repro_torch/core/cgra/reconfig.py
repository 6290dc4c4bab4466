"""Cache reconfiguration (§3.4): Algorithm 1 + Time Hit Rate + the closed loop.

The twin of ``repro.core.cgra.reconfig``.  Flow (mirrors Fig. 8): sample
each L1's access stream over an observation window -> profile
``h_i(L_i, S_i)`` across the (ways x line) grid -> pick ``H_i(S_i) = max_L
h_i(L, S_i)`` -> run the Algorithm-1 DP to split the total cache ways ->
emit a per-cache :class:`CacheConfig` assignment.

Everything but the profile is the reference's code.  The reference
profiles on the CPU with ``_batch_engine.lru_miss_counts`` and names the
``jaxcache`` scan as its accelerator twin; here the profile runs that twin,
:func:`cache_grid.miss_counts`: on the card one ``cache_grid_scan`` call
per non-empty stream over the whole (ways x line) grid, on the CPU the
kernels' plain version in their order
(:func:`cache_grid.hit_series_stack_ref`), a different algorithm from the
reference's.  Both give the reference's miss
counts exactly on the streams they accept; they refuse, rather than
diverge on, more than ``cache_grid.MAX_WAYS`` ways and addresses outside
``[0, 2**31)`` (the kernels compute in int32 and start each set at tag -1).

The objective maximizes ``sum_i log H_i(S_i)`` (product of hit rates: in a
lock-step CGRA a miss in *any* cache stalls every PE, so per-window all-hit
probability is what matters — the paper's footnote 1).  ``H`` can be either
the traditional hit rate or the paper's redefined **Time Hit Rate**
(1 - misses / window length); both are implemented so the improvement claimed
in §3.4.2 can be measured.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch import resolve_device

from . import cache_grid
from .cache import CacheConfig
from .simulator import SimConfig, plan_spm
from .trace import Trace

EPS = 1e-6


# ---------------------------------------------------------------------------
# Algorithm 1: Optimal Cache Way Allocation (verbatim DP port, O(n * T^2))
# ---------------------------------------------------------------------------

def algorithm1(profit: np.ndarray, t_max: int) -> tuple[float, list[int]]:
    """``max_profit(H, T_max)`` from the paper.

    Args:
      profit: ``[n, t_max + 1]`` — profit of giving cache *i* exactly *k* ways.
      t_max:  total cache ways available.

    Returns:
      (max profit, per-cache way allocation) with ``sum(alloc) <= t_max``.
    """
    h = np.asarray(profit, dtype=np.float64)
    n = h.shape[0]
    assert h.shape[1] >= t_max + 1, "profit matrix narrower than T_max"

    dp = np.zeros((n + 1, t_max + 1))
    choice = np.zeros((n + 1, t_max + 1), dtype=np.int64)
    for i in range(1, n + 1):
        dp[i][0] = sum(h[k][0] for k in range(i))           # base: no allocation
    for i in range(1, n + 1):
        for j in range(1, t_max + 1):
            best = dp[i - 1][j] + h[i - 1][0]               # default: 0 ways
            best_k = 0
            for k in range(1, j + 1):
                cand = dp[i - 1][j - k] + h[i - 1][k]
                if cand > best:
                    best = cand
                    best_k = k
            dp[i][j] = best
            choice[i][j] = best_k

    # backtrace via the recorded argmax (float-exact, unlike re-deriving the
    # winning k with a tolerance compare, which mis-selects on near-ties)
    allocations = [0] * n
    j = t_max
    for i in range(n, 0, -1):
        allocations[i - 1] = int(choice[i][j])
        j -= allocations[i - 1]
    return float(dp[n][t_max]), allocations


def brute_force_allocation(profit: np.ndarray, t_max: int) -> tuple[float, list[int]]:
    """Exponential reference for property tests."""
    h = np.asarray(profit, dtype=np.float64)
    n = h.shape[0]
    best, best_alloc = -np.inf, [0] * n
    for alloc in itertools.product(range(t_max + 1), repeat=n):
        if sum(alloc) > t_max:
            continue
        p = sum(h[i][alloc[i]] for i in range(n))
        if p > best + 1e-12:
            best, best_alloc = p, list(alloc)
    return float(best), best_alloc


# ---------------------------------------------------------------------------
# Hit-rate metrics
# ---------------------------------------------------------------------------

def traditional_hit_rate(hits: np.ndarray) -> float:
    """hits / total accesses."""
    return float(hits.mean()) if hits.size else 1.0


def time_hit_rate(hits: np.ndarray, iters: np.ndarray) -> float:
    """1 - misses / window-length (§3.4.2), window measured in iterations
    (the II-normalized time proxy available at profiling time)."""
    if hits.size == 0:
        return 1.0
    window = float(iters.max() - iters.min() + 1)
    misses = float((~hits).sum())
    return max(EPS, 1.0 - misses / max(window, 1.0))


# ---------------------------------------------------------------------------
# Profiling + the closed reconfiguration loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReconfigResult:
    allocations: list[int]              # ways per L1
    lines: list[int]                    # line size per L1
    profit: float
    h_curves: np.ndarray                # [n_caches, n_way_opts, n_line_opts]
    config: SimConfig                   # base config with l1_per_cache set


def sample_streams(trace: Trace, cfg: SimConfig,
                   window: int | None = None) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-L1 sampled (addr, iter_id) streams — the hardware tracker's
    observation window (Fig. 8a)."""
    in_spm = plan_spm(trace, cfg.spm_bytes)
    streams = []
    cache_of = trace.pe.astype(np.int64) % cfg.n_caches
    for c in range(cfg.n_caches):
        mask = (cache_of == c) & ~in_spm
        addrs = trace.addr[mask]
        iters = trace.iter_id[mask]
        if window is not None and addrs.size > window:
            addrs, iters = addrs[:window], iters[:window]
        streams.append((addrs, iters))
    return streams


def profile_curves(streams, way_options, line_options, way_bytes: int,
                   metric: str = "time", device=None) -> np.ndarray:
    """``h[i, w, l]`` hit-rate of cache *i* with ``way_options[w]`` ways and
    ``line_options[l]`` line bytes, on ``device`` (CUDA when None).

    Both metrics depend on the stream only through its miss *count* (and the
    iteration window), so one grid pass per non-empty stream supplies the
    whole grid: one ``cache_grid_scan`` launch on the card.  The grid is
    ways-major, so its [C] miss counts reshape to [ways, lines] as the
    reference's ``lru_miss_counts`` lays them out.
    """
    device = resolve_device(device)
    way_options, line_options = list(way_options), list(line_options)
    profiled = [np.asarray(addrs, dtype=np.int64) for addrs, _ in streams]
    # refuse what the kernels would compute differently from the
    # reference's int64 stack pass
    if max(way_options) > cache_grid.MAX_WAYS:
        raise ValueError(f"profile_curves: {max(way_options)} ways; the "
                         f"cache-grid kernels take at most "
                         f"{cache_grid.MAX_WAYS} (one lane per stack depth)")
    for i, a in enumerate(profiled):
        if a.size and (a.min() < 0 or a.max() >= 2**31):
            raise ValueError(f"profile_curves: stream {i} has addresses in "
                             f"[{a.min()}, {a.max()}]; the cache-grid "
                             f"kernels take [0, 2**31) (int32, cold tag -1)")
    grid = cache_grid.ConfigGrid.build(way_bytes, way_options, line_options)
    counts = [cache_grid.miss_counts(a, grid, device) if a.size else None
              for a in profiled]
    out = np.zeros((len(streams), len(way_options), len(line_options)))
    for i, ((addrs, iters), m) in enumerate(zip(streams, counts)):
        if m is None:
            out[i] = 1.0
            continue
        misses = m.cpu().numpy().reshape(len(way_options), -1) \
            .astype(np.float64)
        if metric == "time":
            window = float(iters.max() - iters.min() + 1)
            out[i] = np.maximum(EPS, 1.0 - misses / max(window, 1.0))
        else:
            out[i] = (float(addrs.size) - misses) / float(addrs.size)
    return out


def reconfigure(trace: Trace, cfg: SimConfig, total_ways: int | None = None,
                line_options=(16, 32, 64, 128), window: int | None = 16_384,
                metric: str = "time", device=None) -> ReconfigResult:
    """The full §3.4 loop: sample -> profile -> DP -> new configuration,
    the profile on ``device`` (CUDA when None)."""
    n = cfg.n_caches
    way_bytes = cfg.l1.way_bytes
    if total_ways is None:
        total_ways = cfg.l1.ways * n
    way_options = list(range(total_ways + 1))

    streams = sample_streams(trace, cfg, window)
    h = profile_curves(streams, way_options, line_options, way_bytes, metric,
                       device)

    # H_i(S_i) = max over line sizes; remember the argmax line per (i, S_i)
    H = h.max(axis=2)                                   # [n, ways+1]
    best_line = h.argmax(axis=2)                        # [n, ways+1]
    profit = np.log(np.maximum(H, EPS))
    total_profit, alloc = algorithm1(profit, total_ways)

    lines = [int(line_options[best_line[i, alloc[i]]]) for i in range(n)]
    per_cache = tuple(
        CacheConfig(ways=alloc[i], line=lines[i], way_bytes=way_bytes)
        for i in range(n)
    )
    new_cfg = dataclasses.replace(cfg, l1_per_cache=per_cache)
    return ReconfigResult(alloc, lines, total_profit, h, new_cfg)
