"""Shared plumbing of the paper's figures on the port: sweep-backed
simulation and CSV rows.  The twin of ``benchmarks/common.py``.

Every figure prints ``name,us_per_call,derived`` rows.  ``us_per_call``
is the *simulated* kernel time at the paper's 704 MHz HyCUBE clock
(cycles / 704); ``derived`` carries the figure's headline metric
(speedup / utilization / rate).

All simulation goes through :mod:`repro_torch.core.cgra.sweep`: figure
drivers declare their (kernel, SimConfig) points, :func:`warm` runs the
uncached ones in parallel worker processes and persists every result to
the port's store (``REPRO_TORCH_SIMCACHE``, default
``artifacts/simcache_torch/``; never the reference's, whose digests
differ), and :func:`sim` then serves per-point statistics from the
in-process memo.

Where the reference reads ``REPRO_BENCH_QUICK`` at import and fixes its
kernel lists then, here quick mode is an argument of every ``points`` and
``run`` (:func:`quick_from_env` is the command line's default), and the
§3.4 profile's device is one too: :func:`reconfig` passes it to
``sweep.reconfigure_cached``, which on the card (``device=None``) runs
``cache_grid_scan`` or raises.
"""
from __future__ import annotations

import functools
import os
import time

from repro_torch.core.cgra import SimConfig, Stats
from repro_torch.core.cgra import sweep as sweep_engine
from repro_torch.core.cgra.trace import KERNELS, Trace

MHZ = 704.0  # HyCUBE clock (Table 3)

#: the paper's Table-1 kernel list (order matches the figures)
PAPER_KERNELS = [
    "gcn_citeseer", "gcn_cora", "gcn_pubmed", "gcn_ogbn_arxiv",
    "grad", "perm_sort", "radix_hist", "radix_update", "rgb", "src2dest",
]
#: the quick subset
QUICK_KERNELS = ["gcn_cora", "grad", "radix_hist", "rgb"]


def quick_from_env() -> bool:
    """The reference's switch, ``REPRO_BENCH_QUICK``, as a default."""
    return bool(os.environ.get("REPRO_BENCH_QUICK"))


def paper_kernels(quick: bool) -> list[str]:
    return list(QUICK_KERNELS if quick else PAPER_KERNELS)


def _fresh_report() -> dict:
    return {"seconds": 0.0, "points": 0, "cached": 0,
            "batched": 0, "runahead": 0, "scalar": 0,
            "batched_seconds": 0.0, "runahead_seconds": 0.0,
            "scalar_seconds": 0.0,
            "batched_cpu_seconds": 0.0, "runahead_cpu_seconds": 0.0,
            "scalar_cpu_seconds": 0.0,
            "ra_lockstep_lanes": 0, "ra_scalar_lanes": 0,
            "ra_groups": 0, "ra_windows": 0, "ra_shared_windows": 0,
            "ra_lockstep_ops": 0, "ra_microstep_ops": 0,
            # supervisor fault counters (runtime/supervisor.py)
            "retries": 0, "crashes": 0, "hangs": 0, "pool_rebuilds": 0,
            "fallback_tasks": 0, "quarantined": 0,
            # elastic-service counters (core/cgra/sweep.LAST_ELASTIC)
            "resumed": 0, "journal_torn": 0, "peer_served": 0,
            "lease_claimed": 0, "lease_steals": 0, "lease_lost": 0}


#: the result store; None until first use, then ``sweep.SimCache()``
STORE: sweep_engine.SimCache | None = None

_stats: dict[tuple[str, SimConfig], Stats] = {}
_meta: dict[str, dict] = {}

#: cumulative sweep accounting: wall-clock spent inside sweeps, per-engine
#: point counts and task seconds, the runahead engine's lockstep counters,
#: the supervisor's fault counters and the elastic service's
SWEEP_REPORT = _fresh_report()

#: structured report of quarantined sweep points (label, key, error)
SWEEP_FAILURES: list[dict] = []

def store() -> sweep_engine.SimCache:
    global STORE
    if STORE is None:
        STORE = sweep_engine.SimCache()
    return STORE


def reset(new_store: sweep_engine.SimCache | None = None) -> None:
    """Forget the memo and the counters, and read and write
    ``new_store`` from here on (the default store when None)."""
    global STORE
    STORE = new_store
    _stats.clear()
    _meta.clear()
    SWEEP_REPORT.clear()
    SWEEP_REPORT.update(_fresh_report())
    SWEEP_FAILURES.clear()


def warm(points) -> None:
    """Ensure every (kernel-name, SimConfig) point is simulated + memoized.

    Uncached points run in one sweep — grouped into per-trace lane batches
    for the batched/runahead engines, in parallel worker processes — and
    cached ones are read from the store.  Figure drivers call this with
    their full point list before emitting rows.
    """
    todo = [p for p in dict.fromkeys(points) if p not in _stats]
    if not todo:
        return
    t0 = time.perf_counter()
    for r in sweep_engine.sweep(todo, store=store(), allow_partial=True):
        name, cfg = r.point
        if r.error is not None:       # quarantined: report, don't memoize
            SWEEP_FAILURES.append({"label": sweep_engine.spec_label(
                sweep_engine.normalize_spec(name)), "key": r.key,
                "error": r.error})
            continue
        _stats[(name, cfg)] = r.stats
        _meta[name] = r.trace_meta
        if r.cached:
            SWEEP_REPORT["cached"] += 1
        else:
            SWEEP_REPORT[r.engine] += 1
            SWEEP_REPORT[r.engine + "_seconds"] += r.seconds
            SWEEP_REPORT[r.engine + "_cpu_seconds"] += r.cpu_seconds
            if r.diag is not None:
                mode = r.diag.get("mode")
                if mode == "lockstep":
                    SWEEP_REPORT["ra_lockstep_lanes"] += 1
                elif mode == "scalar":
                    SWEEP_REPORT["ra_scalar_lanes"] += 1
                grp = r.diag.get("group")
                if grp:
                    SWEEP_REPORT["ra_groups"] += 1
                    SWEEP_REPORT["ra_windows"] += grp["windows"]
                    SWEEP_REPORT["ra_shared_windows"] += grp["shared_windows"]
                    SWEEP_REPORT["ra_lockstep_ops"] += grp["lockstep_ops"]
                    SWEEP_REPORT["ra_microstep_ops"] += grp["microstep_ops"]
    SWEEP_REPORT["seconds"] += time.perf_counter() - t0
    SWEEP_REPORT["points"] += len(todo)
    if sweep_engine.LAST_REPORT is not None:
        for k, v in sweep_engine.LAST_REPORT.counters().items():
            SWEEP_REPORT[k] += v
    elastic = sweep_engine.LAST_ELASTIC
    if elastic:
        for k in ("resumed", "journal_torn", "peer_served"):
            SWEEP_REPORT[k] += elastic.get(k, 0)
        lease = elastic.get("lease") or {}
        for k in ("claimed", "steals", "lost"):
            SWEEP_REPORT["lease_" + k] += lease.get(k, 0)


def sim(name: str, cfg: SimConfig) -> Stats:
    """Stats for one point (served from the warm memo / store)."""
    key = (name, cfg)
    if key not in _stats:
        warm([key])
    if key not in _stats:      # quarantined by the sweep supervisor
        raise RuntimeError(
            f"sweep point {name!r} quarantined after retries "
            f"(see SWEEP_FAILURES): {SWEEP_FAILURES[-1:]}")
    return _stats[key]


def trace_meta(name: str) -> dict:
    """Static trace facts (n_accesses, irregular_fraction, footprint, ...)
    without building the trace when any simulation of it is cached."""
    if name not in _meta:
        _meta[name] = sweep_engine.trace_meta(trace(name))
    return _meta[name]


def reconfig(name: str, cfg: SimConfig, *, window: int | None = 16_384,
             device=None):
    """Cached §3.4 reconfiguration through the store, its profile on
    ``device`` (the card when None)."""
    return sweep_engine.reconfigure_cached(name, cfg, window=window,
                                           store=store(), device=device)


@functools.lru_cache(maxsize=None)
def trace(name: str) -> Trace:
    return KERNELS[name]()


def row(name: str, cycles_or_us: float, derived: str, *,
        cycles: bool = True) -> None:
    us = cycles_or_us / MHZ if cycles else cycles_or_us
    print(f"{name},{us:.2f},{derived}", flush=True)


def geomean(xs) -> float:
    prod = 1.0
    for x in xs:
        prod *= x
    return prod ** (1.0 / max(1, len(xs)))
