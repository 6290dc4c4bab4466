"""The paper's figures on the port: Figs. 2/5 and 11–18 as
``name,us_per_call,derived`` CSV.  The twin of the figure half of
``benchmarks/run.py``.

    python -m repro_torch.figures.run [--quick] [--device cpu]

``us_per_call`` is simulated kernel time at the 704 MHz HyCUBE clock.
``--quick`` (default: set when ``REPRO_BENCH_QUICK`` is, as in the
reference) takes the reference's quick kernel subset.  ``--device`` is
where Figs. 17 and 18 run their §3.4 profiles: the CUDA card by default
(``cache_grid_scan``; without a card the run raises, nothing falls back),
``cpu`` for the kernels' plain version.

Execution model: every figure driver declares its (kernel, SimConfig)
sweep points, and :func:`run` warms their union through the port's sweep
in ONE parallel batch before any figure emits a row.  Traces are
pre-built and the sweep's worker pool is forked while CUDA is still
uninitialized (a caller that forked its pool earlier keeps it; after CUDA
the sweep's fork guard runs it inline).  Results persist in the port's
store (``REPRO_TORCH_SIMCACHE``, default ``artifacts/simcache_torch/``),
so a re-run only simulates points whose kernel, configuration, or
simulator source changed.  The run's summary — every figure's headline
results and the sweep's counters (``common.SWEEP_REPORT``) — goes to
``artifacts/figures_torch/summary.json``.

This is the figure half only.  It never writes ``BENCH_sim.json`` or
``artifacts/bench_summary.json``, and it runs neither the kernel
microbenchmarks (``kernels_bench``) nor the roofline pass: those measure
the port's speed and belong to its benchmark.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import torch

from repro_torch.core.cgra import sweep as sweep_engine

from . import (common, fig11_exec_time, fig12_cache_sweeps, fig13_runahead,
               fig14_mshr, fig15_accuracy, fig16_coverage, fig17_reconfig,
               fig18_frontier, motivation)

ROOT = pathlib.Path(__file__).resolve().parents[3]
SUMMARY = ROOT / "artifacts" / "figures_torch" / "summary.json"

#: (summary key, driver), in the order the figures print
FIGURES = (("motivation", motivation), ("fig11", fig11_exec_time),
           ("fig12", fig12_cache_sweeps), ("fig13", fig13_runahead),
           ("fig14", fig14_mshr), ("fig15", fig15_accuracy),
           ("fig16", fig16_coverage), ("fig17", fig17_reconfig),
           ("fig18", fig18_frontier))


def sweep_points(quick: bool = False) -> list:
    """Union of every figure driver's declared sweep points."""
    pts = []
    for _, mod in FIGURES:
        pts += mod.points(quick)
    return list(dict.fromkeys(pts))


def prepare(points) -> None:
    """Build every uncached trace (and its engine views) here, then fork
    the sweep's workers, which inherit them copy-on-write — unless a pool
    is already forked (its workers build their own) or CUDA is already
    initialized (the sweep then runs inline, on these traces)."""
    if sweep_engine._executor is not None:
        return
    sweep_engine.prewarm_traces(points, store=common.store())
    if not torch.cuda.is_initialized():
        sweep_engine.ensure_pool()


def run(quick: bool = False, device=None) -> dict:
    """Every figure's rows, printed; returns their summaries, with the
    union's size and the seconds until it was warm."""
    t0 = time.time()
    pts = sweep_points(quick)
    prepare(pts)
    common.warm(pts)
    summary = {"sweep_points": len(pts), "sweep_seconds": time.time() - t0}
    for key, mod in FIGURES:
        summary[key] = mod.run(quick, device)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    default=common.quick_from_env(),
                    help="the quick kernel subset (default: "
                         "REPRO_BENCH_QUICK)")
    ap.add_argument("--device", default=None,
                    help="device of the §3.4 profiles (default: the CUDA "
                         "card)")
    ap.add_argument("--summary", default=str(SUMMARY),
                    help="where the run's summary JSON goes")
    args = ap.parse_args(argv)

    print("name,us_per_call,derived")
    t0 = time.time()
    try:
        summary = run(args.quick, args.device)
    finally:
        sweep_engine.shutdown_pool()
    summary.update(quick=args.quick, device=str(args.device or "cuda"),
                   wall_seconds=time.time() - t0,
                   sweep_report=dict(common.SWEEP_REPORT),
                   failures=common.SWEEP_FAILURES[:20])
    path = pathlib.Path(args.summary)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(summary, indent=2, default=float))
    print(f"total_figure_seconds,{(time.time() - t0) * 1e6:.0f},"
          f"wrote={path}", flush=True)
    return 1 if common.SWEEP_FAILURES else 0


if __name__ == "__main__":
    raise SystemExit(main())
