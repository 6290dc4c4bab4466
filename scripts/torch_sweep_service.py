"""Elastic sweep worker on the PyTorch port: one process of a crash-safe
cooperative sweep.

The twin of ``scripts/sweep_service.py`` over the port's sweep
(:mod:`repro_torch.core.cgra.sweep`), with the same command line and
report.  Its ``demo`` grid is the reference's; its ``quick`` grid is the
union of the paper's figures in quick mode,
``repro_torch.figures.run.sweep_points(quick=True)``, as the reference's
is ``benchmarks.run.sweep_points``.

Each invocation is one **worker** of the elastic sweep service: it joins a
shared simcache root, claims points through digest-keyed TTL leases
(:mod:`repro_torch.runtime.leases`), computes what it wins, makes every point
durable the moment its task completes (simcache record + write-ahead
journal entry), and polls for — or steals — the rest.  N invocations over
the same ``--store`` cooperatively drain one grid; workers may join or
leave at any time, including by ``kill -9``: a dead worker's leases
expire and a survivor reclaims its pending points, while its completed
points are already durable and are simply served from the store.

Faults are rehearsed deterministically: ``--chaos SEED:workerloss`` makes
*this process* die (``os._exit(137)``) right after deterministically
chosen points become durable — the chaos drill relaunches workers until
the grid drains and asserts bit-identical results.  ``--max-points N``
aborts the same way after N durable points (a scriptable kill).

Each worker writes a JSON report (``--report``) with what it computed,
resumed, was served by peers, and its lease/fault counters — the drills
and ``examples/sweep_elastic_torch.py`` merge these to assert "zero duplicate
simulation beyond counted lease-expiry reclaims".

Usage::

    python scripts/torch_sweep_service.py --store /tmp/cache \\
        --grid demo --worker-id w0 --report /tmp/w0.json
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

# each worker forks a small pool of its own (see the sweep module)
os.environ.setdefault("REPRO_SWEEP_WORKERS", "2")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))


def demo_points():
    """A small Table-3-style grid (~12 points), import-light."""
    from repro_torch.core.cgra import presets
    specs = (("radix_hist", {"n": 4096, "n_buckets": 512}),
             ("rgb", {"n": 2048, "palette_size": 8192}),
             ("src2dest", {"n": 2048}))
    cfgs = (presets.SPM_ONLY_4K, presets.CACHE_SPM, presets.RUNAHEAD,
            presets.RECONFIG)
    return [(spec, cfg) for spec in specs for cfg in cfgs]


def grid_points(name: str):
    if name == "demo":
        return demo_points()
    if name == "quick":
        from repro_torch.figures.run import sweep_points
        return sweep_points(quick=True)
    raise SystemExit(f"unknown grid {name!r}; want demo|quick")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", required=True,
                    help="shared simcache root (the coordination substrate)")
    ap.add_argument("--grid", default="demo", help="demo|quick point grid")
    ap.add_argument("--worker-id", default=None,
                    help="stable lease-owner id (default host:pid:rand)")
    ap.add_argument("--ttl", type=float, default=None,
                    help="lease TTL seconds (default leases.DEFAULT_TTL)")
    ap.add_argument("--poll", type=float, default=0.25,
                    help="seconds between polls of peer-held points")
    ap.add_argument("--lease-wait", type=float, default=600.0,
                    help="give up waiting on live peers after this long")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool size for this worker's own tasks")
    ap.add_argument("--report", default=None,
                    help="write a JSON worker report here")
    ap.add_argument("--chaos", default=None,
                    help="SEED:PROFILE chaos spec (e.g. 7:workerloss)")
    ap.add_argument("--max-points", type=int, default=None,
                    help="os._exit(137) after this many durable points "
                         "(scripted kill for crash drills)")
    args = ap.parse_args(argv)

    from repro_torch.core.cgra import sweep as sw
    from repro_torch.runtime import chaos as chaos_mod
    from repro_torch.runtime import leases as leases_mod

    points = grid_points(args.grid)
    plan = chaos_mod.from_spec(args.chaos) if args.chaos else None
    store = sw.SimCache(root=args.store)
    lm = leases_mod.LeaseManager(
        store.root, owner=args.worker_id,
        ttl=args.ttl if args.ttl is not None else leases_mod.DEFAULT_TTL,
        chaos=plan)

    computed: list[str] = []
    report_path = pathlib.Path(args.report) if args.report else None

    def _abort(reason: str) -> None:
        # a real crash: no lease release, no graceful shutdown, no atexit —
        # peers must recover from expiry alone.  The pool children die too
        # (a killed worker box takes its whole process tree), which also
        # keeps drills from leaking processes that pin inherited pipes.
        pool = sw._executor
        if pool is not None:
            for p in list(getattr(pool, "_processes", {}).values()):
                try:
                    p.kill()
                except Exception:
                    pass
        if report_path is not None:
            report_path.write_text(json.dumps(
                {"worker": lm.owner, "aborted": reason,
                 "computed": computed, "lease": lm.stats.to_dict()},
                indent=1, sort_keys=True))
        sys.stdout.flush()
        os._exit(137)

    def on_point(key: str) -> None:
        computed.append(key)
        if plan is not None:
            fault = plan.fire("service.point", key, 0)
            if fault is not None and fault.kind == "crash":
                _abort(f"chaos service.point crash at {key[:12]}")
        if args.max_points is not None and len(computed) >= args.max_points:
            _abort(f"max-points {args.max_points} reached")

    results = sw.sweep(points, store=store, workers=args.workers,
                       chaos=plan, allow_partial=True, leases=lm,
                       lease_poll=args.poll, lease_wait=args.lease_wait,
                       on_point=on_point)
    sw.shutdown_pool()

    rep = sw.LAST_REPORT
    elastic = sw.LAST_ELASTIC
    failed = [r.key for r in results if r.stats is None]
    out = {"worker": lm.owner, "grid": args.grid, "points": len(points),
           "computed": computed, "failed": failed,
           "resumed": elastic.get("resumed", 0),
           "peer_served": elastic.get("peer_served", 0),
           "journal_torn": elastic.get("journal_torn", 0),
           "lease": elastic.get("lease"),
           "counters": rep.counters() if rep is not None else {}}
    if report_path is not None:
        report_path.write_text(json.dumps(out, indent=1, sort_keys=True))
    print(f"sweep_service[{lm.owner}]: {len(computed)} computed, "
          f"{out['peer_served']} peer-served, {out['resumed']} resumed, "
          f"{len(failed)} failed", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
