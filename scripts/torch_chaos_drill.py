"""Chaos drill on the PyTorch port: the quick sweep must survive injected
faults bit-exactly.

The twin of ``scripts/chaos_drill.py`` over the port's sweep
(:mod:`repro_torch.core.cgra.sweep`), chaos layer and elastic worker
(``scripts/torch_sweep_service.py``), with the same command line.

For each requested chaos profile (see
:data:`repro_torch.runtime.chaos.PROFILES`) this drives the full
quick-mode figure sweep — the same point union
``python -m repro_torch.figures.run --quick`` warms — into a throwaway
store while the plan injects worker crashes, task hangs, or storage
corruption, and asserts:

* the sweep **completes without operator intervention** — zero quarantined
  points (every injected fault was absorbed by retry / pool rebuild /
  scalar fallback);
* the per-point ``Stats`` are **bit-identical** to a fault-free baseline
  sweep of the same points (chaos may cost retries, never results);
* for storage-corruption profiles, a second, warm pass over the damaged
  store quarantines the corrupt records, transparently recomputes them,
  and still matches the baseline bit-exactly.

The **elastic service profiles** (``workerloss``, ``leaseexpire``,
``tornjournal``) drill ``scripts/torch_sweep_service.py`` with real subprocess
workers instead: a worker is killed mid-sweep (``os._exit(137)``, no
cleanup) and either a relaunch resumes from the write-ahead journal
(kill-resume drill) or a concurrently-running peer steals its expired
leases and drains the rest (two-worker race drill).  Both assert
bit-identical stats, zero quarantined points, zero lost index entries,
and zero duplicate simulation beyond counted lease-expiry reclaims.

Determinism: each profile runs under a seed-keyed :class:`ChaosPlan`, so a
failing drill replays exactly from the seed printed in its summary line.

Usage::

    python scripts/torch_chaos_drill.py                  # default drills
    python scripts/torch_chaos_drill.py --profiles taskhang --seed 9
    python scripts/torch_chaos_drill.py \\
        --profiles workerloss,leaseexpire,tornjournal    # elastic drills
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

# the drill process never initializes CUDA, so the sweep can fork real
# workers (see sweep._pool_for_sweep); default to a small pool even on
# 1-cpu runners so crash/hang drills exercise BrokenProcessPool and
# deadline kills for real
os.environ.setdefault("REPRO_SWEEP_WORKERS", "2")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

DEFAULT_PROFILES = ["workercrash", "taskhang", "cachecorrupt"]

#: profiles drilled through the elastic sweep *service* (real subprocess
#: workers, real kill -9-style deaths, lease stealing, journal resume)
ELASTIC_PROFILES = ("workerloss", "leaseexpire", "tornjournal")

_SERVICE = pathlib.Path(__file__).with_name("torch_sweep_service.py")


def _demo_points():
    spec = importlib.util.spec_from_file_location("torch_sweep_service",
                                                  _SERVICE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.demo_points()


def quick_points():
    """The quick-mode figure union (the classic drills' grid)."""
    from repro_torch.figures.run import sweep_points
    return sweep_points(quick=True)


def _worker(store, report, *, chaos=None, max_points=None, worker_id=None,
            ttl=None, timeout=600):
    """One torch_sweep_service worker subprocess; returns (rc, report
    dict)."""
    cmd = [sys.executable, str(_SERVICE), "--store", str(store),
           "--grid", "demo", "--report", str(report), "--workers", "2"]
    if chaos is not None:
        cmd += ["--chaos", chaos]
    if max_points is not None:
        cmd += ["--max-points", str(max_points)]
    if worker_id is not None:
        cmd += ["--worker-id", worker_id]
    if ttl is not None:
        cmd += ["--ttl", str(ttl)]
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run(cmd, env=env, timeout=timeout,
                          cwd=pathlib.Path(__file__).resolve().parent.parent)
    try:
        rep = json.loads(pathlib.Path(report).read_text())
    except (OSError, ValueError):
        rep = {}
    return proc.returncode, rep


def _drained_map(points, root, base):
    """Serve the drained grid from ``root`` (all cached) and diff vs base."""
    from repro_torch.core.cgra import sweep as sw
    store = sw.SimCache(root=root)
    res = sw.sweep(points, store=store, workers=0, chaos=None,
                   allow_partial=True)
    got = stats_map(res)
    problems = []
    if got != base:
        diff = sum(1 for k in base if got.get(k) != base[k])
        problems.append(f"{diff} points differ from baseline")
    if not all(r.cached for r in res):
        problems.append("grid not fully drained (recomputed on verify)")
    return problems


def drill_kill_resume(points, base, tmp, profile, seed):
    """A worker dies mid-sweep (chaos crash or scripted kill); relaunches
    resume from journal + simcache until the grid drains bit-identically."""
    store = tmp / f"{profile}_store"
    counters = {"relaunches": 0, "resumed": 0, "quarantined": 0,
                "journal_torn": 0}
    problems = []
    chaos = f"{seed}:{profile}"
    # tornjournal never kills by itself: script the kill so the resume
    # path replays (and drops) the torn entries it produced
    max_points = 5 if profile == "tornjournal" else None
    for _ in range(len(points) + 2):     # each relaunch makes progress
        rc, rep = _worker(store, tmp / f"{profile}_w.json", chaos=chaos,
                          max_points=max_points)
        max_points = None
        if "aborted" not in rep:
            counters["resumed"] += rep.get("resumed", 0)
            counters["journal_torn"] += rep.get("journal_torn", 0)
            counters["quarantined"] += rep.get("counters", {}).get(
                "quarantined", 0)
            if rc != 0:
                problems.append(f"worker exited rc={rc}")
            break
        counters["relaunches"] += 1
    else:
        problems.append("grid never drained")
    if counters["relaunches"] == 0:
        problems.append("no worker death was injected (drill vacuous)")
    if counters["resumed"] == 0:
        problems.append("no points were resumed from the journal")
    if counters["quarantined"]:
        problems.append(f"{counters['quarantined']} quarantined")
    problems += _drained_map(points, store, base)
    return problems, counters


def drill_two_worker_race(points, base, tmp, profile, seed):
    """Two workers share one store; one dies mid-flight (scripted kill)
    while chaos suppresses heartbeats, so the survivor must *steal* the
    dead worker's expired leases and drain the rest alone."""
    store = tmp / f"{profile}_store"
    env = dict(os.environ, PYTHONPATH="src")
    repo = pathlib.Path(__file__).resolve().parent.parent

    def spawn(worker_id, report, extra):
        cmd = [sys.executable, str(_SERVICE), "--store", str(store),
               "--grid", "demo", "--report", str(report), "--workers", "2",
               "--worker-id", worker_id, "--ttl", "2", "--poll", "0.2",
               "--chaos", f"{seed}:{profile}"] + extra
        return subprocess.Popen(cmd, env=env, cwd=repo)

    pa = spawn("wA", tmp / "race_a.json", ["--max-points", "3"])
    # Let A's claim-all loop populate the lease dir before B starts, so
    # B must contend and later steal A's expired leases (deterministic;
    # a simultaneous launch sometimes lets B win every claim, leaving A
    # nothing to die over).
    lease_dir = store / "leases"
    deadline = time.time() + 60
    while time.time() < deadline and not (
            lease_dir.is_dir() and any(lease_dir.glob("*.lease"))):
        time.sleep(0.05)
    pb = spawn("wB", tmp / "race_b.json", [])
    ra = pa.wait(timeout=600)
    rb = pb.wait(timeout=600)
    reps = {}
    for name, p in (("a", tmp / "race_a.json"), ("b", tmp / "race_b.json")):
        try:
            reps[name] = json.loads(p.read_text())
        except (OSError, ValueError):
            reps[name] = {}
    ca = set(reps["a"].get("computed", []))
    cb = set(reps["b"].get("computed", []))
    la = reps["a"].get("lease") or {}
    lb = reps["b"].get("lease") or {}
    steals = la.get("steals", 0) + lb.get("steals", 0)
    dup = len(ca & cb)
    counters = {"a_rc": ra, "b_rc": rb, "a_computed": len(ca),
                "b_computed": len(cb), "duplicates": dup, "steals": steals,
                "b_peer_served": reps["b"].get("peer_served", 0),
                "quarantined": reps["b"].get("counters", {}).get(
                    "quarantined", 0)}
    problems = []
    if ra != 137:
        problems.append(f"worker A survived its scripted kill (rc={ra})")
    if rb != 0:
        problems.append(f"survivor B failed rc={rb}")
    if dup > steals:
        problems.append(f"{dup} duplicate sims > {steals} counted steals")
    if counters["quarantined"]:
        problems.append(f"{counters['quarantined']} quarantined")
    problems += _drained_map(points, store, base)
    # zero lost index entries: the rebuilt index must cover every point
    from repro_torch.core.cgra import sweep as sw
    store2 = sw.SimCache(root=store)
    counters["index_entries"] = store2.rebuild_index()
    idx = json.loads((store2.root / "index.json").read_text())["entries"]
    missing = [k for k in base if k not in idx]
    if missing:
        problems.append(f"{len(missing)} index entries lost")
    return problems, counters


def run_elastic_drills(profiles, seed) -> bool:
    """Drill the elastic service profiles; returns True when any failed."""
    from repro_torch.core.cgra import sweep as sw
    points = _demo_points()
    failed = False
    with tempfile.TemporaryDirectory(prefix="elastic_drill_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        base_res, _, _ = run_sweep(points, tmp / "baseline", None)
        base = stats_map(base_res)
        assert all(v is not None for v in base.values()), \
            "fault-free baseline sweep failed"
        print(f"chaos_drill: elastic baseline {len(points)} points in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for profile in profiles:
            drill = (drill_two_worker_race if profile == "leaseexpire"
                     else drill_kill_resume)
            t0 = time.perf_counter()
            problems, counters = drill(points, base, tmp, profile, seed)
            status = "FAIL" if problems else "ok"
            print(f"chaos_drill[{profile} seed={seed}]: {status} "
                  f"({time.perf_counter() - t0:.1f}s) "
                  + " ".join(f"{k}={v}" for k, v in sorted(counters.items()))
                  + ("  << " + "; ".join(problems) if problems else ""),
                  flush=True)
            failed = failed or bool(problems)
        sw.shutdown_pool()
    return failed


def run_sweep(points, root, plan, *, deadline=None):
    """One full sweep of ``points`` into a fresh store under ``plan``."""
    from repro_torch.core.cgra import sweep as sw
    store = sw.SimCache(root=root)
    results = sw.sweep(points, store=store, chaos=plan, allow_partial=True,
                       deadline=deadline)
    rep = sw.LAST_REPORT
    counters = rep.counters() if rep is not None else {}
    return results, store, counters


def stats_map(results) -> dict:
    return {r.key: (None if r.stats is None else r.stats.to_dict())
            for r in results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profiles", default=",".join(DEFAULT_PROFILES),
                    help="comma-separated chaos profiles to drill")
    ap.add_argument("--seed", type=int, default=20260808,
                    help="chaos plan seed (printed for replay)")
    ap.add_argument("--hang-deadline", type=float, default=10.0,
                    help="fixed per-task deadline for hang profiles; the "
                         "injected hang sleeps far past it")
    args = ap.parse_args(argv)

    requested = [p.strip() for p in args.profiles.split(",") if p.strip()]
    classic = [p for p in requested if p not in ELASTIC_PROFILES]
    elastic = [p for p in requested if p in ELASTIC_PROFILES]

    failed = False
    if elastic:
        failed = run_elastic_drills(elastic, args.seed)
    if not classic:
        return 1 if failed else 0

    from repro_torch.core.cgra import sweep as sw
    from repro_torch.runtime import chaos as chaos_mod

    points = quick_points()
    with tempfile.TemporaryDirectory(prefix="chaos_drill_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        base_res, _, _ = run_sweep(points, tmp / "baseline", None)
        base = stats_map(base_res)
        assert all(v is not None for v in base.values()), \
            "fault-free baseline sweep failed"
        print(f"chaos_drill: baseline {len(points)} points in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        for profile in classic:
            plan = chaos_mod.ChaosPlan(args.seed, profile,
                                       chaos_mod.PROFILES[profile])
            # injected hangs sleep ~30s; a tight fixed deadline keeps the
            # drill fast and forces the supervisor's kill-and-retry path
            deadline = args.hang_deadline if any(
                r.kind == "hang" for r in plan.rules) else None
            t0 = time.perf_counter()
            root = tmp / profile
            res, store, counters = run_sweep(points, root, plan,
                                             deadline=deadline)
            got = stats_map(res)
            problems = []
            if counters.get("quarantined"):
                problems.append(f"{counters['quarantined']} quarantined")
            if got != base:
                diff = sum(1 for k in base if got.get(k) != base[k])
                problems.append(f"{diff} points differ from baseline")

            if profile == "cachecorrupt":
                # second pass over the damaged store: corrupt records must
                # quarantine + recompute, and the index must rebuild
                res2, store2, _ = run_sweep(points, root, None)
                if stats_map(res2) != base:
                    problems.append("warm re-read differs from baseline")
                counters["warm_quarantined"] = store2.quarantined
                counters["index_entries"] = store2.rebuild_index()

            status = "FAIL" if problems else "ok"
            print(f"chaos_drill[{profile} seed={args.seed}]: {status} "
                  f"({time.perf_counter() - t0:.1f}s) "
                  + " ".join(f"{k}={v}" for k, v in sorted(counters.items()))
                  + ("  << " + "; ".join(problems) if problems else ""),
                  flush=True)
            failed = failed or bool(problems)
        sw.shutdown_pool()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
