"""The elastic sweep service on the PyTorch port: cooperating workers, one
killed mid-flight.

The twin of ``examples/sweep_elastic.py``.  Launches two
``scripts/torch_sweep_service.py`` workers over one shared simcache
root.  Worker A is scripted to die after three durable points — a real
``os._exit(137)``, no cleanup, exactly what ``kill -9`` leaves behind:
held leases that nobody will ever release.  Worker B (short lease TTL)
polls A's points, watches A's leases expire, **steals** them, and drains
the rest of the grid alone.  The demo then asserts the crash cost
nothing:

* every point is durable and served from cache on a final verify pass;
* the merged result is **bit-identical** to a fault-free single-process
  sweep of the same grid into a fresh store;
* duplicate simulation happened at most where a lease was explicitly
  stolen (the ``steals`` counter) — never silently.

Then the shared store serves the §3.4 loop too: each demo trace is
reconfigured through :func:`reconfigure_cached`, its profile on
``--device`` (the CUDA card when omitted), and a second pass is served
from the store without a profile.

Usage:  PYTHONPATH=src python examples/sweep_elastic_torch.py [--device cpu]
"""
import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
SERVICE = REPO / "scripts" / "torch_sweep_service.py"


def worker(store, report, worker_id, *extra):
    return subprocess.Popen(
        [sys.executable, str(SERVICE), "--store", str(store),
         "--grid", "demo", "--worker-id", worker_id, "--ttl", "2",
         "--poll", "0.2", "--report", str(report), "--workers", "2",
         *extra],
        cwd=REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the reconfigurations' profiles; "
                         "the CUDA card when omitted")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import resolve_device
    from repro_torch.core.cgra import presets
    from repro_torch.core.cgra import sweep as sw

    device = resolve_device(args.device)
    import importlib.util
    spec = importlib.util.spec_from_file_location("sweep_service", SERVICE)
    svc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(svc)
    points = svc.demo_points()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        store = tmp / "shared"
        print(f"== two workers, one shared store, {len(points)} points; "
              "worker A dies after 3")
        pa = worker(store, tmp / "a.json", "workerA", "--max-points", "3")
        # wait for A's claim-all loop so B must contend, then steal — a
        # simultaneous launch can let B win every claim and A dies idle
        lease_dir = store / "leases"
        deadline = time.time() + 60
        while time.time() < deadline and not (
                lease_dir.is_dir() and any(lease_dir.glob("*.lease"))):
            time.sleep(0.05)
        pb = worker(store, tmp / "b.json", "workerB")
        ra, rb = pa.wait(timeout=600), pb.wait(timeout=600)
        a = json.loads((tmp / "a.json").read_text())
        b = json.loads((tmp / "b.json").read_text())
        print(f"   worker A: rc={ra} computed={len(a['computed'])} "
              f"({a.get('aborted', 'completed')})")
        print(f"   worker B: rc={rb} computed={len(b['computed'])} "
              f"peer-served={b['peer_served']} "
              f"steals={b['lease']['steals']}")

        dup = set(a["computed"]) & set(b["computed"])
        steals = b["lease"]["steals"]
        print(f"   duplicates={len(dup)} (allowed up to {steals} counted "
              "lease steals)")
        assert ra == 137 and rb == 0
        assert len(dup) <= steals

        # merged store must match a fault-free single-process sweep
        merged = sw.sweep(points, store=sw.SimCache(root=store),
                          workers=0, chaos=None)
        single = sw.sweep(points, store=sw.SimCache(root=tmp / "solo"),
                          workers=0, chaos=None)
        assert all(m.cached for m in merged), "grid was not fully drained"
        same = all(m.stats.to_dict() == s.stats.to_dict()
                   for m, s in zip(merged, single))
        print(f"\n== merged two-worker result bit-identical to "
              f"single-process sweep: {same}")
        assert same

        # the §3.4 loop through the shared store: profiled once, then served
        specs = list(dict.fromkeys(json.dumps(p[0]) for p in points))
        shared = sw.SimCache(root=store)
        cold = [sw.reconfigure_cached(json.loads(s), presets.RECONFIG,
                                      window=2048, store=shared,
                                      device=device) for s in specs]
        warm = [sw.reconfigure_cached(json.loads(s), presets.RECONFIG,
                                      window=2048, store=shared,
                                      device=device) for s in specs]
        assert all(r.h_curves is not None for r in cold)
        assert all(r.h_curves is None for r in warm)
        assert [r.allocations for r in warm] == [r.allocations for r in cold]
        print(f"\n== {len(specs)} reconfigurations through the shared store "
              f"(profile on {device}): allocations "
              f"{[r.allocations for r in cold]}; second pass served from "
              f"the store: {all(r.h_curves is None for r in warm)}")
        sw.shutdown_pool()


if __name__ == "__main__":
    main()
