"""Fault-tolerant sweeping under deterministic chaos injection, on the
PyTorch port.

The twin of ``examples/sweep_chaos.py``: scenarios 1-3 print what the
reference prints.  A fourth runs the store-backed §3.4 reconfiguration, the
one sweep-service call that reaches the card, its profile on ``--device``
(the CUDA card when omitted).

Drives a small Table-3-style sweep while a seed-keyed :class:`ChaosPlan`
injects faults, and prints the supervisor's structured report after each
scenario:

1. **Transient crashes + storage corruption** — workers die mid-task and
   just-written simcache records are torn; retry, pool rebuild, and
   checksum-quarantine-recompute absorb all of it and the results stay
   bit-identical to a fault-free run.
2. **A persistent engine "bug"** — every lane-batch attempt raises, so the
   supervisor degrades each batch to per-point tasks on the scalar golden
   engine: throughput drops, correctness and availability don't.
3. **A doomed point** — one trace fails even on the scalar engine; the
   sweep completes anyway (``allow_partial=True``) with that point
   quarantined and reported, never silently dropped.
4. **A torn reconfiguration record** — :func:`reconfigure_cached` profiles
   on the device and stores its result; the record is torn; the next call
   quarantines it and profiles again, to the same allocation, and the
   call after that is served from the store without a profile.

Everything is deterministic in the plan seed — rerunning this script
reproduces the same faults, retries, and report.

Usage:  PYTHONPATH=src python examples/sweep_chaos_torch.py [--device cpu]
"""
import argparse
import pathlib
import tempfile

from repro_torch import resolve_device
from repro_torch.core.cgra import presets
from repro_torch.core.cgra import sweep as sw
from repro_torch.runtime import chaos

POINTS = [(spec, cfg)
          for spec in (("radix_hist", {"n": 4096, "n_buckets": 512}),
                       ("rgb", {"n": 2048, "palette_size": 8192}),
                       ("src2dest", {"n": 2048}))
          for cfg in (presets.CACHE_SPM, presets.RUNAHEAD)]


def report(title, results):
    rep = sw.LAST_REPORT
    print(f"\n== {title}")
    if rep is not None:
        print("   supervisor:", " ".join(f"{k}={v}" for k, v in
                                         sorted(rep.counters().items())))
    for r in results:
        label = sw.spec_label(sw.normalize_spec(r.point[0]))
        if r.error is not None:
            print(f"   {label:<42} QUARANTINED: {r.error}")
        else:
            print(f"   {label:<42} engine={r.engine:<8} "
                  f"cycles={r.stats.cycles}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the reconfiguration's profile; "
                         "the CUDA card when omitted")
    device = resolve_device(ap.parse_args(argv).device)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)

        baseline = sw.sweep(POINTS, store=sw.SimCache(root=tmp / "a"),
                            workers=0, chaos=None)
        report("fault-free baseline", baseline)

        # 1. transient worker crashes + torn simcache records
        plan = chaos.ChaosPlan(seed=7, profile="demo", rules=(
            chaos.ChaosRule("sweep.task", "crash", rate=0.5),
            chaos.ChaosRule("simcache.put", "torn_write", rate=0.3),
            chaos.ChaosRule("simcache.index", "drop_index", rate=1.0)))
        store = sw.SimCache(root=tmp / "b")
        res = sw.sweep(POINTS, store=store, workers=0, chaos=plan)
        report("transient crashes + corruption (recovered)", res)
        same = all(b.stats.to_dict() == r.stats.to_dict()
                   for b, r in zip(baseline, res))
        print(f"   bit-identical to baseline: {same}")

        # ...and the torn records are caught on the next read: checksums
        # fail, the files are quarantined, the points recompute
        store2 = sw.SimCache(root=tmp / "b")
        res = sw.sweep(POINTS, store=store2, workers=0, chaos=None)
        print(f"\n== warm re-read over the damaged store")
        print(f"   quarantined records: {store2.quarantined}, "
              f"index rebuilt with {store2.rebuild_index()} entries, "
              f"served {sum(r.cached for r in res)}/{len(res)} from cache")

        # 2. persistent engine bug -> scalar golden-engine fallback
        plan = chaos.ChaosPlan(seed=7, profile="enginebug",
                               rules=chaos.PROFILES["enginebug"])
        res = sw.sweep(POINTS, store=sw.SimCache(root=tmp / "c"),
                       workers=0, chaos=plan)
        report("persistent batch-engine bug (degraded to scalar)", res)
        same = all(b.stats.to_dict() == r.stats.to_dict()
                   for b, r in zip(baseline, res))
        print(f"   bit-identical to baseline: {same}")

        # 3. one doomed trace -> quarantine, sweep still completes
        plan = chaos.ChaosPlan(seed=7, profile="doomed", rules=(
            chaos.ChaosRule("sweep.task", "raise", rate=1.0,
                            first_attempt_only=False, match="radix_hist"),))
        res = sw.sweep(POINTS, store=sw.SimCache(root=tmp / "d"),
                       workers=0, chaos=plan, allow_partial=True)
        report("doomed point (quarantined, sweep completes)", res)

        # 4. a torn reconfiguration record: quarantined, profiled again
        spec = POINTS[0][0]
        store = sw.SimCache(root=tmp / "e")
        first = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048,
                                      store=store, device=device)
        key = sw.point_key(sw.normalize_spec(spec), presets.RECONFIG,
                           kind="reconfig",
                           extra={"window": 2048, "metric": "time"})
        chaos.corrupt_record(store, key, chaos.Fault("torn_write", 0.0,
                                                     "simcache.put", key, 0))
        again = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048,
                                      store=store, device=device)
        served = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048,
                                       store=store, device=device)
        print(f"\n== torn reconfiguration record (profile on {device})")
        print(f"   allocations {first.allocations} lines {first.lines}; "
              f"after the tear: quarantined={store.quarantined} "
              f"profiled again={again.h_curves is not None} "
              f"same={again.allocations == first.allocations}; "
              f"then served from the store={served.h_curves is None}")


if __name__ == "__main__":
    main()
