"""The port's elastic sweep service (``scripts/torch_sweep_service.py``):
the twin of ``tests/test_service.py``, opt-in by the same ``service``
marker, and the drained store held to the reference's sweep.

Real subprocess workers, real ``os._exit(137)`` deaths, one shared
simcache root — the full crash-safe elastic protocol end to end.  These
spawn multiple worker processes each with its own 2-process pool and run
for tens of seconds, so they are excluded from the default tier-1 run
(``pytest -m service`` opts in; CI runs them as a dedicated step).
"""
import json
import pathlib
import subprocess
import sys

import pytest

pytestmark = pytest.mark.service

REPO = pathlib.Path(__file__).resolve().parent.parent
SERVICE = REPO / "scripts" / "torch_sweep_service.py"


def _worker_cmd(store, report, worker_id, *extra):
    return [sys.executable, str(SERVICE), "--store", str(store),
            "--grid", "demo", "--worker-id", worker_id, "--report",
            str(report), "--workers", "2", *extra]


def _load(report):
    return json.loads(pathlib.Path(report).read_text())


def _demo_points():
    import importlib.util
    spec = importlib.util.spec_from_file_location("sweep_service", SERVICE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.demo_points()


def _wait_for_leases(store, timeout=60.0):
    """Block until the first worker's claim-all loop has populated the
    lease dir, so a second worker launched afterwards must contend/steal
    rather than win the claims itself."""
    import time
    deadline = time.time() + timeout
    lease_dir = pathlib.Path(store) / "leases"
    while time.time() < deadline:
        if lease_dir.is_dir() and any(lease_dir.glob("*.lease")):
            return
        time.sleep(0.05)
    raise AssertionError("worker never claimed a lease")


def _verify_drained(store, tmp_path):
    """All points cached in the shared store and equal to a fresh solo run
    and to the reference's sweep of the same points."""
    from repro.core.cgra import sweep as ref_sw
    from repro_torch.core.cgra import sweep as sw
    points = _demo_points()
    merged = sw.sweep(points, store=sw.SimCache(root=store), workers=0,
                      chaos=None)
    solo = sw.sweep(points, store=sw.SimCache(root=tmp_path / "solo"),
                    workers=0, chaos=None)
    assert all(r.cached for r in merged)
    assert [r.stats.to_dict() for r in merged] == \
        [r.stats.to_dict() for r in solo]
    ref = ref_sw.sweep([(spec, ref_sw.cfg_from_json(sw.cfg_to_json(cfg)))
                        for spec, cfg in points],
                       store=ref_sw.SimCache(root=tmp_path / "ref"),
                       workers=0, chaos=None)
    assert [r.stats.to_dict() for r in merged] == \
        [r.stats.to_dict() for r in ref]


def test_two_workers_cooperatively_drain_one_grid(tmp_path):
    """Two concurrent workers share a store: every point computed exactly
    once (duplicates bounded by counted lease steals), zero failures, and
    the union is bit-identical to a single-process sweep."""
    store = tmp_path / "shared"
    pa = subprocess.Popen(_worker_cmd(store, tmp_path / "a.json", "wA"),
                          cwd=REPO)
    pb = subprocess.Popen(_worker_cmd(store, tmp_path / "b.json", "wB"),
                          cwd=REPO)
    assert pa.wait(timeout=600) == 0
    assert pb.wait(timeout=600) == 0
    a, b = _load(tmp_path / "a.json"), _load(tmp_path / "b.json")
    ca, cb = set(a["computed"]), set(b["computed"])
    assert not a["failed"] and not b["failed"]
    assert len(ca | cb) == a["points"]
    # a worker that starts after its peer drained the grid finds every
    # point durable and claims no lease (its report's lease is None):
    # importing torch takes longer than the demo grid here
    steals = sum((r["lease"] or {}).get("steals", 0) for r in (a, b))
    assert len(ca & cb) <= steals
    _verify_drained(store, tmp_path)


def test_killed_worker_resumes_from_journal(tmp_path):
    """kill -9 after four durable points: the relaunch resumes exactly
    those four from the journal and completes the rest."""
    store = tmp_path / "shared"
    rc = subprocess.run(_worker_cmd(store, tmp_path / "r1.json", "w0",
                                    "--max-points", "4"),
                        cwd=REPO, timeout=600).returncode
    assert rc == 137
    assert _load(tmp_path / "r1.json")["aborted"].startswith("max-points")

    rc = subprocess.run(_worker_cmd(store, tmp_path / "r2.json", "w1"),
                        cwd=REPO, timeout=600).returncode
    assert rc == 0
    r2 = _load(tmp_path / "r2.json")
    assert r2["resumed"] == 4
    assert len(r2["computed"]) == r2["points"] - 4
    assert r2["counters"]["quarantined"] == 0
    assert not (pathlib.Path(store) / "journal").exists() or \
        not any((pathlib.Path(store) / "journal").iterdir())
    _verify_drained(store, tmp_path)


def test_survivor_steals_leases_of_killed_peer(tmp_path):
    """Worker A dies mid-flight holding leases; worker B (short TTL)
    steals them and drains the grid alone."""
    store = tmp_path / "shared"
    pa = subprocess.Popen(
        _worker_cmd(store, tmp_path / "a.json", "wA", "--ttl", "2",
                    "--poll", "0.2", "--max-points", "3"), cwd=REPO)
    _wait_for_leases(store)   # A holds the grid before B even starts
    pb = subprocess.Popen(
        _worker_cmd(store, tmp_path / "b.json", "wB", "--ttl", "2",
                    "--poll", "0.2"), cwd=REPO)
    assert pa.wait(timeout=600) == 137
    assert pb.wait(timeout=600) == 0
    b = _load(tmp_path / "b.json")
    assert not b["failed"]
    a_computed = set(_load(tmp_path / "a.json")["computed"])
    assert len(a_computed | set(b["computed"])) == b["points"]
    assert len(a_computed & set(b["computed"])) <= b["lease"]["steals"]
    _verify_drained(store, tmp_path)
