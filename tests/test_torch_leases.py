"""The port's lease protocol (``repro_torch.runtime.leases``): the twin of
``tests/test_leases.py`` — exclusive claiming, TTL expiry, atomic
stealing, heartbeats (including chaos-suppressed ones), and loss
detection — with lease files byte-identical to the reference's, and the
elastic-service example twin.

Time is a controlled fake clock, so expiry is exact and the tests never
sleep.  Two :class:`LeaseManager` instances over one root stand in for
two worker processes — the protocol is pure filesystem, so in-process
managers exercise the same atomic-rename races real workers would.
"""
import json
import subprocess
import sys
from pathlib import Path

from repro.runtime import leases as ref_leases
from repro_torch.runtime import chaos, leases

ROOT = Path(__file__).resolve().parents[1]


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def mk(root, owner, clock, ttl=10.0, plan=None):
    return leases.LeaseManager(root, owner=owner, ttl=ttl, chaos=plan,
                               clock=clock)


def test_fresh_claim_is_exclusive(tmp_path):
    c = Clock()
    a, b = mk(tmp_path, "a", c), mk(tmp_path, "b", c)
    assert a.acquire("k")
    assert not b.acquire("k")
    assert a.stats.claimed == 1 and b.stats.contended == 1
    assert json.loads(a.path("k").read_text())["owner"] == "a"


def test_acquire_is_reentrant(tmp_path):
    c = Clock()
    a = mk(tmp_path, "a", c)
    assert a.acquire("k") and a.acquire("k")
    assert a.stats.claimed == 1                 # second acquire was a no-op


def test_expired_lease_is_stolen(tmp_path):
    c = Clock()
    a, b = mk(tmp_path, "a", c), mk(tmp_path, "b", c)
    assert a.acquire("k")
    c.t += 5.0
    assert not b.acquire("k")                   # still live
    c.t += 6.0                                  # past a's ttl=10
    assert b.acquire("k")
    assert b.stats.steals == 1
    assert json.loads(b.path("k").read_text())["owner"] == "b"


def test_torn_lease_file_reads_as_expired(tmp_path):
    c = Clock()
    a, b = mk(tmp_path, "a", c), mk(tmp_path, "b", c)
    assert a.acquire("k")
    a.path("k").write_text("{half a record")
    assert b.acquire("k")
    assert b.stats.steals == 1


def test_heartbeat_renews_expiry(tmp_path):
    c = Clock()
    a = mk(tmp_path, "a", c)
    a.acquire("k")
    first = json.loads(a.path("k").read_text())["expires"]
    c.t += 7.0
    assert a.heartbeat() == 1
    assert a.stats.heartbeats == 1
    assert json.loads(a.path("k").read_text())["expires"] == first + 7.0


def test_heartbeat_keeps_lease_alive_against_peers(tmp_path):
    c = Clock()
    a, b = mk(tmp_path, "a", c), mk(tmp_path, "b", c)
    a.acquire("k")
    for _ in range(5):
        c.t += 8.0                              # each step < ttl since beat
        a.heartbeat()
        assert not b.acquire("k")
    assert b.stats.contended == 5


def test_chaos_skip_suppresses_heartbeat_then_peer_steals(tmp_path):
    c = Clock()
    plan = chaos.ChaosPlan(3, "t", (chaos.ChaosRule(
        "lease.heartbeat", "skip", rate=1.0, first_attempt_only=False),))
    a = mk(tmp_path, "a", c, plan=plan)
    b = mk(tmp_path, "b", c)
    a.acquire("k")
    c.t += 8.0
    assert a.heartbeat() == 0                   # suppressed
    assert a.stats.skipped_heartbeats == 1
    c.t += 3.0                                  # now past the original ttl
    assert b.acquire("k")
    assert b.stats.steals == 1


def test_stolen_lease_detected_as_lost_on_next_beat(tmp_path):
    c = Clock()
    a, b = mk(tmp_path, "a", c), mk(tmp_path, "b", c)
    a.acquire("k")
    c.t += 11.0
    assert b.acquire("k")                       # a expired; b owns it now
    a.heartbeat()
    assert a.stats.lost == 1
    assert "k" not in a.held
    assert json.loads(a.path("k").read_text())["owner"] == "b"


def test_release_only_removes_own_lease(tmp_path):
    c = Clock()
    a, b = mk(tmp_path, "a", c), mk(tmp_path, "b", c)
    a.acquire("k")
    a.release("k")
    assert a.stats.released == 1
    assert not a.path("k").exists()
    a.release("k")                              # double release: no-op
    assert a.stats.released == 1
    # a release after losing the lease must not delete the thief's file
    a.acquire("k2")
    c.t += 11.0
    b.acquire("k2")
    a.release("k2")
    assert a.path("k2").exists()
    assert json.loads(a.path("k2").read_text())["owner"] == "b"


def test_release_all_and_stop(tmp_path):
    c = Clock()
    a = mk(tmp_path, "a", c)
    for k in ("k1", "k2", "k3"):
        a.acquire(k)
    a.stop()                                    # no thread started: releases
    assert a.held == {} and a.stats.released == 3
    assert not any(tmp_path.joinpath("leases").glob("*.lease"))


def test_retune_tracks_deadline_with_floor(tmp_path):
    a = mk(tmp_path, "a", Clock(), ttl=10.0)
    a.retune(45.0)
    assert a.ttl == 45.0
    a.retune(2.0)
    assert a.ttl == 10.0                        # never below the floor
    a.retune(None)
    assert a.ttl == 10.0


def test_concurrent_steal_has_exactly_one_winner(tmp_path):
    """Many managers race for one expired lease; the rename dance admits
    exactly one winner and everyone else counts contention."""
    c = Clock()
    holder = mk(tmp_path, "dead", c)
    holder.acquire("k")
    c.t += 11.0
    racers = [mk(tmp_path, f"w{i}", c) for i in range(8)]
    wins = [m for m in racers if m.acquire("k")]
    assert len(wins) == 1
    assert sum(m.stats.steals for m in racers) == 1
    owner = json.loads(wins[0].path("k").read_text())["owner"]
    assert owner == wins[0].owner


def test_background_heartbeat_thread_runs_and_stops(tmp_path):
    a = leases.LeaseManager(tmp_path, owner="a", ttl=0.3)
    a.acquire("k")
    a.start_heartbeat(interval=0.02)
    import time
    deadline = time.time() + 2.0
    while a.stats.heartbeats == 0 and time.time() < deadline:
        time.sleep(0.01)
    a.stop()
    assert a.stats.heartbeats >= 1
    assert a._thread is None and not a.path("k").exists()


def _drive(mod, root):
    """One claim / contend / beat / steal / release sequence on a package's
    managers under a fake clock; returns every lease file's bytes and the
    stats."""
    c = Clock()
    a = mod.LeaseManager(root, owner="a", ttl=10.0, clock=c)
    b = mod.LeaseManager(root, owner="b", ttl=10.0, clock=c)
    files = []
    assert a.acquire("k1") and a.acquire("k2") and not b.acquire("k1")
    files.append(a.path("k1").read_bytes())
    c.t += 7.0
    a.heartbeat()
    files.append(a.path("k1").read_bytes())
    c.t += 11.0
    assert b.acquire("k2")                      # a expired: stolen
    files.append(b.path("k2").read_bytes())
    a.heartbeat()                               # a finds k2 lost
    a.release("k1")
    b.retune(45.0)
    assert b.acquire("k3")
    files.append(b.path("k3").read_bytes())
    b.stop()
    return files, a.stats.to_dict(), b.stats.to_dict(), sorted(
        p.name for p in (Path(root) / "leases").iterdir())


def test_lease_files_and_stats_are_the_references(tmp_path):
    got = _drive(leases, tmp_path / "port")
    assert got == _drive(ref_leases, tmp_path / "ref")
    assert leases.DEFAULT_TTL == ref_leases.DEFAULT_TTL
    assert leases.HEARTBEAT_FRACTION == ref_leases.HEARTBEAT_FRACTION


def test_sweep_elastic_twin_drains_after_a_worker_dies():
    """The example: worker A dies after three durable points, worker B
    steals its leases and drains the grid, the merged store equals a
    single-process sweep, and the §3.4 loop is then profiled once and
    served from the shared store."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "sweep_elastic_torch.py"),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "worker A: rc=137 computed=3" in proc.stdout
    assert ("merged two-worker result bit-identical to single-process "
            "sweep: True") in proc.stdout
    assert "second pass served from the store: True" in proc.stdout
