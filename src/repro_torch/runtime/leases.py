"""A copy of ``repro.runtime.leases`` (the standard library only), kept
line for line so the port's lease files are the reference's
(``tests/test_torch_leases.py``).

Lease-based work claiming over a shared filesystem.

The elastic sweep service lets N independent ``sweep()`` processes (or
hosts sharing one simcache root) cooperatively drain a single point grid.
The coordination substrate is this module: one small **lease file per
point digest** under ``<root>/leases/``, claimed with ``O_CREAT|O_EXCL``
(atomic on POSIX and NFS v3+), refreshed by TTL heartbeats, and — when a
worker dies or stalls past its TTL — **reclaimed** by a peer ("work
stealing") through an atomic rename dance:

1. the stealer renames the expired lease file to a private name —
   ``os.replace`` succeeds for exactly one of any number of concurrent
   stealers (the rest get ``FileNotFoundError``);
2. the winner then re-creates the lease under its own ownership with a
   fresh expiry.

Everything is crash-consistent: a dead worker's leases simply expire; a
torn lease file reads as expired and is stolen.  Duplicate computation is
possible *only* across a reclaim (the original holder may still finish),
which is safe — results are content-addressed and idempotent to store —
and is what the ``steals`` counter measures, so drills can assert "zero
duplicate simulation beyond explicit lease-expiry reclaims".

The TTL is intended to track real task durations: the sweep retunes it
from :meth:`repro_torch.runtime.fault_tolerance.StragglerWatchdog.deadline`
(the same robust-median bound that kills hung tasks), via
:meth:`LeaseManager.retune`.  Heartbeats can be suppressed
deterministically by a chaos plan (site ``lease.heartbeat``, kind
``skip``) to rehearse expiry-under-load.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import socket
import threading
import time
import uuid

#: default lease lifetime; generous against heartbeat jitter but short
#: enough that a lost worker's points are reclaimed quickly
DEFAULT_TTL = 30.0

#: a heartbeat renews every TTL/HEARTBEAT_FRACTION seconds
HEARTBEAT_FRACTION = 3.0


def _atomic_write(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(f".{path.name}.{uuid.uuid4().hex[:8]}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


@dataclasses.dataclass
class LeaseStats:
    """What this manager did (reported into ``BENCH_sim.json`` faults)."""

    claimed: int = 0          # fresh leases acquired (unclaimed points)
    steals: int = 0           # expired leases reclaimed from a peer
    contended: int = 0        # acquire refused: a live peer holds the lease
    released: int = 0         # leases released after durable completion
    heartbeats: int = 0       # renewal writes performed
    skipped_heartbeats: int = 0  # renewals suppressed (chaos "skip")
    lost: int = 0             # held leases found re-owned by a peer (we
    #                           expired and were stolen mid-task)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LeaseManager:
    """Digest-keyed lease files with TTL heartbeats and atomic stealing."""

    def __init__(self, root: str | os.PathLike, *, owner: str | None = None,
                 ttl: float = DEFAULT_TTL, chaos=None,
                 clock=time.time):
        self.root = pathlib.Path(root) / "leases"
        self.owner = owner or (f"{socket.gethostname()}:{os.getpid()}:"
                               f"{uuid.uuid4().hex[:6]}")
        self.ttl = float(ttl)
        self.ttl_floor = float(ttl)
        self.chaos = chaos            # ChaosPlan or None
        self.clock = clock
        self.held: dict[str, float] = {}      # key -> our recorded expiry
        self.stats = LeaseStats()
        self._beat_ordinal = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -- paths ---------------------------------------------------------------
    def path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.lease"

    def _body(self) -> dict:
        now = self.clock()
        return {"owner": self.owner, "acquired": now,
                "expires": now + self.ttl}

    def _read(self, path: pathlib.Path) -> dict | None:
        """Lease body, or None when missing/torn (torn reads as expired)."""
        try:
            body = json.loads(path.read_text())
        except OSError:
            return None
        except ValueError:
            return {"owner": "?torn?", "expires": 0.0}
        return body if isinstance(body, dict) else {"owner": "?torn?",
                                                    "expires": 0.0}

    # -- protocol ------------------------------------------------------------
    def acquire(self, key: str) -> bool:
        """Claim ``key``: fresh if unclaimed, stolen if expired, refused if
        a live peer holds it."""
        p = self.path(key)
        self.root.mkdir(parents=True, exist_ok=True)
        if self._create_excl(key, p):
            self.stats.claimed += 1
            return True
        body = self._read(p)
        if body is None:                      # vanished: retry fresh create
            if self._create_excl(key, p):
                self.stats.claimed += 1
                return True
            body = self._read(p) or {"owner": "?", "expires": self.clock()}
        if body.get("owner") == self.owner:   # already ours (re-entrant)
            return True
        if float(body.get("expires") or 0.0) > self.clock():
            self.stats.contended += 1
            return False
        # expired: steal.  Rename-to-private wins for exactly one stealer.
        loser = self.root / f".steal.{self.owner}.{key}"
        try:
            os.replace(p, loser)
        except OSError:
            self.stats.contended += 1         # a peer stole it first
            return False
        try:
            loser.unlink()
        except OSError:
            pass
        if not self._create_excl(key, p):     # a third party slipped in
            self.stats.contended += 1
            return False
        self.stats.steals += 1
        return True

    def _create_excl(self, key: str, p: pathlib.Path) -> bool:
        try:
            fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return False
        body = self._body()
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(body, sort_keys=True))
        except OSError:
            return False
        with self._lock:
            self.held[key] = body["expires"]
        return True

    def heartbeat(self) -> int:
        """Renew every held lease (one write each); returns renewals done.

        A held lease found re-owned by a peer means we were presumed dead
        and stolen — it is dropped from ``held`` (counted ``lost``); the
        in-flight computation finishes harmlessly (idempotent store).
        Chaos plans can suppress individual renewals deterministically
        (site ``lease.heartbeat``, kind ``skip``).
        """
        self._beat_ordinal += 1
        renewed = 0
        with self._lock:
            keys = list(self.held)
        for key in keys:
            if self.chaos is not None:
                fault = self.chaos.fire("lease.heartbeat", key,
                                        self._beat_ordinal)
                if fault is not None and fault.kind == "skip":
                    self.stats.skipped_heartbeats += 1
                    continue
            p = self.path(key)
            body = self._read(p)
            if body is not None and body.get("owner") not in (self.owner,
                                                              None):
                with self._lock:
                    self.held.pop(key, None)
                self.stats.lost += 1
                continue
            fresh = self._body()
            try:
                _atomic_write(p, json.dumps(fresh, sort_keys=True))
            except OSError:
                continue
            with self._lock:
                self.held[key] = fresh["expires"]
            self.stats.heartbeats += 1
            renewed += 1
        return renewed

    def release(self, key: str) -> None:
        """Drop a completed point's lease (its result is durable now)."""
        with self._lock:
            was_held = self.held.pop(key, None) is not None
        if not was_held:
            return
        p = self.path(key)
        body = self._read(p)
        if body is not None and body.get("owner") == self.owner:
            try:
                p.unlink(missing_ok=True)
            except OSError:
                pass
        self.stats.released += 1

    def release_all(self) -> None:
        for key in list(self.held):
            self.release(key)

    def retune(self, deadline: float | None) -> None:
        """Track task durations: TTL follows the straggler-watchdog
        deadline (never below the configured floor)."""
        if deadline is not None:
            self.ttl = max(self.ttl_floor, float(deadline))

    # -- background heartbeat ------------------------------------------------
    def start_heartbeat(self, interval: float | None = None) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval or
                                      self.ttl / HEARTBEAT_FRACTION):
                try:
                    self.heartbeat()
                except Exception:
                    pass        # never let a beat failure kill the worker

        self._thread = threading.Thread(target=_loop, name="lease-heartbeat",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop heartbeating and release everything still held."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        self.release_all()
