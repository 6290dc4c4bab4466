"""Unified, deterministic chaos-injection layer.

The port's copy of the JAX package's ``runtime/chaos.py``: one seed-keyed
fault-injection API shared by every subsystem that rehearses failure: the
sweep engine (worker crashes, task hangs, torn simcache writes, dropped
indexes), the elastic sweep service (lost workers, expired leases, torn
journal entries) and the serving engine (injected backpressure and
straggler steps).  The plan format and the fire decision are the
reference's, so one ``REPRO_CHAOS=<seed>:<profile>`` drives both packages
alike.

Design rules:

* **Deterministic.**  Every fire decision is a pure function of
  ``(plan seed, rule index, site, key, attempt)`` — re-running the same
  plan over the same work reproduces the same faults, so every chaos
  drill and every test failure replays from its seed.
* **Transient by default.**  Rules fire on a task's *first* attempt
  unless ``first_attempt_only=False``, so retry machinery recovers and a
  drill can assert bit-identical final results.  Persistent rules (an
  "engine bug" that fails every attempt) exercise the degradation and
  quarantine paths instead.
* **Declarative.**  A :class:`ChaosPlan` is data — a seed plus a tuple of
  :class:`ChaosRule` — shippable to worker processes as JSON.  Consumers
  ask ``plan.fire(site, key, attempt)`` and apply the returned
  :class:`Fault`; they never roll dice themselves.

Activation for CI drills: ``REPRO_CHAOS=<seed>:<profile>`` (see
:data:`PROFILES`); library callers can also construct plans directly and
pass them to ``sweep.sweep(chaos=...)`` / ``ServeEngine(chaos=...)``.

Sites currently wired (prefix-matched, so ``sweep.task`` covers both):

======================  ====================================================
``sweep.task.batch``    a lane-batch sweep task, keyed by task key
``sweep.task.scalar``   a scalar (golden-engine) sweep task / fallback point
``simcache.put``        a just-written result record, keyed by point key
``simcache.index``      the simcache ``index.json``
``journal.append``      a just-written sweep-journal entry, keyed by point
``lease.heartbeat``     one lease renewal, keyed by point, attempt = beat
``service.point``       an elastic worker surviving one more completed
                        point (``scripts/torch_sweep_service.py``);
                        ``crash`` here is whole-worker loss mid-drain
``serve.backpressure``  request admission, keyed by request id
``serve.step``          one engine step, keyed by step ordinal
======================  ====================================================
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

from repro_torch.runtime.fault_tolerance import SimulatedFailure

#: fault kinds a rule may inject
KINDS = ("crash",         # kill the worker process (SIGKILL-like os._exit)
         "hang",          # sleep far past the task deadline
         "raise",         # raise SimulatedFailure from the task body
         "delay",         # stretch a measured duration (straggler)
         "torn_write",    # truncate a just-written record (torn write)
         "lost_write",    # drop the record, leave a stray .tmp behind
         "drop_index",    # delete the store index
         "backpressure",  # reject an admission
         "skip")          # suppress the guarded action (lease heartbeats)


@dataclasses.dataclass(frozen=True)
class ChaosRule:
    """One injection rule: where, what, how often."""

    site: str                        # site prefix this rule applies to
    kind: str                        # one of KINDS
    rate: float = 1.0                # fire probability per (key, attempt)
    first_attempt_only: bool = True  # transient (retry recovers) vs persistent
    match: str = ""                  # substring filter on the key ("" = all)
    seconds: float = 0.0             # hang/delay duration

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; see KINDS")


@dataclasses.dataclass(frozen=True)
class Fault:
    """A fired injection, returned by :meth:`ChaosPlan.fire`."""

    kind: str
    seconds: float
    site: str
    key: str
    rule: int       # index of the rule that fired (for reporting)


def _unit(*parts) -> float:
    """Deterministic uniform [0, 1) from the hashed parts."""
    blob = ":".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """A seed plus the rules; the whole unit of chaos configuration."""

    seed: int
    profile: str = "custom"
    rules: tuple[ChaosRule, ...] = ()

    def fire(self, site: str, key: str, attempt: int = 0) -> Fault | None:
        """First matching rule whose deterministic roll passes, else None."""
        for i, r in enumerate(self.rules):
            if not site.startswith(r.site):
                continue
            if r.match and r.match not in key:
                continue
            if r.first_attempt_only and attempt > 0:
                continue
            if _unit(self.seed, i, site, key, attempt) < r.rate:
                return Fault(r.kind, r.seconds, site, key, i)
        return None

    # -- wire format (plans travel to worker processes as JSON) -------------
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "profile": self.profile,
                           "rules": [dataclasses.asdict(r)
                                     for r in self.rules]})

    @classmethod
    def from_json(cls, blob: str) -> "ChaosPlan":
        d = json.loads(blob)
        return cls(d["seed"], d.get("profile", "custom"),
                   tuple(ChaosRule(**r) for r in d["rules"]))


#: named drill profiles for ``REPRO_CHAOS=<seed>:<profile>``; every rule
#: is transient (first attempt only) except where noted, so a drill
#: completes with zero quarantined points and bit-identical results
PROFILES: dict[str, tuple[ChaosRule, ...]] = {
    # half the sweep tasks lose their worker mid-task on first attempt
    "workercrash": (ChaosRule("sweep.task", "crash", rate=0.5),),
    # some tasks hang far past any deadline; the supervisor must kill them
    "taskhang": (ChaosRule("sweep.task", "hang", rate=0.15, seconds=30.0),),
    # records are torn/lost as written and the index disappears; the
    # hardened SimCache quarantines + recomputes on the next read
    "cachecorrupt": (ChaosRule("simcache.put", "torn_write", rate=0.3),
                     ChaosRule("simcache.put", "lost_write", rate=0.2),
                     ChaosRule("simcache.index", "drop_index", rate=1.0)),
    # a persistent batched/runahead-engine "bug": every lane-batch attempt
    # raises, so every point degrades to the scalar golden engine
    "enginebug": (ChaosRule("sweep.task.batch", "raise", rate=1.0,
                            first_attempt_only=False),),
    # a bit of everything at lower rates
    "mixed": (ChaosRule("sweep.task", "crash", rate=0.2),
              ChaosRule("sweep.task", "hang", rate=0.05, seconds=30.0),
              ChaosRule("simcache.put", "torn_write", rate=0.15),
              ChaosRule("simcache.index", "drop_index", rate=0.5)),
    # serving-side flakiness: rejected admissions + straggler steps
    "serveflaky": (ChaosRule("serve.backpressure", "backpressure", rate=0.2),
                   ChaosRule("serve.step", "delay", rate=0.3, seconds=0.5)),
    # elastic-service drills (scripts/sweep_service.py + chaos_drill.py):
    # whole workers are lost mid-drain — the worker hard-exits after some
    # completed points (its durable progress survives; peers reclaim its
    # leases) and a few pool tasks crash too.  The kill is keyed by point
    # digest, and fires only on *computed* points, so a relaunched worker
    # that resumes from journal + simcache never re-trips the same kill.
    "workerloss": (ChaosRule("service.point", "crash", rate=0.15,
                             first_attempt_only=False),
                   ChaosRule("sweep.task", "crash", rate=0.15)),
    # lease renewals are suppressed so in-flight leases expire and peers
    # steal them: completion must survive duplicated (reclaimed) points
    "leaseexpire": (ChaosRule("lease.heartbeat", "skip", rate=0.7,
                              first_attempt_only=False),),
    # journal entries are torn or lost as appended: replay must drop them
    # (those points recompute or re-serve from the store) and the resumed
    # count must stay honest; the index disappears too for good measure
    "tornjournal": (ChaosRule("journal.append", "torn_write", rate=0.25),
                    ChaosRule("journal.append", "lost_write", rate=0.15),
                    ChaosRule("simcache.index", "drop_index", rate=1.0)),
}


def from_spec(spec: str) -> ChaosPlan:
    """Parse ``<seed>:<profile>`` (the ``REPRO_CHAOS`` format).

    Validation happens *here*, at parse time, with an error naming the
    valid profiles — not deep inside the first plan lookup."""
    seed_s, _, profile = spec.partition(":")
    if not profile:
        profile, seed_s = seed_s, "0"
    if profile not in PROFILES:
        raise ValueError(
            f"unknown chaos profile {profile!r} in spec {spec!r}; want "
            f"'<seed>:<profile>' with profile one of {sorted(PROFILES)}")
    try:
        seed = int(seed_s)
    except ValueError:
        raise ValueError(
            f"malformed chaos seed {seed_s!r} in spec {spec!r}; want "
            f"'<seed>:<profile>' with an integer seed and profile one of "
            f"{sorted(PROFILES)}") from None
    return ChaosPlan(seed, profile, PROFILES[profile])


def from_env() -> ChaosPlan | None:
    """The active plan per ``REPRO_CHAOS``, or None when chaos is off."""
    spec = os.environ.get("REPRO_CHAOS")
    return from_spec(spec) if spec else None


# ---------------------------------------------------------------------------
# Applying faults
# ---------------------------------------------------------------------------

def apply_task_fault(fault: Fault, *, in_worker: bool) -> None:
    """Apply a crash/hang/raise fault inside a task body.

    ``in_worker`` distinguishes a forked pool worker (where a crash is a
    real ``os._exit`` — the parent sees ``BrokenProcessPool`` — and a hang
    is a real long sleep the supervisor must deadline-kill) from inline
    execution, where both degrade to :class:`SimulatedFailure` so the
    retry machinery is still exercised without killing the caller.
    """
    if fault.kind == "crash":
        if in_worker:
            os._exit(73)        # simulated segfault / OOM kill
        raise SimulatedFailure(f"injected crash at {fault.site}:{fault.key}")
    if fault.kind == "hang":
        if in_worker:
            time.sleep(fault.seconds)
            return              # if nobody killed us, carry on (too-lax deadline)
        time.sleep(min(fault.seconds, 0.05))
        raise SimulatedFailure(f"injected hang at {fault.site}:{fault.key}")
    if fault.kind == "raise":
        raise SimulatedFailure(f"injected failure at {fault.site}:{fault.key}")
    raise ValueError(f"not a task fault: {fault.kind}")


def corrupt_record(store, key: str, fault: Fault) -> None:
    """Apply a storage fault to a just-written store record (parent-side).

    ``store`` is anything with ``path(key)`` and ``root`` — the
    :class:`~repro_torch.core.cgra.sweep.SimCache` or a
    :class:`~repro_torch.core.cgra.journal.SweepJournal`.  ``torn_write``
    truncates the record file mid-way (a crash during a non-atomic write /
    bit rot); ``lost_write`` simulates dying between the temp-file write
    and the atomic rename — the record vanishes and a stray ``.tmp`` is
    left behind; ``drop_index`` deletes ``index.json``.
    """
    path = store.path(key)
    if fault.kind == "torn_write":
        text = path.read_text()
        path.write_text(text[:max(1, len(text) // 2)])
    elif fault.kind == "lost_write":
        path.with_name(path.stem + ".orphan.tmp").write_text("{\"schema\":")
        path.unlink(missing_ok=True)
    elif fault.kind == "drop_index":
        (store.root / "index.json").unlink(missing_ok=True)
    else:
        raise ValueError(f"not a storage fault: {fault.kind}")


# ---------------------------------------------------------------------------
# A chaos-aware probe task (supervisor tests + drills)
# ---------------------------------------------------------------------------

def probe_task(payload: dict, attempt: int = 0):
    """Minimal supervised-task body: applies its plan, returns its result.

    ``payload`` keys: ``key``, ``site``, ``result``, optional ``chaos``
    (a :meth:`ChaosPlan.to_json` blob) and ``ppid`` (the supervising
    process id — used to tell worker from inline execution).  Module-level
    so it pickles into pool workers.
    """
    blob = payload.get("chaos")
    if blob:
        plan = ChaosPlan.from_json(blob)
        fault = plan.fire(payload.get("site", "probe"), payload["key"],
                          attempt)
        if fault is not None:
            in_worker = os.getpid() != payload.get("ppid", os.getpid())
            apply_task_fault(fault, in_worker=in_worker)
    return payload.get("result")
