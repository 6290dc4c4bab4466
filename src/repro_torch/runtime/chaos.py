"""Unified, deterministic chaos-injection layer.

The port's copy of the JAX package's ``runtime/chaos.py``: the plan, rule
and fault types and the ``REPRO_CHAOS`` parser, which the serving engine
uses for injected backpressure and straggler steps.  The plan format and
the fire decision are the same as the reference's, so one
``REPRO_CHAOS=<seed>:<profile>`` drives both packages alike.  The sweep-side
helpers (applying task and storage faults) stay with the sweep, which the
port does not need.

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
pass them to ``ServeEngine(chaos=...)``.

Sites wired in the port (prefix-matched); the profiles keep the
reference's sweep-side rules so that one ``REPRO_CHAOS`` value parses in
both packages, but only these sites ever fire here:

======================  ====================================================
``serve.backpressure``  request admission, keyed by request id
``serve.step``          one engine step, keyed by step ordinal
======================  ====================================================
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

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
