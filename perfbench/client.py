"""The benchmark's client: one process, one thread, driving the engine.

Before every ``engine.step()`` the client submits each request that is
due, and it stamps every token on the host clock as the engine hands it
over (``stream_cb``).  An open loop's request is due at its scheduled
arrival and its latency counts from then; a closed loop's client sends
its next request as soon as its previous one has finished.

A run has phases: ``ramp`` (requests sent to reach a steady state, part
of set-up), ``window`` (the measured seconds), ``trace`` (a few more
steps under the profiler, in a traced run) and ``drain`` (an open loop
waits, arrivals going on, until every request due in the window has its
first token; a closed loop's clients send nothing more and wait until
the requests they have sent are done, so that the check can judge them).
Each step is recorded with its phase, its wall time, its kind and the
lengths it worked on, which the per-layer readers and the roofline
counts take.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Optional

from . import loadgen, program

TRACE_SECONDS_MAX = 30.0     # an idle open loop ends its traced steps here


@dataclasses.dataclass
class Sent:
    """One request as the client saw it."""
    spec: loadgen.RequestSpec
    due: float
    client: int
    max_new_tokens: int
    submitted: float = 0.0
    req: object = None                 # the program's Request
    refused: bool = False
    token_times: list = dataclasses.field(default_factory=list)
    slot: int = -1                     # the batch slot of its last token


@dataclasses.dataclass
class Step:
    phase: str
    kind: str                          # "decode" | "prefill"
    t0: float
    t1: float
    rows: list                         # decode: attended lengths, one a slot
    start: int = 0                     # prefill: the chunk's first position
    n_valid: int = 0                   # prefill: its valid tokens
    occupancy: float = 0.0


@dataclasses.dataclass
class Record:
    sent: list
    steps: list
    t0: float = 0.0                    # the window
    t1: float = 0.0
    slots: int = 0


def warm_up(engine, traffic: dict, vocab_size: int) -> None:
    """Set-up before the ramp: a greedy and a sampled request whose
    prompts take two prefill chunks and a few decode steps, so that every
    kernel is built and every step shape has run before any request of
    the run is due."""
    eng = traffic["engine"]
    n = min(eng["prefill_chunk"] + 1, eng["max_len"] - 4)
    prompt = [i % vocab_size for i in range(1, n + 1)]
    for temperature in (0.0, 0.8):
        engine.submit(prompt, temperature=temperature, seed=1,
                      max_new_tokens=3)
    engine.run()


class Client:
    def __init__(self, engine, traffic: dict, specs: list, seed: int, *,
                 clock: Callable[[], float] = time.perf_counter,
                 annotate: Optional[Callable[[str], object]] = None):
        self.eng = engine
        self.traffic = traffic
        self.specs = specs
        self.seed = seed
        self.clock = clock
        self.annotate = annotate
        self.rec = Record([], [], slots=engine.n_slots)
        self.state, self.terminal = program.request_states()
        self.backpressure = program.backpressure()

    # -- requests ------------------------------------------------------------
    def _submit(self, spec, due: float, client: int,
                max_new_tokens: Optional[int] = None) -> Sent:
        sent = Sent(spec, due, client, max_new_tokens or spec.max_new_tokens)
        clock = self.clock

        def on_token(piece, req, sent=sent):
            sent.token_times.append(clock())
            sent.slot = req.slot

        sent.submitted = clock()
        try:
            sent.req = self.eng.submit(
                spec.prompt, temperature=spec.temperature, seed=spec.seed,
                max_new_tokens=sent.max_new_tokens, stream_cb=on_token,
                arrival=due)
        except self.backpressure:
            sent.refused = True
        self.rec.sent.append(sent)
        return sent

    def _done(self, sent: Sent) -> bool:
        return sent.refused or sent.req.state in self.terminal

    # -- steps ---------------------------------------------------------------
    def _step(self, phase: str) -> bool:
        eng = self.eng
        before = [(r, r.cache_len, r.state)
                  for r in itertools.chain(eng.sched.live(), eng.sched.queue)]
        d0, p0 = eng.metrics.decode_steps, eng.metrics.prefill_chunks
        ctx = (self.annotate(f"perfbench.step.{len(self.rec.steps)}")
               if self.annotate else None)
        t0 = self.clock()
        if ctx is not None:
            with ctx:
                did = eng.step()
        else:
            did = eng.step()
        t1 = self.clock()
        if not did:
            return False
        occ = eng.metrics.occupancy_samples[-1]
        if eng.metrics.decode_steps > d0:
            rows = [c + 1 for r, c, st in before
                    if st is self.state.DECODE]
            self.rec.steps.append(Step(phase, "decode", t0, t1, rows,
                                       occupancy=occ))
        elif eng.metrics.prefill_chunks > p0:
            moved = [(c, r.cache_len - c) for r, c, st in before
                     if r.cache_len > c]
            start, n = moved[0] if moved else (0, 0)
            self.rec.steps.append(Step(phase, "prefill", t0, t1, [],
                                       start=start, n_valid=n,
                                       occupancy=occ))
        return True

    # -- the loops -----------------------------------------------------------
    def run(self, seconds: float, trace_steps: int = 0,
            on_phase: Optional[Callable[[str], None]] = None) -> Record:
        if self.traffic["loop"] == "open":
            return self._open(seconds, trace_steps, on_phase)
        return self._closed(seconds, trace_steps, on_phase)

    def _closed(self, seconds, trace_steps, on_phase) -> Record:
        n_clients = self.traffic["clients"]
        fractions = loadgen.first_fractions(n_clients, self.seed)
        queues = [itertools.cycle(self.specs[c::n_clients])
                  for c in range(n_clients)]
        now = self.clock()
        current = []
        for c in range(n_clients):
            spec = next(queues[c])
            keep = max(1, round(spec.max_new_tokens * fractions[c]))
            current.append(self._submit(spec, now, c, keep))
        started = [False] * n_clients
        phase, traced = "ramp", 0
        while True:
            now = self.clock()
            if phase == "ramp":
                for c, s in enumerate(current):
                    started[c] = started[c] or bool(s.token_times)
                if all(started):
                    phase, self.rec.t0 = "window", now
                    on_phase and on_phase(phase)
            if phase == "window" and now >= self.rec.t0 + seconds:
                self.rec.t1 = self.rec.t0 + seconds
                phase = "trace" if trace_steps else "drain"
                on_phase and on_phase(phase)
            if phase == "trace" and traced >= trace_steps:
                phase = "drain"
                on_phase and on_phase(phase)
            if phase == "drain":
                if all(self._done(s) for s in current):
                    break
            else:
                for c, s in enumerate(current):
                    if self._done(s):
                        current[c] = self._submit(next(queues[c]), now, c)
            if self._step(phase):
                traced += phase == "trace"
            elif phase == "drain":
                break
        on_phase and on_phase("end")
        return self.rec

    def _open(self, seconds, trace_steps, on_phase) -> Record:
        origin = self.clock()
        ramp = self.traffic["ramp_seconds"]
        self.rec.t0 = t0 = origin + ramp
        self.rec.t1 = t1 = t0 + seconds
        drain_until = t1 + self.traffic["drain_seconds"]
        pending = iter(self.specs)
        nxt = next(pending, None)
        phase, traced = "ramp", 0
        while True:
            now = self.clock()
            if phase == "ramp" and now >= t0:
                phase = "window"
                on_phase and on_phase(phase)
            if phase == "window" and now >= t1:
                phase = "trace" if trace_steps else "drain"
                on_phase and on_phase(phase)
            if phase == "trace" and (traced >= trace_steps
                                     or now >= t1 + TRACE_SECONDS_MAX):
                phase = "drain"
                on_phase and on_phase(phase)
            if phase == "drain" and (now >= drain_until or all(
                    s.token_times or self._done(s) for s in self.rec.sent
                    if t0 <= s.due < t1)):
                break
            while nxt is not None and origin + nxt.arrival <= now:
                self._submit(nxt, origin + nxt.arrival, -1)
                nxt = next(pending, None)
            if self._step(phase):
                traced += phase == "trace"
            elif nxt is not None:
                wait = origin + nxt.arrival - self.clock()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
            elif phase == "drain":
                break
        on_phase and on_phase("end")
        return self.rec
