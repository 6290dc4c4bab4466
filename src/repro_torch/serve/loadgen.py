"""Synthetic serving traffic: Poisson arrivals over mixed request shapes.

``poisson_workload`` builds a deterministic (seeded) request schedule —
exponential inter-arrival gaps, log-spread prompt/output lengths, a
greedy/temperature mix.  ``drive`` replays it against a
:class:`~repro_torch.serve.engine.ServeEngine` on a virtual clock: requests are
submitted when the engine's own step loop reaches their arrival time, so
runs are reproducible and need no wall-clock sleeping.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .engine import Backpressure, ServeEngine


@dataclasses.dataclass
class RequestSpec:
    arrival: float
    prompt: list
    temperature: float
    seed: int
    max_new_tokens: int


def poisson_workload(n_requests: int, *, rate_rps: float = 8.0,
                     seed: int = 0, vocab_size: int = 256,
                     prompt_len: tuple = (4, 48),
                     out_len: tuple = (4, 32),
                     temperature_mix: float = 0.5) -> list:
    """Deterministic Poisson request schedule.

    ``prompt_len`` / ``out_len`` are inclusive (lo, hi) ranges sampled
    log-uniformly (serving traffic is length-skewed: many short, few
    long); ``temperature_mix`` is the fraction of sampled (T=0.8) vs
    greedy requests."""
    rng = np.random.default_rng(seed)
    t = 0.0
    specs = []

    def log_uniform(lo, hi):
        return int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))

    for i in range(n_requests):
        t += rng.exponential(1.0 / rate_rps)
        plen = log_uniform(*prompt_len)
        specs.append(RequestSpec(
            arrival=t,
            prompt=rng.integers(0, vocab_size, size=plen).tolist(),
            temperature=0.8 if rng.uniform() < temperature_mix else 0.0,
            seed=int(rng.integers(0, 2**31)),
            max_new_tokens=log_uniform(*out_len),
        ))
    return specs


def drive(engine: ServeEngine, specs, *, seconds_per_step: float = 1e-3,
          max_steps: int = 200_000) -> dict:
    """Replay a workload schedule through the engine on a virtual clock.

    Each engine step advances virtual time by ``seconds_per_step``;
    requests whose arrival time has passed are submitted before the step
    (backpressured submissions retry on later steps).  Returns a summary:
    the request list plus counts of backpressure events.
    """
    specs = sorted(specs, key=lambda s: s.arrival)
    clock = {"t": 0.0}
    engine.clock = lambda: clock["t"]
    pending = list(specs)
    requests, backpressured = [], 0
    steps = 0
    while (pending or engine.sched.has_work()) and steps < max_steps:
        while pending and pending[0].arrival <= clock["t"]:
            spec = pending[0]
            try:
                requests.append(engine.submit(
                    spec.prompt, temperature=spec.temperature,
                    seed=spec.seed, max_new_tokens=spec.max_new_tokens,
                    arrival=spec.arrival))
                pending.pop(0)
            except Backpressure:
                backpressured += 1
                break                      # retry after the engine drains
        did = engine.step()
        clock["t"] += seconds_per_step
        if not did and pending:
            # idle gap before the next arrival: jump the virtual clock
            clock["t"] = max(clock["t"], pending[0].arrival)
        steps += 1
    return {"requests": requests, "backpressured": backpressured,
            "steps": steps}
