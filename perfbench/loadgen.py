"""Traffic for the benchmark's cells, made from a traffic file and a seed.

``poisson_workload`` is a copy of the program's
``repro_torch.serve.loadgen.poisson_workload`` (seeded Poisson arrivals,
log-uniform inclusive lengths, a greedy / sampled mix), kept here so that
the yardstick does not move with the program.  ``requests`` turns one
traffic file into the requests of one run: the file's ``base_seed`` fixes
the multiset of prompt lengths, output lengths, temperatures and arrival
gaps, and the run's ``--seed`` permutes each of them and draws the prompt
tokens and the sampling seeds.
So every seed offers the same amount of work in another order.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


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
    """Deterministic Poisson request schedule (the program's law, copied).

    ``prompt_len`` / ``out_len`` are inclusive (lo, hi) ranges sampled
    log-uniformly; ``temperature_mix`` is the fraction of sampled (T=0.8)
    vs greedy requests."""
    rng = np.random.default_rng(seed)
    t = 0.0
    specs = []

    def log_uniform(lo, hi):
        return int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))

    for _ in range(n_requests):
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


def n_requests(traffic: dict, seconds: float) -> int:
    """How many requests one run may draw on: an open loop's arrivals over
    the ramp, the window and the wait after it; a closed loop's
    ``requests_per_client`` for each client."""
    if traffic["loop"] == "open":
        span = traffic["ramp_seconds"] + seconds + traffic["drain_seconds"]
        return int(math.ceil(traffic["rate_rps"] * span * 1.25)) + 16
    return traffic["clients"] * traffic["requests_per_client"]


def requests(traffic: dict, vocab_size: int, seed: int,
             seconds: float) -> list:
    """The run's requests in order of arrival (an open loop's ``arrival``
    is seconds from the start of the ramp; a closed loop's is the order).
    The multiset of lengths, temperatures and gaps comes from the traffic
    file's ``base_seed``; ``seed`` permutes each and draws the tokens."""
    n = n_requests(traffic, seconds)
    base = poisson_workload(
        n, rate_rps=traffic.get("rate_rps", 1.0), seed=traffic["base_seed"],
        vocab_size=2, prompt_len=tuple(traffic["prompt_len"]),
        out_len=tuple(traffic["out_len"]),
        temperature_mix=traffic["temperature_mix"])
    rng = np.random.default_rng(int(seed))
    plens = rng.permutation([len(s.prompt) for s in base])
    outs = rng.permutation([s.max_new_tokens for s in base])
    temps = rng.permutation([s.temperature for s in base])
    gaps = rng.permutation(np.diff([0.0] + [s.arrival for s in base]))
    arrivals = np.cumsum(gaps)
    specs = []
    for i in range(n):
        specs.append(RequestSpec(
            arrival=float(arrivals[i]),
            prompt=rng.integers(0, vocab_size, size=int(plens[i])).tolist(),
            temperature=float(temps[i]),
            seed=int(rng.integers(0, 2**31)),
            max_new_tokens=int(outs[i])))
    return specs


def first_fractions(clients: int, seed: int) -> np.ndarray:
    """A closed loop's clients start mid-stream, as they would be found in
    a steady state: client c's first request keeps the fraction
    ``(k + 0.5) / clients`` of its drawn output length, k a permutation of
    the clients drawn from the seed (the same fractions for every seed)."""
    rng = np.random.default_rng([int(seed), 1])
    return (rng.permutation(clients) + 0.5) / clients
