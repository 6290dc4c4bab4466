"""Per-request and engine-level serving metrics.

Request metrics follow the standard serving vocabulary: queue wait (submit
→ first prefill chunk), TTFT (submit → first token sampled), ITL (gap
between consecutive sampled tokens).  Engine metrics count what the
scheduler actually did: step mix, batch occupancy, pool utilization,
preemptions, straggler flags.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[i])


def summarize_ms(xs) -> dict:
    return {"p50": percentile(xs, 50) * 1e3, "p99": percentile(xs, 99) * 1e3}


@dataclasses.dataclass
class RequestMetrics:
    submit_time: float = 0.0
    admit_time: Optional[float] = None      # first prefill chunk ran
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)

    def on_admit(self, now: float) -> None:
        if self.admit_time is None:
            self.admit_time = now

    def on_token(self, now: float) -> None:
        if self.first_token_time is None:
            self.first_token_time = now
        self.token_times.append(now)

    @property
    def queue_wait(self) -> Optional[float]:
        return (None if self.admit_time is None
                else self.admit_time - self.submit_time)

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token_time is None
                else self.first_token_time - self.submit_time)

    @property
    def itls(self) -> list:
        t = self.token_times
        return [b - a for a, b in zip(t, t[1:])]

    @property
    def tokens_per_sec(self) -> float:
        if self.finish_time is None or not self.token_times:
            return 0.0
        dt = self.finish_time - self.submit_time
        return len(self.token_times) / dt if dt > 0 else 0.0


@dataclasses.dataclass
class EngineMetrics:
    steps: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0
    tokens_sampled: int = 0
    preemptions: int = 0
    timeouts: int = 0
    stragglers: int = 0
    peak_in_flight: int = 0
    occupancy_samples: list = dataclasses.field(default_factory=list)
    pool_util_samples: list = dataclasses.field(default_factory=list)

    def on_step(self, kind: str, occupancy: float, pool_util: float) -> None:
        self.steps += 1
        if kind == "decode":
            self.decode_steps += 1
        elif kind == "prefill":
            self.prefill_chunks += 1
        self.occupancy_samples.append(occupancy)
        self.pool_util_samples.append(pool_util)

    @property
    def occupancy_mean(self) -> float:
        xs = self.occupancy_samples
        return sum(xs) / len(xs) if xs else 0.0

    @property
    def pool_util_mean(self) -> float:
        xs = self.pool_util_samples
        return sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "tokens_sampled": self.tokens_sampled,
            "preemptions": self.preemptions,
            "timeouts": self.timeouts,
            "stragglers": self.stragglers,
            "peak_in_flight": self.peak_in_flight,
            "occupancy_mean": round(self.occupancy_mean, 4),
            "pool_util_mean": round(self.pool_util_mean, 4),
        }
