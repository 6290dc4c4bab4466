"""Fault tolerance for serving: the straggler watchdog and the injected-fault
exception.

Copied from the JAX package's ``runtime/fault_tolerance.py``, keeping what
the serving engine uses; the checkpoint-restart ``TrainDriver`` waits for
the training slice of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Callable


class SimulatedFailure(Exception):
    """Injected fault (tests / chaos drills)."""


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps (or per-host heartbeats) that exceed a robust threshold.

    At fleet scale the same logic runs on per-host step heartbeats; the
    mitigation hook is pluggable (re-shard data away from the slow host,
    trigger preemptive checkpoint, or evict)."""

    window: int = 32
    threshold: float = 3.0       # multiple of the median step time
    min_samples: int = 8
    on_straggler: Callable[[int, float, float], None] | None = None
    _times: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=128))

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        history = list(self._times)[-self.window:]
        self._times.append(seconds)
        if len(history) < self.min_samples:
            return False
        med = statistics.median(history)
        if seconds > self.threshold * med:
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
            return True
        return False

    def deadline(self, floor: float = 0.0) -> float | None:
        """Prospective hang threshold: the robust-median straggler bound
        applied *before* a step/task completes (the supervisor kills work
        past it).  None until ``min_samples`` durations are recorded —
        no basis for a deadline yet."""
        history = list(self._times)[-self.window:]
        if len(history) < self.min_samples:
            return None
        return max(floor, self.threshold * statistics.median(history))
