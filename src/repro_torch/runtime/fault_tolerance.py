"""Fault tolerance: the checkpoint-restart training driver, the straggler
watchdog and the injected-fault exception.

Copied from the JAX package's ``runtime/fault_tolerance.py``.  The job
restarts from the latest durable checkpoint after a crash and replays the
same data order (the data pipeline keys its RNG by step), so the metrics
history after a resume equals the uninterrupted run's.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Any, Callable

from repro_torch.checkpoint.checkpointer import Checkpointer


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


@dataclasses.dataclass
class TrainDriver:
    """Checkpoint-restart training loop.

    ``step_fn(state, batch) -> (state, metrics)`` is the train step;
    ``batch_fn(step) -> batch`` must be deterministic in ``step`` so recovery
    replays the same data order.
    """

    step_fn: Callable
    batch_fn: Callable[[int], Any]
    checkpointer: Checkpointer
    checkpoint_every: int = 10
    watchdog: StragglerWatchdog | None = None

    def run(self, state: Any, n_steps: int, *, start_step: int = 0,
            fail_at: int | None = None) -> tuple[Any, list[dict]]:
        """Run steps [start_step, n_steps); raises SimulatedFailure at
        ``fail_at`` AFTER mutating state (a mid-run crash)."""
        history = []
        for step in range(start_step, n_steps):
            t0 = time.monotonic()
            batch = self.batch_fn(step)
            state, metrics = self.step_fn(state, batch)
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            if self.watchdog is not None:
                self.watchdog.record(step, dt)
            history.append({"step": step, **metrics})
            if (step + 1) % self.checkpoint_every == 0:
                self.checkpointer.save(step + 1, state)
        self.checkpointer.wait()
        return state, history

    def resume(self, target: Any, n_steps: int):
        """Restart from the latest durable checkpoint, restored into
        ``target`` (a state of the same structure)."""
        step = self.checkpointer.latest_step()
        if step is None:
            raise RuntimeError("no checkpoint to resume from")
        state = self.checkpointer.restore(step, target)
        return self.run(state, n_steps, start_step=step)
