"""A copy of ``repro.runtime.supervisor``, kept line for line but for two
repairs (``tests/test_torch_supervisor.py``):

* a run that degrades to inline execution after a pool break or a
  deadline kill still hands each result to ``on_result``, so the sweep
  goes on making points durable as they finish.  The reference passes
  nothing there, and the points it computes after the degradation never
  reach its store;
* a worker that dies between two waits breaks the pool under the next
  ``submit``, which then raises ``BrokenProcessPool``; the task goes back
  to the queue and the break is handled as one seen in a future.  The
  reference lets that exception out of :meth:`TaskSupervisor.run`, which
  fails a chaos sweep whose crashes come fast enough.

Supervised task execution over a (rebuildable) worker pool.

The sweep engine's original execution model — ``pool.map`` over a bare
fork :class:`~concurrent.futures.ProcessPoolExecutor` — dies whole on the
first worker segfault, OOM-kill, or hang.  :class:`TaskSupervisor` wraps
the same pool with the failure handling a long evaluation campaign
statistically requires:

* **per-task deadlines** — a fixed ``deadline`` (``REPRO_SWEEP_DEADLINE``
  in the sweep) or, by default, an adaptive one derived from the robust
  median of completed task times via
  :meth:`~repro_torch.runtime.fault_tolerance.StragglerWatchdog.deadline`;
  a task past its deadline has its pool killed and is retried;
* **bounded retry** with exponential backoff and *deterministic* jitter
  (a pure hash of the task key and attempt — reruns behave identically);
* **automatic pool rebuild** on ``BrokenProcessPool`` (a crashed worker
  takes down every in-flight future; the supervisor charges each
  in-flight task one attempt, rebuilds, and resubmits);
* **graceful degradation** — a task that exhausts its attempts is
  replaced by its ``fallback`` tasks (the sweep degrades a lane batch to
  per-point scalar golden-engine tasks) before anything is given up on;
* **quarantine** — a task that fails even its fallback is recorded in the
  report's ``failures`` and the run *completes* with partial results
  instead of crashing.

Task functions are called as ``fn(payload, attempt)`` — the attempt index
makes transient chaos injection (:mod:`repro_torch.runtime.chaos`) and
first-try-only failures expressible inside the task body.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import FIRST_COMPLETED, wait
from concurrent.futures.process import BrokenProcessPool
from typing import Any, Callable

from repro_torch.runtime.chaos import _unit
from repro_torch.runtime.fault_tolerance import StragglerWatchdog


@dataclasses.dataclass
class Task:
    """One supervised unit of work."""

    key: str
    fn: Callable                 # fn(payload, attempt) -> result; picklable
    payload: Any
    fallback: tuple["Task", ...] | None = None   # degraded replacements
    attempts: int = 0            # charged failures so far
    not_before: float = 0.0      # backoff gate (monotonic clock)


@dataclasses.dataclass
class TaskFailure:
    """A quarantined task: retries and fallback both exhausted."""

    key: str
    error: str
    attempts: int


@dataclasses.dataclass
class SupervisorReport:
    """What happened: results, quarantined failures, fault counters."""

    results: dict[str, Any] = dataclasses.field(default_factory=dict)
    failures: list[TaskFailure] = dataclasses.field(default_factory=list)
    retries: int = 0         # re-executions scheduled after a failed attempt
    crashes: int = 0         # BrokenProcessPool events (worker death)
    hangs: int = 0           # deadline kills
    pool_rebuilds: int = 0   # pools torn down and rebuilt
    fallback_tasks: int = 0  # degraded replacement tasks spawned

    def ok(self) -> bool:
        return not self.failures

    def counters(self) -> dict:
        return {"retries": self.retries, "crashes": self.crashes,
                "hangs": self.hangs, "pool_rebuilds": self.pool_rebuilds,
                "fallback_tasks": self.fallback_tasks,
                "quarantined": len(self.failures)}


def backoff_delay(key: str, attempt: int, *, base: float = 0.05,
                  cap: float = 2.0) -> float:
    """Exponential backoff with deterministic jitter in [0.5x, 1.5x)."""
    raw = min(cap, base * 2.0 ** max(0, attempt - 1))
    return raw * (0.5 + _unit("backoff", key, attempt))


class TaskSupervisor:
    """Run tasks to completion (or quarantine) over a rebuildable pool.

    ``pool_factory`` returns the executor to use (or None to run inline);
    ``pool_rebuild`` replaces it after a break or a deadline kill —
    returning None degrades the rest of the run to inline execution.
    With no factory at all, everything runs inline (retry/fallback/
    quarantine still apply; deadlines cannot be enforced inline).
    """

    def __init__(self, *, pool_factory: Callable | None = None,
                 pool_rebuild: Callable | None = None,
                 max_attempts: int = 3, deadline: float | None = None,
                 min_deadline: float = 45.0,
                 watchdog: StragglerWatchdog | None = None,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 tick: float = 0.05):
        self._pool_factory = pool_factory
        self._pool_rebuild = pool_rebuild or pool_factory
        self.max_attempts = max(1, max_attempts)
        self.fixed_deadline = deadline
        self.min_deadline = min_deadline
        self.watchdog = watchdog if watchdog is not None else \
            StragglerWatchdog(window=32, threshold=4.0, min_samples=5)
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.tick = tick

    # -- failure bookkeeping -------------------------------------------------
    def _fail(self, task: Task, error: str, rep: SupervisorReport,
              queue: collections.deque) -> None:
        """Charge one attempt; requeue, degrade to fallback, or quarantine."""
        task.attempts += 1
        if task.attempts < self.max_attempts:
            rep.retries += 1
            task.not_before = time.monotonic() + backoff_delay(
                task.key, task.attempts, base=self.backoff_base,
                cap=self.backoff_cap)
            queue.append(task)
        elif task.fallback:
            rep.fallback_tasks += len(task.fallback)
            queue.extend(task.fallback)
        else:
            rep.failures.append(TaskFailure(task.key, error, task.attempts))

    def _deadline(self) -> float | None:
        if self.fixed_deadline is not None:
            return self.fixed_deadline
        return self.watchdog.deadline(floor=self.min_deadline)

    # -- execution -----------------------------------------------------------
    def run(self, tasks, on_result: Callable[[Task, Any], None] | None = None) \
            -> SupervisorReport:
        """Drain ``tasks``; ``on_result(task, result)`` fires in the calling
        process as each task completes — the sweep uses it to make results
        durable *incrementally* (simcache put + journal append), so a
        ``kill -9`` of the coordinator loses at most the in-flight tasks.
        A raising ``on_result`` counts as a failed attempt for that task
        (the result is discarded and the task retried: recomputing a pure
        task is always safe, a half-persisted result is not)."""
        rep = SupervisorReport()
        queue: collections.deque[Task] = collections.deque(tasks)
        pool = self._pool_factory() if self._pool_factory else None
        if pool is None:
            self._run_inline(queue, rep, on_result)
            return rep

        inflight: dict = {}          # future -> (task, start_time)
        while queue or inflight:
            now = time.monotonic()
            # submit every ready task up to the worker count; queued-but-
            # not-ready tasks (backoff) stay behind until their gate opens
            capacity = getattr(pool, "_max_workers", None) or 4
            broken_submit = False
            for _ in range(len(queue)):
                if len(inflight) >= capacity:
                    break
                task = queue.popleft()
                if task.not_before > now:
                    queue.append(task)
                    continue
                try:
                    fut = pool.submit(task.fn, task.payload, task.attempts)
                except BrokenProcessPool:
                    # a worker died since the last wait: this task never
                    # ran (uncharged); the in-flight futures surface the
                    # break below
                    queue.appendleft(task)
                    broken_submit = True
                    break
                inflight[fut] = (task, now)
            if not inflight:
                if broken_submit:
                    rep.crashes += 1
                    pool = self._rebuild(pool, rep, kill=False)
                    if pool is None:
                        self._run_inline(queue, rep, on_result)
                        return rep
                    continue
                time.sleep(self.tick)
                continue

            done, _ = wait(list(inflight), timeout=self.tick,
                           return_when=FIRST_COMPLETED)
            broke = False
            for fut in done:
                task, start = inflight.pop(fut)
                err = fut.exception()
                if err is None:
                    out = fut.result()
                    try:
                        if on_result is not None:
                            on_result(task, out)
                    except Exception as e:
                        self._fail(task, f"persist failed: "
                                   f"{type(e).__name__}: {e}", rep, queue)
                    else:
                        rep.results[task.key] = out
                        self.watchdog.record(len(rep.results),
                                             time.monotonic() - start)
                elif isinstance(err, BrokenProcessPool):
                    broke = True
                    self._fail(task, f"worker crashed: {err}", rep, queue)
                else:
                    self._fail(task, f"{type(err).__name__}: {err}", rep,
                               queue)
            if broke:
                # one crash takes down every sibling future; charge each
                # in-flight task one attempt (can't tell whose worker died)
                rep.crashes += 1
                for fut, (task, _) in list(inflight.items()):
                    self._fail(task, "worker pool broke mid-task", rep, queue)
                inflight.clear()
                pool = self._rebuild(pool, rep, kill=False)
                if pool is None:
                    self._run_inline(queue, rep, on_result)
                    return rep
                continue

            # hang detection: any in-flight task past the deadline gets its
            # pool killed (a stuck worker cannot be cancelled politely);
            # siblings are requeued uncharged
            deadline = self._deadline()
            if deadline is not None and inflight:
                now = time.monotonic()
                hung = [(f, t, s) for f, (t, s) in inflight.items()
                        if now - s > deadline]
                if hung:
                    rep.hangs += len(hung)
                    hung_futs = {f for f, _, _ in hung}
                    for f, task, _ in hung:
                        self._fail(task, f"hang: exceeded {deadline:.1f}s "
                                   "deadline", rep, queue)
                    for f, (task, _) in inflight.items():
                        if f not in hung_futs:
                            queue.append(task)      # collateral, uncharged
                    inflight.clear()
                    pool = self._rebuild(pool, rep, kill=True)
                    if pool is None:
                        self._run_inline(queue, rep, on_result)
                        return rep
        return rep

    def _rebuild(self, pool, rep: SupervisorReport, *, kill: bool):
        rep.pool_rebuilds += 1
        if kill:
            for p in list(getattr(pool, "_processes", {}).values()):
                try:
                    p.kill()
                except Exception:
                    pass
        try:
            pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        return self._pool_rebuild() if self._pool_rebuild else None

    def _run_inline(self, queue: collections.deque, rep: SupervisorReport,
                    on_result: Callable[[Task, Any], None] | None = None) \
            -> None:
        while queue:
            task = queue.popleft()
            delay = task.not_before - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t0 = time.monotonic()
            try:
                out = task.fn(task.payload, task.attempts)
                if on_result is not None:
                    on_result(task, out)
                rep.results[task.key] = out
                self.watchdog.record(len(rep.results),
                                     time.monotonic() - t0)
            except Exception as e:
                self._fail(task, f"{type(e).__name__}: {e}", rep, queue)
