"""The port's TaskSupervisor (``repro_torch.runtime.supervisor``): the
twin of ``tests/test_supervisor.py`` — retry, backoff, fallback,
quarantine, pool rebuild on worker crash, and deadline kills of hung
workers — with the reference's backoff delays and counters on the same
plans, and the port's one repair: a run degraded to inline execution
still hands every result to ``on_result``.

Pool tests use small real fork ``ProcessPoolExecutor``s with
:func:`repro_torch.runtime.chaos.probe_task` as the (picklable) task body;
the chaos plan decides deterministically which attempts crash or hang, so
the tests replay exactly.
"""
import collections
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import pytest

from repro.runtime import chaos as ref_chaos
from repro.runtime import supervisor as ref_supervisor
from repro_torch.runtime import chaos, supervisor
from repro_torch.runtime.fault_tolerance import StragglerWatchdog


def _tasks(n, plan=None, site="probe", result=lambda i: i):
    blob = plan.to_json() if plan is not None else None
    return [supervisor.Task(f"k{i}", chaos.probe_task,
                            {"key": f"k{i}", "site": site,
                             "result": result(i), "chaos": blob,
                             "ppid": os.getpid()})
            for i in range(n)]


def _mk_pool(n=2):
    return ProcessPoolExecutor(max_workers=n,
                               mp_context=multiprocessing.get_context("fork"))


# ---------------------------------------------------------------------------
# inline (no pool): retry / fallback / quarantine state machine
# ---------------------------------------------------------------------------

def test_inline_success_and_results_by_key():
    sup = supervisor.TaskSupervisor(backoff_base=0.001)
    rep = sup.run(_tasks(5))
    assert rep.ok() and rep.results == {f"k{i}": i for i in range(5)}
    assert rep.counters() == {"retries": 0, "crashes": 0, "hangs": 0,
                              "pool_rebuilds": 0, "fallback_tasks": 0,
                              "quarantined": 0}


def test_inline_transient_failure_retries_and_recovers():
    plan = chaos.ChaosPlan(0, "t", (chaos.ChaosRule("probe", "raise"),))
    sup = supervisor.TaskSupervisor(backoff_base=0.001)
    rep = sup.run(_tasks(4, plan))
    assert rep.ok() and len(rep.results) == 4
    assert rep.retries == 4                 # every first attempt failed


def test_inline_persistent_failure_quarantines_with_error():
    plan = chaos.ChaosPlan(0, "t", (chaos.ChaosRule(
        "probe", "raise", first_attempt_only=False),))
    sup = supervisor.TaskSupervisor(max_attempts=3, backoff_base=0.001)
    rep = sup.run(_tasks(2, plan))
    assert not rep.ok() and not rep.results
    assert sorted(f.key for f in rep.failures) == ["k0", "k1"]
    for f in rep.failures:
        assert f.attempts == 3 and "SimulatedFailure" in f.error
    assert rep.retries == 4                 # 2 tasks x 2 requeues each


def test_fallback_runs_before_quarantine():
    plan = chaos.ChaosPlan(0, "t", (chaos.ChaosRule(
        "batch", "raise", first_attempt_only=False),))
    tasks = _tasks(1, plan, site="batch")
    tasks[0].fallback = tuple(
        supervisor.Task(f"k0!p{j}", chaos.probe_task,
                        {"key": f"k0!p{j}", "site": "scalar",
                         "result": 10 + j, "chaos": plan.to_json()})
        for j in range(3))
    sup = supervisor.TaskSupervisor(max_attempts=2, backoff_base=0.001)
    rep = sup.run(tasks)
    assert rep.ok()                         # chaos only matches "batch"
    assert rep.results == {"k0!p0": 10, "k0!p1": 11, "k0!p2": 12}
    assert rep.fallback_tasks == 3 and "k0" not in rep.results


def test_failing_fallback_is_quarantined_not_dropped():
    plan = chaos.ChaosPlan(0, "t", (chaos.ChaosRule(
        "", "raise", first_attempt_only=False),))   # matches every site
    tasks = _tasks(1, plan, site="batch")
    tasks[0].fallback = (supervisor.Task(
        "k0!p0", chaos.probe_task,
        {"key": "k0!p0", "site": "scalar", "chaos": plan.to_json()}),)
    sup = supervisor.TaskSupervisor(max_attempts=2, backoff_base=0.001)
    rep = sup.run(tasks)
    assert [f.key for f in rep.failures] == ["k0!p0"]


def test_backoff_delay_deterministic_and_bounded():
    d1 = supervisor.backoff_delay("k", 1, base=0.1, cap=2.0)
    assert d1 == supervisor.backoff_delay("k", 1, base=0.1, cap=2.0)
    assert d1 != supervisor.backoff_delay("k", 2, base=0.1, cap=2.0)
    for attempt in range(1, 12):
        d = supervisor.backoff_delay("k", attempt, base=0.1, cap=2.0)
        assert 0.05 <= d < 3.0              # jitter in [0.5x, 1.5x) of cap


def test_inline_respects_backoff_gate():
    sup = supervisor.TaskSupervisor(backoff_base=0.05, backoff_cap=0.05)
    plan = chaos.ChaosPlan(0, "t", (chaos.ChaosRule("probe", "raise"),))
    t0 = time.monotonic()
    rep = sup.run(_tasks(1, plan))
    assert rep.ok()
    assert time.monotonic() - t0 >= 0.02    # waited out the retry delay


# ---------------------------------------------------------------------------
# real pool: crash -> BrokenProcessPool -> rebuild; hang -> deadline kill
# ---------------------------------------------------------------------------

def test_pool_crash_rebuilds_and_recovers():
    plan = chaos.ChaosPlan(1, "t", (chaos.ChaosRule("probe", "crash",
                                                    rate=0.5),))
    fired = sum(plan.fire("probe", f"k{i}") is not None for i in range(6))
    assert fired                                  # the plan does crash some
    # generous attempt budget: a pool break charges innocent in-flight
    # siblings too, so a task can burn attempts without ever failing itself
    sup = supervisor.TaskSupervisor(pool_factory=_mk_pool, max_attempts=6,
                                    backoff_base=0.001)
    rep = sup.run(_tasks(6, plan))
    assert rep.ok() and rep.results == {f"k{i}": i for i in range(6)}
    assert rep.crashes >= 1 and rep.pool_rebuilds >= 1


def test_pool_hang_killed_by_deadline_then_retried():
    plan = chaos.ChaosPlan(2, "t", (chaos.ChaosRule(
        "probe", "hang", rate=0.4, seconds=60.0),))
    hung = sum(plan.fire("probe", f"k{i}") is not None for i in range(4))
    assert hung                                   # the plan does hang some
    sup = supervisor.TaskSupervisor(pool_factory=_mk_pool, deadline=1.0,
                                    backoff_base=0.001)
    t0 = time.monotonic()
    rep = sup.run(_tasks(4, plan))
    assert rep.ok() and len(rep.results) == 4
    assert rep.hangs >= 1 and rep.pool_rebuilds >= 1
    assert time.monotonic() - t0 < 30.0           # killed, not waited out


def test_pool_rebuild_to_none_degrades_inline():
    calls = collections.Counter()

    def factory_once():
        if calls["n"]:
            return None                           # e.g. CUDA initialized since
        calls["n"] += 1
        return _mk_pool()

    plan = chaos.ChaosPlan(1, "t", (chaos.ChaosRule("probe", "crash",
                                                    rate=0.5),))
    sup = supervisor.TaskSupervisor(pool_factory=factory_once,
                                    pool_rebuild=factory_once,
                                    backoff_base=0.001)
    rep = sup.run(_tasks(6, plan))
    assert rep.ok() and len(rep.results) == 6     # finished inline


def test_adaptive_deadline_uses_watchdog_median():
    wd = StragglerWatchdog(window=8, threshold=4.0, min_samples=3)
    sup = supervisor.TaskSupervisor(watchdog=wd, min_deadline=0.5)
    assert sup._deadline() is None                # no samples yet
    for s in (0.1, 0.1, 0.1):
        wd.record(0, s)
    assert sup._deadline() == 0.5                 # floor dominates 4x median
    for s in (1.0,) * 8:
        wd.record(0, s)
    assert sup._deadline() == pytest.approx(4.0)  # 4x median of window
    fixed = supervisor.TaskSupervisor(deadline=2.5, watchdog=wd)
    assert fixed._deadline() == 2.5


# ---------------------------------------------------------------------------
# on_result: incremental durability hook
# ---------------------------------------------------------------------------

def test_on_result_fires_per_completion_inline():
    seen = []
    sup = supervisor.TaskSupervisor(backoff_base=0.001)
    rep = sup.run(_tasks(4), on_result=lambda t, out: seen.append((t.key, out)))
    assert rep.ok()
    assert sorted(seen) == [(f"k{i}", i) for i in range(4)]


def test_on_result_fires_per_completion_pooled():
    seen = []
    pool = _mk_pool()
    try:
        sup = supervisor.TaskSupervisor(pool_factory=lambda: pool,
                                        backoff_base=0.001)
        rep = sup.run(_tasks(5), on_result=lambda t, out: seen.append(out))
        assert rep.ok() and sorted(seen) == list(range(5))
    finally:
        pool.shutdown()


def test_raising_on_result_counts_as_failed_attempt_and_retries():
    """A persist failure discards the result and retries the task:
    recomputing a pure task is safe, a half-persisted result is not."""
    calls = collections.Counter()

    def persist(task, out):
        calls[task.key] += 1
        if calls[task.key] == 1:
            raise OSError("disk full")

    sup = supervisor.TaskSupervisor(backoff_base=0.001)
    rep = sup.run(_tasks(3), on_result=persist)
    assert rep.ok() and len(rep.results) == 3
    assert rep.retries == 3                   # one persist retry per task
    assert all(n == 2 for n in calls.values())


def test_persistently_failing_on_result_quarantines():
    def persist(task, out):
        raise OSError("read-only store")

    sup = supervisor.TaskSupervisor(max_attempts=2, backoff_base=0.001)
    rep = sup.run(_tasks(2), on_result=persist)
    assert not rep.ok() and len(rep.failures) == 2
    assert all("persist failed" in f.error or "OSError" in f.error
               for f in rep.failures)
    assert rep.results == {}                  # nothing reported as durable


def test_backoff_delay_is_the_references():
    for key in ("k", "gcn_cora|('cache',)|0", "radix_hist_4k|None|3"):
        for attempt in range(0, 12):
            for base, cap in ((0.05, 2.0), (0.1, 2.0), (0.001, 0.05)):
                assert supervisor.backoff_delay(key, attempt, base=base,
                                                cap=cap) == \
                    ref_supervisor.backoff_delay(key, attempt, base=base,
                                                 cap=cap)


def _inline_report(sup_mod, chaos_mod, rules):
    plan = chaos_mod.ChaosPlan(5, "t", rules)
    blob = plan.to_json()
    tasks = [sup_mod.Task(f"k{i}", chaos_mod.probe_task,
                          {"key": f"k{i}", "site": "batch", "result": i,
                           "chaos": blob, "ppid": os.getpid()})
             for i in range(8)]
    for i, t in enumerate(tasks):
        t.fallback = tuple(sup_mod.Task(
            f"k{i}!p{j}", chaos_mod.probe_task,
            {"key": f"k{i}!p{j}", "site": "scalar", "result": 10 * i + j,
             "chaos": blob}) for j in range(2))
    rep = sup_mod.TaskSupervisor(max_attempts=2, backoff_base=0.0001,
                                 backoff_cap=0.0001).run(tasks)
    return (rep.counters(), rep.results,
            sorted((f.key, f.error, f.attempts) for f in rep.failures))


@pytest.mark.parametrize("rules", [
    (chaos.ChaosRule("batch", "raise", rate=0.5),),
    (chaos.ChaosRule("batch", "raise", first_attempt_only=False),),
    (chaos.ChaosRule("", "raise", rate=0.6, first_attempt_only=False),),
], ids=["transient", "fallback", "quarantine"])
def test_counters_results_and_failures_are_the_references(rules):
    """The same plan over the same tasks gives the reference's retries,
    fallbacks, quarantines, results and failure reports."""
    ref_rules = tuple(ref_chaos.ChaosRule(**r.__dict__) for r in rules)
    assert _inline_report(supervisor, chaos, rules) == \
        _inline_report(ref_supervisor, ref_chaos, ref_rules)


def test_degraded_run_still_persists_every_result():
    """A crash breaks the pool and the rebuild declines (as the sweep's
    does once CUDA is initialized): the rest runs inline, and every result
    still reaches ``on_result``.  The reference hands nothing to it after
    the degradation, so those points would never become durable there."""
    plan = chaos.ChaosPlan(1, "t", (chaos.ChaosRule("probe", "crash",
                                                    rate=0.5),))

    def run(sup_mod):
        calls = collections.Counter()

        def factory_once():
            if calls["n"]:
                return None
            calls["n"] += 1
            return _mk_pool()

        seen = []
        rep = sup_mod.TaskSupervisor(
            pool_factory=factory_once, pool_rebuild=factory_once,
            backoff_base=0.001).run(
                _tasks(6, plan), on_result=lambda t, out: seen.append(t.key))
        return rep, sorted(seen)

    rep, seen = run(supervisor)
    assert rep.ok() and rep.pool_rebuilds >= 1 and rep.crashes >= 1
    assert seen == sorted(rep.results) == [f"k{i}" for i in range(6)]
    ref_rep, ref_seen = run(ref_supervisor)
    assert ref_rep.results == rep.results
    assert len(ref_seen) < len(seen)            # the reference's gap


class _BrokenOnSubmit:
    """A pool a worker of which died since the last wait: its next submit
    raises ``BrokenProcessPool``, with no future in flight."""

    _max_workers = 2

    def submit(self, *a, **k):
        from concurrent.futures.process import BrokenProcessPool
        raise BrokenProcessPool("a child process terminated abruptly")

    def shutdown(self, **k):
        pass


def test_pool_broken_at_submit_rebuilds_instead_of_raising():
    """The port requeues the task uncharged, counts the crash, rebuilds
    (here: declines, so inline) and finishes every task; the reference
    lets ``BrokenProcessPool`` out of ``run``."""
    from concurrent.futures.process import BrokenProcessPool

    def factory():
        return _BrokenOnSubmit()

    def decline():
        return None

    seen = []
    rep = supervisor.TaskSupervisor(
        pool_factory=factory, pool_rebuild=decline, backoff_base=0.001).run(
            _tasks(3), on_result=lambda t, out: seen.append(t.key))
    assert rep.ok() and rep.results == {"k0": 0, "k1": 1, "k2": 2}
    assert rep.counters() == {"retries": 0, "crashes": 1, "hangs": 0,
                              "pool_rebuilds": 1, "fallback_tasks": 0,
                              "quarantined": 0}
    assert sorted(seen) == ["k0", "k1", "k2"]
    with pytest.raises(BrokenProcessPool):
        ref_supervisor.TaskSupervisor(
            pool_factory=factory, pool_rebuild=decline,
            backoff_base=0.001).run(_tasks(3))
