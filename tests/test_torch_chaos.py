"""The port's chaos layer (``repro_torch.runtime.chaos``) against the
reference's: the twin of ``tests/test_chaos.py``, and the same plans firing
the same faults in both packages."""
import json
import os

import pytest

from repro.runtime import chaos as ref_chaos
from repro_torch.core.cgra import sweep as sw
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import SimulatedFailure

SITES = ("sweep.task.batch", "sweep.task.scalar", "simcache.put",
         "simcache.index", "journal.append", "lease.heartbeat",
         "service.point", "serve.backpressure", "serve.step", "probe")


def _ref_plan(plan: chaos.ChaosPlan) -> ref_chaos.ChaosPlan:
    return ref_chaos.ChaosPlan.from_json(plan.to_json())


def test_fire_is_deterministic_in_seed():
    plan = chaos.ChaosPlan(3, "t", (chaos.ChaosRule("site", "raise",
                                                    rate=0.5),))
    rolls = [plan.fire("site.x", f"k{i}") is not None for i in range(64)]
    again = [plan.fire("site.x", f"k{i}") is not None for i in range(64)]
    assert rolls == again                   # pure function of (seed, inputs)
    assert any(rolls) and not all(rolls)    # rate 0.5 actually partitions
    other = chaos.ChaosPlan(4, "t", plan.rules)
    assert rolls != [other.fire("site.x", f"k{i}") is not None
                     for i in range(64)]    # seed matters
    ref = _ref_plan(plan)
    assert rolls == [ref.fire("site.x", f"k{i}") is not None
                     for i in range(64)]    # the reference's rolls


def test_fire_site_prefix_key_match_and_attempt_gate():
    plan = chaos.ChaosPlan(0, "t", (
        chaos.ChaosRule("sweep.task", "raise", match="gcn"),))
    assert plan.fire("sweep.task.batch", "gcn_cora|x") is not None
    assert plan.fire("sweep.task.scalar", "gcn_cora|x") is not None
    assert plan.fire("serve.step", "gcn_cora|x") is None       # site miss
    assert plan.fire("sweep.task.batch", "radix|x") is None    # key miss
    # transient: first attempt only — retries recover
    assert plan.fire("sweep.task.batch", "gcn_cora|x", attempt=1) is None
    persistent = chaos.ChaosPlan(0, "t", (
        chaos.ChaosRule("sweep.task", "raise", first_attempt_only=False),))
    assert persistent.fire("sweep.task.batch", "k", attempt=5) is not None


def test_first_matching_rule_wins_and_reports_its_index():
    plan = chaos.ChaosPlan(0, "t", (
        chaos.ChaosRule("a.b", "crash"),
        chaos.ChaosRule("a", "hang", seconds=9.0)))
    assert plan.fire("a.b.c", "k").kind == "crash"
    f = plan.fire("a.z", "k")
    assert f.kind == "hang" and f.seconds == 9.0 and f.rule == 1


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown chaos kind"):
        chaos.ChaosRule("site", "explode")


def test_plan_json_round_trip():
    plan = chaos.from_spec("42:mixed")
    back = chaos.ChaosPlan.from_json(plan.to_json())
    assert back == plan
    # round-tripped plans fire identically (what workers rely on)
    keys = [f"k{i}" for i in range(32)]
    assert [plan.fire("sweep.task.batch", k) for k in keys] == \
        [back.fire("sweep.task.batch", k) for k in keys]
    # and the wire format is the reference's, byte for byte
    assert plan.to_json() == ref_chaos.from_spec("42:mixed").to_json()


def test_from_spec_and_env(monkeypatch):
    plan = chaos.from_spec("7:workercrash")
    assert plan.seed == 7 and plan.profile == "workercrash"
    assert chaos.from_spec("taskhang").seed == 0     # bare profile
    with pytest.raises(ValueError, match="unknown chaos profile"):
        chaos.from_spec("1:nosuch")
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    assert chaos.from_env() is None
    monkeypatch.setenv("REPRO_CHAOS", "5:cachecorrupt")
    assert chaos.from_env().profile == "cachecorrupt"


def test_apply_task_fault_inline_degrades_to_simulated_failure():
    for kind in ("crash", "hang", "raise"):
        fault = chaos.Fault(kind, 0.01, "s", "k", 0)
        with pytest.raises(SimulatedFailure):
            chaos.apply_task_fault(fault, in_worker=False)
    with pytest.raises(ValueError, match="not a task fault"):
        chaos.apply_task_fault(chaos.Fault("torn_write", 0, "s", "k", 0),
                               in_worker=False)


def _damaged_store(mod, store_mod, root):
    """The reference test's damage sequence on one package's store; returns
    what it observed."""
    store = store_mod.SimCache(root=root)
    rec = {"kind": "sim", "trace": {"kernel": "x"}, "cfg": {}, "stats": {},
           "trace_meta": {}}
    store.put("a" * 64, rec)
    path = store.path("a" * 64)
    mod.corrupt_record(store, "a" * 64, mod.Fault("torn_write", 0, "s",
                                                  "k", 0))
    torn = path.read_text()
    missed = path.exists() and store.get("a" * 64) is None
    store.put("b" * 64, rec)
    mod.corrupt_record(store, "b" * 64, mod.Fault("lost_write", 0, "s",
                                                  "k", 0))
    gone = not store.path("b" * 64).exists()
    orphans = sorted(p.name for p in root.glob("*/*.orphan.tmp"))
    mod.corrupt_record(store, "b" * 64, mod.Fault("drop_index", 0, "s",
                                                  "k", 0))
    return dict(missed=missed, gone=gone, orphans=orphans,
                index=(root / "index.json").exists(), torn_len=len(torn),
                quarantined=store.quarantined)


def test_corrupt_record_torn_and_lost_writes(tmp_path):
    from repro.core.cgra import sweep as ref_sw

    got = _damaged_store(chaos, sw, tmp_path / "port")
    assert got["missed"]                    # truncated -> miss
    assert got["gone"]                      # record vanished
    assert got["orphans"]                   # stray tmp left
    assert not got["index"]                 # index dropped
    # the reference's helpers do the same to the reference's store; a
    # record's length differs only by its digest's hex (the same length)
    assert got == _damaged_store(ref_chaos, ref_sw, tmp_path / "ref")


def test_probe_task_fires_and_returns(tmp_path):
    plan = chaos.ChaosPlan(0, "t", (chaos.ChaosRule("probe", "raise"),))
    payload = {"key": "k", "site": "probe", "result": 42,
               "chaos": plan.to_json(), "ppid": os.getpid()}
    with pytest.raises(SimulatedFailure):
        chaos.probe_task(payload, attempt=0)
    assert chaos.probe_task(payload, attempt=1) == 42      # transient
    assert chaos.probe_task({"key": "k", "result": 1}) == 1  # no plan


def test_profiles_are_well_formed():
    for name, rules in chaos.PROFILES.items():
        plan = chaos.ChaosPlan(1, name, rules)
        blob = json.loads(plan.to_json())
        assert blob["profile"] == name and blob["rules"]


def test_from_spec_error_lists_valid_profiles():
    """Misconfiguration surfaces at parse time, naming every valid
    profile — not deep inside the first sweep that consults the plan."""
    with pytest.raises(ValueError) as ei:
        chaos.from_spec("1:nosuch")
    for name in chaos.PROFILES:
        assert name in str(ei.value)
    with pytest.raises(ValueError, match="malformed chaos seed"):
        chaos.from_spec("notanumber:workercrash")
    with pytest.raises(ValueError, match="unknown chaos profile"):
        chaos.from_spec("")


def test_elastic_profiles_registered_and_typed():
    for name in ("workerloss", "leaseexpire", "tornjournal"):
        assert all(r.kind in chaos.KINDS for r in chaos.PROFILES[name])
    assert any(r.site == "service.point" and r.kind == "crash"
               for r in chaos.PROFILES["workerloss"])
    assert any(r.site == "lease.heartbeat" and r.kind == "skip"
               for r in chaos.PROFILES["leaseexpire"])
    assert any(r.site == "journal.append"
               for r in chaos.PROFILES["tornjournal"])


@pytest.mark.parametrize("profile", sorted(ref_chaos.PROFILES))
def test_every_profile_fires_the_references_faults(profile):
    """One ``REPRO_CHAOS`` value, one set of faults: every profile of both
    packages fires the same fault at every site, key and attempt."""
    assert chaos.PROFILES[profile] == tuple(
        chaos.ChaosRule(**r.__dict__) for r in ref_chaos.PROFILES[profile])
    plan, ref = chaos.from_spec(f"11:{profile}"), \
        ref_chaos.from_spec(f"11:{profile}")
    for site in SITES:
        for i in range(40):
            for attempt in (0, 1, 3):
                got = plan.fire(site, f"k{i}", attempt)
                want = ref.fire(site, f"k{i}", attempt)
                assert (got is None) == (want is None), (site, i, attempt)
                if got is not None:
                    assert got.__dict__ == want.__dict__


def test_kinds_and_unit_rolls_are_the_references():
    assert chaos.KINDS == ref_chaos.KINDS
    for parts in ((0,), ("backoff", "k", 1), (7, 2, "sweep.task", "x", 0)):
        assert chaos._unit(*parts) == ref_chaos._unit(*parts)


def _run_example(name: str, argv=None) -> str:
    import contextlib
    import importlib.util
    import io
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main() if argv is None else module.main(argv)
    return out.getvalue()


def test_sweep_chaos_twin_prints_the_references_scenarios(monkeypatch):
    """Under the reference's digest (so point keys, and the faults keyed by
    them, are the reference's) the twin's scenarios 1-3 print what the
    reference example prints; its fourth quarantines a torn
    reconfiguration record, profiles again to the same allocation, and is
    then served from the store."""
    from repro.core.cgra import sweep as ref_sw

    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    monkeypatch.setattr(sw, "_digest_memo", ref_sw.code_digest())
    want = _run_example("sweep_chaos")
    got = _run_example("sweep_chaos_torch", ["--device", "cpu"])
    assert got.startswith(want)
    tail = got[len(want):]
    assert "torn reconfiguration record (profile on cpu)" in tail
    assert ("quarantined=1 profiled again=True same=True; then served from "
            "the store=True") in tail
