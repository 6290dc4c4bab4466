"""The port's write-ahead sweep journal (``repro_torch.core.cgra.journal``):
the twin of ``tests/test_journal.py`` — atomic entries, torn-entry replay,
resume — with entries, grid keys and checksums equal to the reference's.

Unit tests pin the entry format (checksummed, one atomic-rename file per
point) and replay semantics (torn entries dropped, counted, deleted);
integration tests drive :func:`repro_torch.core.cgra.sweep.sweep` over a
half-durable store — exactly what a ``kill -9``'d sweep leaves behind —
and assert the resumed run recomputes only the unjournaled points,
reports the resumed count, and finishes bit-identical.
"""
import json

import pytest

from repro.core.cgra import journal as ref_journal
from repro_torch.core.cgra import journal, presets
from repro_torch.core.cgra import sweep as sw

POINTS = [(("src2dest", {"n": 1024}), presets.CACHE_SPM),
          (("src2dest", {"n": 1024}), presets.RUNAHEAD),
          (("radix_hist", {"n": 1024, "n_buckets": 64}), presets.CACHE_SPM),
          (("radix_hist", {"n": 1024, "n_buckets": 64}), presets.RUNAHEAD)]


def _keys():
    return [sw.point_key(sw.normalize_spec(s), c) for s, c in POINTS]


# ---------------------------------------------------------------------------
# unit: entries, checksums, replay, retirement
# ---------------------------------------------------------------------------

def test_append_replay_round_trip(tmp_path):
    j = journal.SweepJournal(tmp_path, "g1")
    j.append("k1", {"engine": "batched"})
    j.append("k2")
    got = journal.SweepJournal(tmp_path, "g1").replay()
    assert got == {"k1": {"engine": "batched"}, "k2": {}}


def test_grids_are_isolated(tmp_path):
    journal.SweepJournal(tmp_path, "g1").append("k1")
    journal.SweepJournal(tmp_path, "g2").append("k2")
    assert list(journal.SweepJournal(tmp_path, "g1").replay()) == ["k1"]
    assert list(journal.SweepJournal(tmp_path, "g2").replay()) == ["k2"]


@pytest.mark.parametrize("damage", [
    lambda p: p.write_text(p.read_text()[: len(p.read_text()) // 2]),
    lambda p: p.write_text("{not json"),
    lambda p: p.write_text(json.dumps({"schema": 99, "key": p.stem})),
    lambda p: p.rename(p.with_name("0" * 16 + ".json")),  # key != stem
])
def test_torn_or_invalid_entries_dropped_counted_deleted(tmp_path, damage):
    j = journal.SweepJournal(tmp_path, "g")
    j.append("k_good", {"engine": "scalar"})
    j.append("k_bad")
    damage(j.path("k_bad"))
    j2 = journal.SweepJournal(tmp_path, "g")
    assert list(j2.replay()) == ["k_good"]
    assert j2.torn == 1
    # the invalid entry was deleted: a second replay is clean
    j3 = journal.SweepJournal(tmp_path, "g")
    assert list(j3.replay()) == ["k_good"] and j3.torn == 0


def test_tampered_meta_fails_checksum(tmp_path):
    j = journal.SweepJournal(tmp_path, "g")
    j.append("k", {"engine": "batched"})
    body = json.loads(j.path("k").read_text())
    body["meta"]["engine"] = "scalar"           # checksum now stale
    j.path("k").write_text(json.dumps(body, sort_keys=True))
    j2 = journal.SweepJournal(tmp_path, "g")
    assert j2.replay() == {} and j2.torn == 1


def test_complete_retires_grid_and_prune_all(tmp_path):
    j = journal.SweepJournal(tmp_path, "g1")
    j.append("k")
    assert j.exists()
    j.complete()
    assert not j.exists()
    journal.SweepJournal(tmp_path, "g2").append("k")
    journal.SweepJournal(tmp_path, "g3").append("k")
    assert journal.SweepJournal.prune_all(tmp_path) == 2
    assert journal.SweepJournal(tmp_path, "g2").replay() == {}


def test_grid_key_is_order_independent_and_content_sensitive():
    assert journal.grid_key(["a", "b"]) == journal.grid_key(["b", "a"])
    assert journal.grid_key(["a", "b"]) != journal.grid_key(["a", "c"])
    assert journal.grid_key([]) != journal.grid_key(["a"])


# ---------------------------------------------------------------------------
# integration: sweep() resumes from journal + simcache
# ---------------------------------------------------------------------------

def test_interrupted_sweep_resumes_bit_identical(tmp_path):
    """Simulate a kill -9 after two durable points: the resumed sweep
    serves them via the journal (counted ``resumed``), computes the rest,
    matches a fault-free run bit-exactly, and retires the journal."""
    baseline = sw.sweep(POINTS, store=sw.SimCache(tmp_path / "full"),
                        workers=0, chaos=None)

    # the interrupted store: first two points durable (record + journal
    # entry), the rest never ran
    store = sw.SimCache(tmp_path / "part")
    sw.sweep(POINTS[:2], store=store, workers=0, chaos=None)
    keys = _keys()
    grid = journal.grid_key(keys)
    j = journal.SweepJournal(store.root, grid)
    for k in keys[:2]:
        j.append(k, {"engine": "batched"})

    res = sw.sweep(POINTS, store=sw.SimCache(tmp_path / "part"),
                   workers=0, chaos=None)
    assert sw.LAST_ELASTIC["resumed"] == 2
    assert [r.cached for r in res] == [True, True, False, False]
    assert [r.stats.to_dict() for r in res] == \
        [r.stats.to_dict() for r in baseline]
    assert not j.exists()                       # retired on clean finish


def test_torn_journal_entry_recomputes_that_point(tmp_path):
    store = sw.SimCache(tmp_path)
    sw.sweep(POINTS, store=store, workers=0, chaos=None)
    keys = _keys()
    j = journal.SweepJournal(store.root, journal.grid_key(keys))
    for k in keys:
        j.append(k)
    torn = j.path(keys[0])
    torn.write_text(torn.read_text()[:20])      # tear one entry

    res = sw.sweep(POINTS, store=sw.SimCache(tmp_path), workers=0,
                   chaos=None)
    # the record itself is still durable, so the point serves cached —
    # but it no longer counts as resumed (its completion mark was torn)
    assert all(r.cached for r in res)
    assert sw.LAST_ELASTIC["resumed"] == len(keys) - 1
    assert sw.LAST_ELASTIC["journal_torn"] == 1


def test_clean_sweep_leaves_no_journal(tmp_path):
    store = sw.SimCache(tmp_path)
    sw.sweep(POINTS[:2], store=store, workers=0, chaos=None)
    jroot = store.root / "journal"
    assert not jroot.exists() or not any(jroot.iterdir())


def test_failed_points_keep_journal_for_next_attempt(tmp_path):
    from repro_torch.runtime import chaos
    plan = chaos.ChaosPlan(1, "doomed", (chaos.ChaosRule(
        "sweep.task", "raise", rate=1.0, first_attempt_only=False,
        match="radix_hist"),))
    store = sw.SimCache(tmp_path)
    res = sw.sweep(POINTS, store=store, workers=0, chaos=plan,
                   allow_partial=True)
    assert any(r.stats is None for r in res)
    grid = journal.grid_key(_keys())
    j = journal.SweepJournal(store.root, grid)
    assert j.exists()                   # incomplete grid: journal survives
    assert len(j.replay()) == 2         # the src2dest points made it

    # the healthy re-run resumes those two and retires the journal
    res2 = sw.sweep(POINTS, store=sw.SimCache(tmp_path), workers=0,
                    chaos=None)
    assert sw.LAST_ELASTIC["resumed"] == 2
    assert all(r.stats is not None for r in res2)
    assert not j.exists()


def test_prune_stale_drops_journals_and_leases(tmp_path):
    store = sw.SimCache(tmp_path)
    journal.SweepJournal(store.root, "gX").append("k")
    (store.root / "leases").mkdir(parents=True, exist_ok=True)
    (store.root / "leases" / "k.lease").write_text("{}")
    store.prune_stale()
    assert not (store.root / "journal" / "gX").exists()
    assert not (store.root / "leases").exists()


@pytest.mark.parametrize("keys", [[], ["a"], ["b", "a"], [f"{i:064x}"
                                                        for i in range(50)]])
def test_grid_key_is_the_references(keys):
    assert journal.grid_key(keys) == ref_journal.grid_key(keys)
    assert journal.grid_key(iter(keys)) == ref_journal.grid_key(keys)


@pytest.mark.parametrize("meta", [None, {}, {"engine": "batched"},
                                  {"engine": "scalar", "n": 3}])
def test_entries_and_checksums_are_the_references(tmp_path, meta):
    """The same append gives the same entry file, byte for byte, and each
    package replays the other's entries."""
    port = journal.SweepJournal(tmp_path / "p", "g")
    ref = ref_journal.SweepJournal(tmp_path / "r", "g")
    port.append("k", meta)
    ref.append("k", meta)
    assert port.path("k").read_bytes() == ref.path("k").read_bytes()
    body = json.loads(port.path("k").read_text())
    assert journal.entry_checksum(body) == ref_journal.entry_checksum(body)
    assert journal.SCHEMA_VERSION == ref_journal.SCHEMA_VERSION
    assert journal.SweepJournal(tmp_path / "r", "g").replay() == \
        ref_journal.SweepJournal(tmp_path / "p", "g").replay() == \
        {"k": meta or {}}


def test_atomic_write_leaves_no_temp_file(tmp_path):
    target = tmp_path / "deep" / "x.json"
    journal.atomic_write(target, "{}")
    ref_journal.atomic_write(tmp_path / "deep" / "y.json", "{}")
    assert sorted(p.name for p in target.parent.iterdir()) == \
        ["x.json", "y.json"]
    assert target.read_text() == "{}"
