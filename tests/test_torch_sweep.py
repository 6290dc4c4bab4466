"""The port's sweep engine (``repro_torch.core.cgra.sweep``): the twin of
``tests/test_sweep.py`` — golden parity, store round-trips, invalidation,
supervised execution — and the port held to the reference's sweep on the
same points: Stats, trace metadata and stored records equal but for the
digest and checksum, canonical forms and keys byte-identical but for the
digest, the same faults, retries and quarantines under one chaos plan.
Then what the port must do differently: its own store root and source
digest, a fork guard that watches CUDA, and ``reconfigure_cached`` on a
device.

The GOLDEN table pins the refactored simulator (`_engine.py` + precomputed
`Trace` views) to the pre-refactor, seed-commit simulator: the values were
produced by the original single-file `simulator.py` and must stay
bit-identical.  Each entry is
``(cycles, stall_cycles, l1_hits, l1_misses, dram_accesses, prefetch_issued)``.

The lane-parallel engines (`_batch_engine.py` for demand lanes,
`_runahead_engine.py` for runahead lanes) are pinned to the scalar engine
in turn: full-`Stats` equality over the Table-3 grid (plus MSHR/DRAM/L2
timing variants and per-cache reconfig overrides, runahead included) x
paper kernels, all routed through `simulate_batch`.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.core.cgra import sweep as ref_sw
from repro.runtime import chaos as ref_chaos
from repro_torch.core.cgra import cache_grid, presets, reconfig, simulate
from repro_torch.core.cgra import sweep as sw
from repro_torch.core.cgra.cache import CacheConfig
from repro_torch.core.cgra.simulator import SimConfig, Stats, simulate_batch
from repro_torch.runtime import chaos

ROOT = pathlib.Path(__file__).resolve().parents[1]

TRACES = {
    "gcn_cora_800": ("gcn_aggregate", {"dataset": "cora", "max_edges": 800}),
    "radix_hist_4k": ("radix_hist", {"n": 4096, "n_buckets": 512}),
    "rgb_2k": ("rgb", {"n": 2048, "palette_size": 8192}),
}
CONFIGS = {
    "cache_spm": presets.CACHE_SPM,
    "runahead": presets.RUNAHEAD,
    "spm_only_4k": presets.SPM_ONLY_4K,
    "reconfig": presets.RECONFIG,
}

# seed-commit simulator outputs (see module docstring)
GOLDEN = {
    ("gcn_cora_800", "cache_spm"): (48984, 43640, 4722, 622, 537, 0),
    ("gcn_cora_800", "runahead"): (8476, 3132, 5295, 49, 537, 592),
    ("gcn_cora_800", "spm_only_4k"): (303680, 302080, 0, 0, 4576, 0),
    ("gcn_cora_800", "reconfig"): (24368, 22768, 3109, 443, 267, 0),
    ("radix_hist_4k", "cache_spm"): (31967, 21760, 7854, 272, 272, 0),
    ("radix_hist_4k", "runahead"): (17252, 7045, 8038, 88, 272, 184),
    ("radix_hist_4k", "spm_only_4k"): (294912, 286720, 0, 0, 3584, 0),
    ("radix_hist_4k", "reconfig"): (15232, 7040, 2400, 160, 80, 0),
    ("rgb_2k", "cache_spm"): (66103, 60215, 3810, 2078, 747, 0),
    ("rgb_2k", "runahead"): (15435, 9547, 5577, 311, 767, 2100),
    ("rgb_2k", "spm_only_4k"): (249856, 245760, 0, 0, 5120, 0),
    ("rgb_2k", "reconfig"): (36938, 32842, 2172, 1924, 320, 0),
}


def _observed(stats: Stats) -> tuple:
    return (stats.cycles, stats.stall_cycles, stats.l1_hits, stats.l1_misses,
            stats.dram_accesses, stats.prefetch_issued)


@pytest.mark.parametrize("trace_name", sorted(TRACES))
def test_engine_parity_with_seed_simulator(trace_name):
    tr = sw.build_trace(sw.normalize_spec(TRACES[trace_name]))
    for cfg_name, cfg in CONFIGS.items():
        got = _observed(simulate(tr, cfg))
        assert got == GOLDEN[(trace_name, cfg_name)], (trace_name, cfg_name)


# ---------------------------------------------------------------------------
# Batched == scalar (full-Stats parity over the Table-3 grid)
# ---------------------------------------------------------------------------

#: Table-3 columns + the axes the figure sweeps exercise: MSHR pressure,
#: no-L2, multi-cache with heterogeneous per-cache geometry (reconfig
#: output, including a 0-way cache), SPM-size variants, and runahead —
#: including lanes engineered to exercise every runahead-engine path:
#: reference lanes, clean speculation (timing-identical twins land in one
#: group), and divergence + repair (MSHR/DRAM/L2 variants of one L1 shape).
PARITY_GRID = {
    "base": presets.BASE,
    "cache_spm": presets.CACHE_SPM,
    "runahead": presets.RUNAHEAD,
    "runahead_mshr2": dataclasses.replace(presets.RUNAHEAD, mshr=2),
    "runahead_mshr1": dataclasses.replace(presets.RUNAHEAD, mshr=1),
    "runahead_mshr32": dataclasses.replace(presets.RUNAHEAD, mshr=32),
    "runahead_dram40": dataclasses.replace(presets.RUNAHEAD,
                                           dram_latency=40),
    "runahead_l2lat1": dataclasses.replace(presets.RUNAHEAD,
                                           l2_hit_latency=1),
    "runahead_bus4": dataclasses.replace(presets.RUNAHEAD,
                                         dram_bus_bytes_per_cycle=4),
    "runahead_no_l2": dataclasses.replace(presets.RUNAHEAD, l2=None),
    "runahead_storage": dataclasses.replace(presets.STORAGE_EXP,
                                            runahead=True),
    "spm_only_4k": presets.SPM_ONLY_4K,
    "spm_only_133k": presets.SPM_ONLY_133K,
    "reconfig": presets.RECONFIG,
    "reconfig_ra": dataclasses.replace(presets.RECONFIG, runahead=True),
    "storage_exp": presets.STORAGE_EXP,           # no L2
    "mshr1": dataclasses.replace(presets.CACHE_SPM, mshr=1),
    "spm0": dataclasses.replace(presets.CACHE_SPM, spm_bytes=0),
    "runahead_spm0": dataclasses.replace(presets.RUNAHEAD, spm_bytes=0),
    "l1_per_cache": dataclasses.replace(presets.RECONFIG, l1_per_cache=(
        CacheConfig(ways=1, line=16, way_bytes=512),
        CacheConfig(ways=0, line=32, way_bytes=512),
        CacheConfig(ways=8, line=128, way_bytes=512),
        CacheConfig(ways=3, line=64, way_bytes=512))),
    "l1_per_cache_ra": dataclasses.replace(
        presets.RECONFIG, runahead=True, l1_per_cache=(
            CacheConfig(ways=1, line=16, way_bytes=512),
            CacheConfig(ways=0, line=32, way_bytes=512),
            CacheConfig(ways=8, line=128, way_bytes=512),
            CacheConfig(ways=3, line=64, way_bytes=512))),
}

PARITY_TRACES = {
    **TRACES,
    "grad_3k": ("grad", {"n_cells": 2048, "n_faces": 3000}),
    "perm_3k": ("perm_sort", {"n": 3000, "key_range": 1024}),
    "radix_update_3k": ("radix_update", {"n": 3000, "n_buckets": 256}),
    "src2dest_2k": ("src2dest", {"n": 2048}),
    # frontier workloads (workloads.py): pointer-chasing shapes with deep
    # addr_dep chains the Table-1 kernels never produce — small enough that
    # the full grid stays tier-1-fast, wide enough to hit the l1_per_cache
    # (incl. the 0-way cache) and MSHR-starved columns above
    "bfs_small": ("bfs_frontier", {"n_nodes": 512, "n_edges": 2048,
                                   "max_edges": 2500}),
    "pagerank_small": ("pagerank_push", {"n_nodes": 384, "n_edges": 1536,
                                         "max_edges": 2000}),
    "hash_join_small": ("hash_join", {"n_build": 256, "n_probe": 512,
                                      "n_buckets": 64}),
    "mesh_rcm_small": ("mesh_gather", {"nx": 16, "ny": 16}),
    "mesh_shuf_small": ("mesh_gather", {"nx": 16, "ny": 16,
                                        "numbering": "shuffled"}),
}


@pytest.mark.parametrize("trace_name", sorted(PARITY_TRACES))
def test_batched_engine_matches_scalar(trace_name):
    tr = sw.build_trace(sw.normalize_spec(PARITY_TRACES[trace_name]))
    cfgs = list(PARITY_GRID.values())
    batched = simulate_batch(tr, cfgs)
    for cfg_name, cfg, got in zip(PARITY_GRID, cfgs, batched):
        assert got == simulate(tr, cfg), (trace_name, cfg_name)


def test_sweep_forced_scalar_matches_batched(tmp_path, monkeypatch):
    """End-to-end: the sweep's batched dispatch and the golden scalar path
    produce identical store records for the same points."""
    pts = [(TRACES["radix_hist_4k"], cfg) for cfg in PARITY_GRID.values()]
    batched = sw.sweep(pts, store=sw.SimCache(tmp_path / "b"), workers=0)
    monkeypatch.setenv("REPRO_SWEEP_ENGINE", "scalar")
    scalar = sw.sweep(pts, store=sw.SimCache(tmp_path / "s"), workers=0)
    for rb, rs in zip(batched, scalar):
        assert rb.stats == rs.stats
        assert rb.key == rs.key
        assert rs.engine == "scalar"


def test_runahead_points_group_into_lane_batch_tasks(tmp_path):
    """Runahead points group into one task per L1 shape — exactly the lanes
    the runahead engine advances in columnar lockstep — so a trace's
    independent runahead groups can run on different workers.  Executed
    points come back tagged with the runahead engine, and lockstep lanes
    carry the group diagnostics."""
    ra = presets.RUNAHEAD
    ra_mshr = dataclasses.replace(ra, mshr=2)
    assert sw._lane_key(ra) is not None
    assert sw._lane_key(ra) == sw._lane_key(ra_mshr)       # one lane batch
    assert sw._lane_key(ra) == sw._lane_key(
        dataclasses.replace(ra, dram_latency=40, l2=None))  # timing-only
    # a different L1 shape is a different lockstep group -> its own task
    assert sw._lane_key(ra) != sw._lane_key(
        dataclasses.replace(presets.RECONFIG, runahead=True))
    assert sw._lane_key(ra) != sw._lane_key(presets.CACHE_SPM)
    assert sw._lane_key(ra) != sw._lane_key(presets.SPM_ONLY_4K)
    assert sw._lane_key(ra, force_scalar=True) is None     # golden path

    res = sw.sweep([(TRACES["radix_hist_4k"], ra),
                    (TRACES["radix_hist_4k"], ra_mshr)],
                   store=sw.SimCache(tmp_path), workers=0)
    assert [r.engine for r in res] == ["runahead", "runahead"]
    assert all(not r.cached for r in res)
    assert [r.diag["mode"] for r in res] == ["lockstep", "lockstep"]
    grp = next(r.diag["group"] for r in res if "group" in r.diag)
    assert grp["lanes"] == 2 and grp["windows"] > 0
    # cached replays carry no diagnostics (nothing was simulated)
    res2 = sw.sweep([(TRACES["radix_hist_4k"], ra)],
                    store=sw.SimCache(tmp_path), workers=0)
    assert res2[0].cached and res2[0].diag is None


# ---------------------------------------------------------------------------
# Store round-trips
# ---------------------------------------------------------------------------

POINT = (TRACES["gcn_cora_800"], presets.CACHE_SPM)


def test_sweep_miss_then_hit(tmp_path):
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    assert not r1.cached
    assert _observed(r1.stats) == GOLDEN[("gcn_cora_800", "cache_spm")]
    assert store.path(r1.key).is_file()

    r2 = sw.sweep([POINT], store=store, workers=0)[0]
    assert r2.cached and r2.key == r1.key
    assert r2.stats == r1.stats
    assert r2.trace_meta == r1.trace_meta
    assert r2.trace_meta["n_iters"] == 800

    idx = json.loads((tmp_path / "index.json").read_text())
    assert r1.key in idx["entries"]
    assert idx["entries"][r1.key]["cycles"] == r1.stats.cycles


def test_sweep_preserves_input_order_and_dedups_nothing(tmp_path):
    store = sw.SimCache(tmp_path)
    pts = [(TRACES["rgb_2k"], presets.CACHE_SPM),
           (TRACES["gcn_cora_800"], presets.CACHE_SPM),
           (TRACES["rgb_2k"], presets.CACHE_SPM)]
    res = sw.sweep(pts, store=store, workers=0)
    assert [r.stats.cycles for r in res] == [
        GOLDEN[("rgb_2k", "cache_spm")][0],
        GOLDEN[("gcn_cora_800", "cache_spm")][0],
        GOLDEN[("rgb_2k", "cache_spm")][0],
    ]
    assert res[0].key == res[2].key


def test_source_digest_change_invalidates_and_prunes(tmp_path, monkeypatch):
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    assert not r1.cached

    monkeypatch.setattr(sw, "_digest_memo", "0123456789abcdef")
    store2 = sw.SimCache(tmp_path)
    r2 = sw.sweep([POINT], store=store2, workers=0)[0]
    assert not r2.cached                      # old entry unreachable
    assert r2.key != r1.key
    assert r2.stats.cycles == r1.stats.cycles

    # prune removes exactly the entry written under the old digest
    assert sw.SimCache(tmp_path).prune_stale() == 1
    assert not store.path(r1.key).exists()
    assert store.path(r2.key).is_file()


def test_prune_removes_legacy_and_corrupt_files(tmp_path):
    store = sw.SimCache(tmp_path)
    sw.sweep([POINT], store=store, workers=0)
    legacy = tmp_path / "ab" / ("ab" + "0" * 62 + ".json")
    legacy.parent.mkdir(parents=True, exist_ok=True)
    legacy.write_text(json.dumps({"name": "grad", "cycles": 1}))  # pre-engine
    corrupt = tmp_path / "cd" / ("cd" + "1" * 62 + ".json")
    corrupt.parent.mkdir(parents=True, exist_ok=True)
    corrupt.write_text("{not json")
    assert sw.SimCache(tmp_path).prune_stale() == 2
    assert not legacy.exists() and not corrupt.exists()


def test_simconfig_json_round_trip():
    cfg = SimConfig(
        spm_bytes=2048, n_caches=2,
        l1=CacheConfig(ways=2, line=32, way_bytes=256),
        l1_per_cache=(CacheConfig(ways=1, line=16, way_bytes=128),
                      CacheConfig(ways=3, line=64, way_bytes=512)),
        l2=None, mshr=4, runahead=True, spm_only=False)
    assert sw.cfg_from_json(json.loads(json.dumps(sw.cfg_to_json(cfg)))) == cfg
    assert sw.cfg_from_json(sw.cfg_to_json(presets.CACHE_SPM)) == presets.CACHE_SPM


def test_bad_trace_specs_rejected():
    with pytest.raises(KeyError):
        sw.normalize_spec("no_such_kernel")
    with pytest.raises(KeyError):
        sw.normalize_spec(("_TraceBuilder", {}))
    with pytest.raises(TypeError):
        sw.normalize_spec(42)


def test_parallel_workers_match_inline(tmp_path):
    """End-to-end parallel path, exercised in a fresh interpreter (keeps the
    forked worker pool away from any state the test process holds)."""
    spec = TRACES["radix_hist_4k"]
    script = (
        "import json, sys\n"
        "from repro_torch.core.cgra import presets\n"
        "from repro_torch.core.cgra import sweep as sw\n"
        f"store = sw.SimCache({str(tmp_path)!r})\n"
        f"pts = [({spec!r}, presets.CACHE_SPM), ({spec!r}, presets.RUNAHEAD),\n"
        f"       ({spec!r}, presets.SPM_ONLY_4K)]\n"
        "res = sw.sweep(pts, store=store, workers=2)\n"
        "print(json.dumps([r.stats.cycles for r in res]))\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", script], env=env, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    cycles = json.loads(out.stdout.strip().splitlines()[-1])
    assert cycles == [GOLDEN[("radix_hist_4k", "cache_spm")][0],
                      GOLDEN[("radix_hist_4k", "runahead")][0],
                      GOLDEN[("radix_hist_4k", "spm_only_4k")][0]]
    # and this process reads those parallel-written entries as hits
    res = sw.sweep([(spec, presets.CACHE_SPM)], store=sw.SimCache(tmp_path),
                   workers=0)
    assert res[0].cached


def test_reconfigure_cached_round_trip(tmp_path):
    store = sw.SimCache(tmp_path)
    spec = TRACES["gcn_cora_800"]
    r1 = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048, store=store,
                               device="cpu")
    r2 = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048, store=store,
                               device="cpu")
    assert r2.allocations == list(r1.allocations)
    assert r2.lines == list(r1.lines)
    assert r2.config == r1.config
    assert r2.config.l1_per_cache is not None
    # different window is a different point
    r3 = sw.reconfigure_cached(spec, presets.RECONFIG, window=1024, store=store,
                               device="cpu")
    assert r3.h_curves is not None            # computed, not served from cache


# ---------------------------------------------------------------------------
# Hardened store: checksums, quarantine, index rebuild
# ---------------------------------------------------------------------------

def test_truncated_record_quarantined_and_recomputed(tmp_path):
    """A torn write reads as a miss: the record is quarantined (not
    deleted), the point recomputes to the same stats, and the store serves
    hits again afterwards."""
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    path = store.path(r1.key)
    text = path.read_text()
    path.write_text(text[:len(text) // 2])

    store2 = sw.SimCache(tmp_path)
    r2 = sw.sweep([POINT], store=store2, workers=0)[0]
    assert not r2.cached and r2.stats == r1.stats
    assert store2.quarantined == 1
    assert len(list((tmp_path / "quarantine").iterdir())) == 1
    assert sw.sweep([POINT], store=sw.SimCache(tmp_path),
                    workers=0)[0].cached


def test_bitrot_fails_checksum_and_misses(tmp_path):
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    rec = json.loads(store.path(r1.key).read_text())
    rec["stats"]["cycles"] += 1               # flipped bit, stale checksum
    store.path(r1.key).write_text(json.dumps(rec, sort_keys=True))
    store2 = sw.SimCache(tmp_path)
    assert store2.get(r1.key) is None
    assert store2.quarantined == 1


def test_missing_required_key_is_corrupt_not_crash(tmp_path):
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    rec = json.loads(store.path(r1.key).read_text())
    del rec["stats"]
    rec["checksum"] = sw._record_checksum(rec)  # checksum valid, body isn't
    store.path(r1.key).write_text(json.dumps(rec, sort_keys=True))
    store2 = sw.SimCache(tmp_path)
    assert store2.get(r1.key) is None           # miss, not KeyError
    assert store2.quarantined == 1


def test_stale_records_miss_without_quarantine(tmp_path, monkeypatch):
    """Old-digest records are prune's business — a plain miss, never moved
    to quarantine (checked before the checksum so legacy records without a
    checksum field aren't misclassified as corrupt)."""
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    monkeypatch.setattr(sw, "_digest_memo", "f" * 16)
    store2 = sw.SimCache(tmp_path)
    assert store2.get(r1.key) is None
    assert store2.quarantined == 0
    assert store.path(r1.key).exists()


def test_index_rebuilt_from_shards(tmp_path):
    store = sw.SimCache(tmp_path)
    r1 = sw.sweep([POINT], store=store, workers=0)[0]
    (tmp_path / "index.json").unlink()
    store2 = sw.SimCache(tmp_path)
    assert store2.get(r1.key) is not None       # reads never need the index
    assert store2.rebuild_index() == 1
    idx = json.loads((tmp_path / "index.json").read_text())
    assert r1.key in idx["entries"]
    # a corrupt index file is replaced the same way
    (tmp_path / "index.json").write_text("[1, 2")
    r2 = sw.sweep([POINT], store=sw.SimCache(tmp_path), workers=0)[0]
    assert r2.cached
    idx = json.loads((tmp_path / "index.json").read_text())
    assert r1.key in idx["entries"]


def test_prune_skips_unreadable_entries(tmp_path):
    store = sw.SimCache(tmp_path)
    sw.sweep([POINT], store=store, workers=0)
    blocker = tmp_path / "ee" / ("ee" + "2" * 62 + ".json")
    blocker.mkdir(parents=True)                 # a directory, not a file
    stray = tmp_path / "ee" / "leftover.tmp"
    stray.write_text("{")
    assert sw.SimCache(tmp_path).prune_stale() == 0   # live entry survives
    assert blocker.is_dir()                     # skipped, not fatal
    assert not stray.exists()                   # .tmp droppings swept


# ---------------------------------------------------------------------------
# Supervised execution: degradation and quarantine
# ---------------------------------------------------------------------------

def test_persistent_batch_failure_degrades_to_scalar_golden(tmp_path):
    """A lane batch whose batched/runahead execution always raises falls
    back to per-point scalar golden-engine tasks and still returns correct
    Stats — an engine bug costs throughput, never correctness."""
    plan = chaos.ChaosPlan(1, "enginebug", chaos.PROFILES["enginebug"])
    pts = [(TRACES["radix_hist_4k"], presets.CACHE_SPM),
           (TRACES["radix_hist_4k"], presets.RUNAHEAD)]
    res = sw.sweep(pts, store=sw.SimCache(tmp_path), workers=0, chaos=plan)
    assert [r.engine for r in res] == ["scalar", "scalar"]
    assert _observed(res[0].stats) == GOLDEN[("radix_hist_4k", "cache_spm")]
    assert _observed(res[1].stats) == GOLDEN[("radix_hist_4k", "runahead")]
    rep = sw.LAST_REPORT
    assert rep.fallback_tasks == 2 and rep.ok()


def test_point_failing_even_scalar_is_quarantined_and_reported(tmp_path):
    plan = chaos.ChaosPlan(1, "doomed", (chaos.ChaosRule(
        "sweep.task", "raise", rate=1.0, first_attempt_only=False,
        match="radix_hist"),))
    pts = [(TRACES["radix_hist_4k"], presets.CACHE_SPM),
           (TRACES["rgb_2k"], presets.CACHE_SPM)]
    with pytest.raises(sw.SweepError, match="quarantined") as ei:
        sw.sweep(pts, store=sw.SimCache(tmp_path), workers=0, chaos=plan)
    assert [f["label"] for f in ei.value.failures] == ["radix_hist_4k"] or \
        len(ei.value.failures) == 1

    res = sw.sweep(pts, store=sw.SimCache(tmp_path), workers=0, chaos=plan,
                   allow_partial=True)
    assert res[0].engine == "failed" and res[0].stats is None
    assert "SimulatedFailure" in res[0].error
    assert _observed(res[1].stats) == GOLDEN[("rgb_2k", "cache_spm")]
    assert sw.LAST_REPORT.counters()["quarantined"] == 1


def test_transient_chaos_recovers_bit_identical(tmp_path):
    base = sw.sweep([POINT], store=sw.SimCache(tmp_path / "a"),
                    workers=0, chaos=None)[0]
    plan = chaos.ChaosPlan(9, "mixed", chaos.PROFILES["mixed"])
    store = sw.SimCache(tmp_path / "b")
    res = sw.sweep([POINT], store=store, workers=0, chaos=plan)[0]
    assert res.stats == base.stats            # full-Stats equality
    assert sw.LAST_REPORT.ok()


def test_chaos_env_spec_reaches_sweep(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CHAOS", "1:enginebug")
    res = sw.sweep([(TRACES["radix_hist_4k"], presets.CACHE_SPM)],
                   store=sw.SimCache(tmp_path), workers=0)
    assert res[0].engine == "scalar"          # degraded via env-driven plan
    assert _observed(res[0].stats) == GOLDEN[("radix_hist_4k", "cache_spm")]


# ---------------------------------------------------------------------------
# Index flush under concurrent writers (merge-on-flush)
# ---------------------------------------------------------------------------

def _rec(i=0):
    return {"kind": "sim", "trace": {"kernel": "radix_hist"}, "cfg": {},
            "stats": {"cycles": i}, "trace_meta": {}}


def test_flush_index_merges_peer_entries(tmp_path):
    """Two store instances flushing the same root must not drop each
    other's entries: the flush re-reads the on-disk index and unions it
    with the local view (the old read-modify-write race lost whichever
    writer flushed first)."""
    k1, k2 = "a" * 64, "b" * 64
    a, b = sw.SimCache(tmp_path), sw.SimCache(tmp_path)
    b._load_index()                   # b's view predates a's write
    a.put(k1, _rec(1))
    b.put(k2, _rec(2))                # flushes a view that never saw k1
    idx = json.loads((tmp_path / "index.json").read_text())
    assert set(idx["entries"]) == {k1, k2}
    # ...but entries whose shard files are gone are dropped on merge
    sw.SimCache(tmp_path).path(k1).unlink()
    b.flush_index()
    idx = json.loads((tmp_path / "index.json").read_text())
    assert set(idx["entries"]) == {k2}


def test_flush_index_breaks_stale_lock_and_degrades(tmp_path):
    """A crashed flusher's leftover index.lock must not wedge the store:
    young locks serialize, stale locks are broken."""
    store = sw.SimCache(tmp_path)
    store.put("c" * 64, _rec())
    lock = tmp_path / "index.lock"
    lock.write_text("")
    old = lock.stat().st_mtime - 60
    os.utime(lock, (old, old))                  # stale: gets broken
    store.put("d" * 64, _rec())
    idx = json.loads((tmp_path / "index.json").read_text())
    assert set(idx["entries"]) == {"c" * 64, "d" * 64}
    assert not lock.exists()


def test_flush_index_two_process_stress(tmp_path):
    """Two real processes interleave put+flush on one root; the advisory
    index must end up with every entry (zero lost to the race).  Each
    waits at a start gate for the other after its imports, so the two
    really overlap however long importing torch takes."""
    script = (
        "import hashlib, pathlib, sys, time\n"
        "from repro_torch.core.cgra import sweep as sw\n"
        "root, wid = sys.argv[1], sys.argv[2]\n"
        "gate = pathlib.Path(root) / 'gate'\n"
        "gate.mkdir(parents=True, exist_ok=True)\n"
        "(gate / wid).touch()\n"
        "deadline = time.monotonic() + 120\n"
        "while len(list(gate.iterdir())) < 2 and "
        "time.monotonic() < deadline:\n"
        "    time.sleep(0.001)\n"
        "store = sw.SimCache(root)\n"
        "for i in range(25):\n"
        "    key = hashlib.sha256(f'{wid}:{i}'.encode()).hexdigest()\n"
        "    store.put(key, {'kind': 'sim', 'trace': {'kernel': 'x'},\n"
        "                    'cfg': {}, 'stats': {'cycles': i},\n"
        "                    'trace_meta': {}})\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + \
        env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", script,
                               str(tmp_path), wid], env=env)
             for wid in ("w0", "w1")]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    idx = json.loads((tmp_path / "index.json").read_text())
    assert len(idx["entries"]) == 50            # nothing lost


# ---------------------------------------------------------------------------
# The port against the reference on the same points
# ---------------------------------------------------------------------------

def _ref_points(points):
    """The same (spec, config) points with the reference's SimConfig."""
    return [(spec, ref_sw.cfg_from_json(sw.cfg_to_json(cfg)))
            for spec, cfg in points]


def _record(store, key) -> dict:
    """A stored record without the fields that carry the package's source
    digest (the digest itself and the checksum over it)."""
    rec = json.loads(store.path(key).read_text())
    return {k: v for k, v in rec.items() if k not in ("digest", "checksum")}


PARITY_POINTS = [(TRACES[t], cfg) for t in sorted(TRACES)
                 for cfg in CONFIGS.values()] + [
    (PARITY_TRACES[t], PARITY_GRID[c])
    for t in ("bfs_small", "hash_join_small", "src2dest_2k")
    for c in ("runahead_mshr2", "l1_per_cache", "l1_per_cache_ra",
              "spm_only_133k")] + [("rgb", presets.CACHE_SPM)]


def test_sweep_matches_the_reference(tmp_path):
    """The same points through both packages' sweeps, into separate stores:
    equal Stats, trace metadata and engines; stored records equal but for
    the digest and checksum; the same index summaries."""
    port_store = sw.SimCache(tmp_path / "port")
    ref_store = ref_sw.SimCache(tmp_path / "ref")
    got = sw.sweep(PARITY_POINTS, store=port_store, workers=0, chaos=None)
    want = ref_sw.sweep(_ref_points(PARITY_POINTS), store=ref_store,
                        workers=0, chaos=None)
    assert len(got) == len(want) == len(PARITY_POINTS)
    for g, w in zip(got, want):
        assert g.stats.to_dict() == w.stats.to_dict()
        assert g.trace_meta == w.trace_meta
        assert g.engine == w.engine and g.diag == w.diag
        assert not g.cached and not w.cached
        assert g.key != w.key                   # each package's digest
        assert _record(port_store, g.key) == _record(ref_store, w.key)
    port_idx = json.loads((tmp_path / "port" / "index.json").read_text())
    ref_idx = json.loads((tmp_path / "ref" / "index.json").read_text())
    assert sorted(map(json.dumps, port_idx["entries"].values())) == \
        sorted(map(json.dumps, ref_idx["entries"].values()))
    # warm: both serve every point from their own store
    again = sw.sweep(PARITY_POINTS, store=sw.SimCache(tmp_path / "port"),
                     workers=0, chaos=None)
    assert all(r.cached for r in again)
    assert [r.stats for r in again] == [r.stats for r in got]


SPECS = ["gcn_cora", "rgb", ("gcn_aggregate", {"dataset": "cora",
                                               "max_edges": 800}),
         ("mesh_gather", {"nx": 16, "ny": 16, "numbering": "shuffled"}),
         ["bfs_frontier", {"n_nodes": 512, "n_edges": 2048}]]


def test_canonical_forms_and_keys_are_the_references(monkeypatch):
    """Spec and config canonical forms are byte-identical to the
    reference's; point keys differ only through the digest: under the
    reference's digest every key is the reference's."""
    cfgs = list(PARITY_GRID.values())
    for spec in SPECS:
        assert json.dumps(sw.normalize_spec(spec), sort_keys=True) == \
            json.dumps(ref_sw.normalize_spec(spec), sort_keys=True)
        assert sw.spec_label(sw.normalize_spec(spec)) == \
            ref_sw.spec_label(ref_sw.normalize_spec(spec))
    for cfg in cfgs:
        ref_cfg = ref_sw.cfg_from_json(sw.cfg_to_json(cfg))
        assert json.dumps(sw.cfg_to_json(cfg), sort_keys=True) == \
            json.dumps(ref_sw.cfg_to_json(ref_cfg), sort_keys=True)
        assert sw._lane_key(cfg) == ref_sw._lane_key(ref_cfg)
    assert sw.code_digest() != ref_sw.code_digest()
    pairs = [(sw.normalize_spec(s), c) for s in SPECS for c in cfgs]
    extra = {"window": 2048, "metric": "time"}
    port_keys = [sw.point_key(s, c) for s, c in pairs]
    ref_keys = [ref_sw.point_key(s, ref_sw.cfg_from_json(sw.cfg_to_json(c)))
                for s, c in pairs]
    assert not set(port_keys) & set(ref_keys)
    monkeypatch.setattr(sw, "_digest_memo", ref_sw.code_digest())
    assert [sw.point_key(s, c) for s, c in pairs] == ref_keys
    assert [sw.point_key(s, c, kind="reconfig", extra=extra)
            for s, c in pairs] == [
        ref_sw.point_key(s, ref_sw.cfg_from_json(sw.cfg_to_json(c)),
                         kind="reconfig", extra=extra) for s, c in pairs]
    assert sw.SCHEMA_VERSION == ref_sw.SCHEMA_VERSION


CHAOS_POINTS = [(TRACES["radix_hist_4k"], presets.CACHE_SPM),
                (TRACES["radix_hist_4k"], presets.RUNAHEAD),
                (TRACES["rgb_2k"], presets.CACHE_SPM),
                (TRACES["rgb_2k"], presets.SPM_ONLY_4K),
                (("src2dest", {"n": 1024}), presets.RECONFIG)]


@pytest.mark.parametrize("spec", ["3:workercrash", "1:enginebug",
                                  "9:mixed", "4:cachecorrupt",
                                  "2:tornjournal", "doomed"])
def test_chaos_plan_fires_alike_in_both_packages(tmp_path, monkeypatch,
                                                 spec):
    """Under the reference's digest (faults at the store sites are keyed by
    point key, which carries it) one plan gives the same faults, retries,
    fallbacks, quarantines, results and store damage in both packages."""
    monkeypatch.setattr(sw, "_digest_memo", ref_sw.code_digest())
    if spec == "doomed":
        rules = (chaos.ChaosRule("sweep.task", "raise", rate=1.0,
                                 first_attempt_only=False, match="rgb"),)
        plan = chaos.ChaosPlan(1, "doomed", rules)
        ref_plan = ref_chaos.ChaosPlan.from_json(plan.to_json())
    else:
        plan, ref_plan = chaos.from_spec(spec), ref_chaos.from_spec(spec)

    def run(mod, store_cls, points, p, root):
        store = store_cls(root)
        res = mod.sweep(points, store=store, workers=0, chaos=p,
                        allow_partial=True)
        again = store_cls(root)
        warm = mod.sweep(points, store=again, workers=0, chaos=None,
                         allow_partial=True)
        return ([(r.key, r.engine, r.error,
                  None if r.stats is None else r.stats.to_dict())
                 for r in res], mod.LAST_REPORT.counters()
                if mod.LAST_REPORT else None, again.quarantined,
                [r.cached for r in warm], dict(mod.LAST_ELASTIC))

    got = run(sw, sw.SimCache, CHAOS_POINTS, plan, tmp_path / "port")
    want = run(ref_sw, ref_sw.SimCache, _ref_points(CHAOS_POINTS), ref_plan,
               tmp_path / "ref")
    assert got == want


# ---------------------------------------------------------------------------
# Where the port differs: store root, digest, fork guard, device
# ---------------------------------------------------------------------------

def test_store_root_is_the_ports_own(tmp_path, monkeypatch):
    """The port's store lives in artifacts/simcache_torch/, apart from the
    reference's artifacts/simcache/; REPRO_SIMCACHE (the reference's knob)
    does not move it, REPRO_TORCH_SIMCACHE does.  Why: a record of one
    package reads as stale in the other, so pruning a shared root would
    delete the other package's records."""
    assert sw.DEFAULT_ROOT == ROOT / "artifacts" / "simcache_torch"
    assert ref_sw.DEFAULT_ROOT == ROOT / "artifacts" / "simcache"
    for a, b in ((sw.DEFAULT_ROOT, ref_sw.DEFAULT_ROOT),
                 (ref_sw.DEFAULT_ROOT, sw.DEFAULT_ROOT)):
        assert not a.is_relative_to(b)
    monkeypatch.delenv("REPRO_TORCH_SIMCACHE", raising=False)
    monkeypatch.setenv("REPRO_SIMCACHE", str(tmp_path / "ref_root"))
    assert sw.SimCache().root == sw.DEFAULT_ROOT
    assert ref_sw.SimCache().root == tmp_path / "ref_root"
    monkeypatch.setenv("REPRO_TORCH_SIMCACHE", str(tmp_path / "port_root"))
    assert sw.SimCache().root == tmp_path / "port_root"
    assert ref_sw.SimCache().root == tmp_path / "ref_root"
    # the hazard the separate roots avoid
    shared = tmp_path / "shared"
    sw.sweep([POINT], store=sw.SimCache(shared), workers=0, chaos=None)
    ref_sw.sweep(_ref_points([POINT]), store=ref_sw.SimCache(shared),
                 workers=0, chaos=None)
    assert ref_sw.SimCache(shared).prune_stale() == 1     # the port's record
    assert sw.SimCache(shared).prune_stale() == 1         # the reference's


@pytest.mark.parametrize("fname", sw._SRC_FILES)
def test_editing_any_digested_source_changes_the_digest(tmp_path,
                                                        monkeypatch, fname):
    """Every file of ``_SRC_FILES`` (the profiler's Python and CUDA sources
    among them) is in the key: one changed byte moves the digest."""
    here = pathlib.Path(sw.__file__).resolve().parent
    for f in sw._SRC_FILES:
        (tmp_path / f).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / f).write_bytes((here / f).read_bytes())
    monkeypatch.setattr(sw, "__file__", str(tmp_path / "sweep.py"))
    monkeypatch.setattr(sw, "_digest_memo", None)
    assert sw.code_digest() == digest_of(here)
    monkeypatch.setattr(sw, "_digest_memo", None)
    with open(tmp_path / fname, "ab") as f:
        f.write(b"\n")
    assert sw.code_digest() != digest_of(here)
    assert {"cache_grid.py", "csrc/cache_grid.cu"} <= set(sw._SRC_FILES)
    assert "jaxcache.py" not in sw._SRC_FILES


def digest_of(here: pathlib.Path) -> str:
    """The port's digest as computed from the checkout's own files."""
    import hashlib
    h = hashlib.sha256()
    for fname in sw._SRC_FILES:
        h.update(fname.encode())
        h.update((here / fname).read_bytes())
    return h.hexdigest()[:16]


def test_fork_guard_watches_cuda(monkeypatch):
    """Once CUDA is initialized, a fork-context sweep declines to fork a
    new pool (and a rebuild after a crash degrades to inline work); a pool
    forked before then is still used."""
    sw.shutdown_pool()
    monkeypatch.setenv("REPRO_SWEEP_START", "fork")
    monkeypatch.setenv("REPRO_SWEEP_WORKERS", "2")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert sw._pool_for_sweep() is None
    assert sw._rebuild_pool() is None and sw._executor is None
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    try:
        pool = sw._pool_for_sweep()
        assert pool is not None
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        assert sw._pool_for_sweep() is pool         # forked before CUDA
    finally:
        sw.shutdown_pool()


def test_ensure_pool_forks_its_workers_at_once(monkeypatch):
    """A fork-context executor forks at its first task; ``ensure_pool``
    forks them before returning, so a caller can fork before CUDA."""
    sw.shutdown_pool()
    monkeypatch.setenv("REPRO_SWEEP_START", "fork")
    try:
        pool = sw.ensure_pool(2)
        assert len(pool._processes) == 2
        assert all(p.is_alive() for p in pool._processes.values())
        assert sw.ensure_pool(5) is pool            # idempotent
        assert sw._executor_workers == 2
    finally:
        sw.shutdown_pool()
    assert sw._executor is None
    assert sw.ensure_pool(1) is None                # one worker: inline


def test_chaos_after_cuda_degrades_to_inline_and_stays_durable(tmp_path,
                                                                 monkeypatch):
    """Phase 16's chaos gate on the CPU: a pool forked before "CUDA", then
    a worker crash; the rebuild declines, the rest runs inline, the
    results are bit-identical to a fault-free run, and every point is in
    the store (a warm sweep computes nothing)."""
    sw.shutdown_pool()
    monkeypatch.setenv("REPRO_SWEEP_START", "fork")
    points = CHAOS_POINTS
    cold = sw.sweep(points, store=sw.SimCache(tmp_path / "cold"), workers=0,
                    chaos=None)
    try:
        sw.ensure_pool(2)
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        plan = chaos.ChaosPlan(3, "workercrash",
                               chaos.PROFILES["workercrash"])
        res = sw.sweep(points, store=sw.SimCache(tmp_path / "chaos"),
                       workers=2, chaos=plan)
        rep = sw.LAST_REPORT
        assert sw._executor is None                 # degraded, not rebuilt
    finally:
        sw.shutdown_pool()
    assert rep.crashes >= 1 and rep.pool_rebuilds >= 1 and rep.retries >= 1
    assert rep.ok()
    assert [r.stats for r in res] == [r.stats for r in cold]
    warm = sw.sweep(points, store=sw.SimCache(tmp_path / "chaos"),
                    workers=0, chaos=None)
    assert all(r.cached for r in warm)


def test_reconfigure_cached_record_is_the_references(tmp_path, monkeypatch):
    """``reconfigure_cached(device="cpu")`` stores the reference's record
    (but for the digest and checksum) and returns its result; a warm call
    profiles nothing: no ``profile_curves``, no cache-grid call."""
    spec = TRACES["gcn_cora_800"]
    store = sw.SimCache(tmp_path / "port")
    ref_store = ref_sw.SimCache(tmp_path / "ref")
    got = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048,
                                store=store, device="cpu")
    ref_cfg = ref_sw.cfg_from_json(sw.cfg_to_json(presets.RECONFIG))
    want = ref_sw.reconfigure_cached(spec, ref_cfg, window=2048,
                                     store=ref_store)
    key = sw.point_key(sw.normalize_spec(spec), presets.RECONFIG,
                       kind="reconfig",
                       extra={"window": 2048, "metric": "time"})
    ref_key = ref_sw.point_key(ref_sw.normalize_spec(spec), ref_cfg,
                               kind="reconfig",
                               extra={"window": 2048, "metric": "time"})
    assert _record(store, key) == _record(ref_store, ref_key)
    assert got.allocations == list(want.allocations)
    assert got.lines == list(want.lines) and got.profit == want.profit
    assert sw.cfg_to_json(got.config) == ref_sw.cfg_to_json(want.config)
    assert (got.h_curves == want.h_curves).all()

    calls = []

    def spy(*a, **k):
        calls.append(a)
        raise AssertionError("a warm call must not profile")
    monkeypatch.setattr(reconfig, "profile_curves", spy)
    monkeypatch.setattr(cache_grid, "miss_counts", spy)
    monkeypatch.setattr(cache_grid, "hit_series", spy)
    warm = sw.reconfigure_cached(spec, presets.RECONFIG, window=2048,
                                 store=sw.SimCache(tmp_path / "port"),
                                 device="cpu")
    assert calls == [] and warm.h_curves is None
    assert (warm.allocations, warm.lines, warm.profit, warm.config) == \
        (got.allocations, got.lines, got.profit, got.config)


def test_simulate_cgra_twin_prints_the_references_numbers(monkeypatch):
    import contextlib
    import importlib.util
    import io

    def run(name, argv):
        path = ROOT / "examples" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        monkeypatch.setattr(sys, "argv", [str(path), *argv])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            module.main()
        return out.getvalue()

    want = run("simulate_cgra", ["--kernel", "src2dest"])
    got = run("simulate_cgra_torch", ["--kernel", "src2dest", "--device",
                                      "cpu"])
    assert got == want and "reconfig + runahead" in got


def test_sweep_cli_reports_the_ports_store(tmp_path):
    """``python -m repro_torch.core.cgra.sweep`` reads and prunes the port's
    store under ``--root``."""
    sw.sweep([POINT], store=sw.SimCache(tmp_path), workers=0, chaos=None)
    junk = tmp_path / "ab" / ("ab" + "0" * 62 + ".json")
    junk.parent.mkdir(parents=True, exist_ok=True)
    junk.write_text("{not json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.cgra.sweep", "--root",
         str(tmp_path), "--prune"], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (f"root={tmp_path} entries=2 current_digest={sw.code_digest()} "
            f"live=1 stale=0 corrupt=1") in proc.stdout
    assert "pruned=1" in proc.stdout
