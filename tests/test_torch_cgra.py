"""The port's CGRA simulator against the JAX package's, on the CPU.

``repro_torch.core.cgra`` keeps its own copies of the reference's NumPy
modules (cache models, traces and workloads, the scalar, batched and
runahead engines, the simulator and its presets).  Here each is held to
the reference exactly on the same seeded inputs: every registry kernel's
trace, column for column, at small constructor sizes; the traces' derived
views; ``Cache`` and ``OracleCache``; and ``simulate`` / ``simulate_batch``
``Stats`` over every preset, with runahead off and on and with per-cache
L1 geometries that differ.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.cgra as jax_cgra
from repro.core.cgra import cache as jax_cache
from repro.core.cgra import presets as jax_presets
from repro.core.cgra import simulator as jax_sim
from repro.core.cgra import trace as jax_trace
from repro.core.cgra import workloads as jax_workloads
import repro_torch.core.cgra as cgra
from repro_torch.core.cgra import cache, presets, simulator, trace, workloads

# registry name -> (module attribute, args, kwargs) at a small size
SMALL = {
    "gcn_citeseer": ("gcn_aggregate", ("citeseer",), dict(max_edges=1500)),
    "gcn_cora": ("gcn_aggregate", ("cora",), dict(max_edges=1500)),
    "gcn_pubmed": ("gcn_aggregate", ("pubmed",), dict(max_edges=1500)),
    "gcn_ogbn_arxiv": ("gcn_aggregate", ("ogbn_arxiv",),
                       dict(max_edges=1500)),
    "grad": ("grad", (), dict(n_cells=1024, n_faces=1536)),
    "perm_sort": ("perm_sort", (), dict(n=2048, key_range=512)),
    "radix_hist": ("radix_hist", (), dict(n=4096, n_buckets=256)),
    "radix_update": ("radix_update", (), dict(n=3072, n_buckets=128)),
    "rgb": ("rgb", (), dict(n=1024, palette_size=4096)),
    "src2dest": ("src2dest", (), dict(n=1024)),
    "random": ("random_access", (), dict(n=1024, table_elems=16_384)),
    "bfs_powerlaw": ("bfs_frontier", (), dict(n_nodes=512, n_edges=3072,
                                              max_edges=2000)),
    "pagerank_push": ("pagerank_push", (), dict(n_nodes=384, n_edges=2304,
                                                max_edges=2000)),
    "hash_join_skew": ("hash_join", (), dict(n_build=256, n_probe=512,
                                             n_buckets=64, skew=1.2)),
    "hash_join_uniform": ("hash_join", (), dict(n_build=256, n_probe=512,
                                                n_buckets=64, skew=0.0)),
    "mesh_rcm": ("mesh_gather", (), dict(nx=16, ny=16, numbering="rcm")),
    "mesh_shuffled": ("mesh_gather", (), dict(nx=16, ny=16,
                                              numbering="shuffled")),
}
COLUMNS = ("pe", "addr", "is_store", "addr_dep", "iter_id")
PRESETS = ("SPM_ONLY_4K", "SPM_ONLY_133K", "BASE", "CACHE_SPM", "RUNAHEAD",
           "RECONFIG", "RECONFIG_RA", "STORAGE_EXP")


def _make(name: str, port: bool):
    attr, args, kwargs = SMALL[name]
    for mod in ((trace, workloads) if port else (jax_trace, jax_workloads)):
        if hasattr(mod, attr):
            return getattr(mod, attr)(*args, **kwargs)
    raise KeyError(attr)


def _assert_same_trace(got, want):
    assert (got.name, got.ii, got.n_iters) == (want.name, want.ii,
                                               want.n_iters)
    for col in COLUMNS:
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    assert [dataclasses.asdict(a) for a in got.arrays.values()] == \
        [dataclasses.asdict(a) for a in want.arrays.values()]
    assert list(got.arrays) == list(want.arrays)


def test_registries_are_the_references():
    assert list(cgra.KERNELS) == list(jax_cgra.KERNELS)
    assert set(SMALL) == set(cgra.KERNELS)
    assert cgra.REAL_DATA_KERNELS == jax_cgra.REAL_DATA_KERNELS
    assert cgra.RANDOM_DATA_KERNELS == jax_cgra.RANDOM_DATA_KERNELS
    assert cgra.FRONTIER_KERNELS == jax_cgra.FRONTIER_KERNELS
    assert trace.GCN_DATASETS == jax_trace.GCN_DATASETS
    assert set(cgra.__all__) == set(jax_cgra.__all__)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traces_match_the_reference(name):
    _assert_same_trace(_make(name, True), _make(name, False))


@pytest.mark.parametrize("name", jax_trace.REAL_DATA_KERNELS)
def test_registry_traces_at_their_default_size(name):
    """Fig. 17's graph kernels as the registry builds them."""
    _assert_same_trace(cgra.KERNELS[name](), jax_cgra.KERNELS[name]())


@pytest.mark.parametrize("seed", range(4))
def test_random_traces_match_the_reference(seed):
    _assert_same_trace(workloads.random_trace(seed),
                       jax_workloads.random_trace(seed))


def test_powerlaw_graph_matches_the_reference():
    for a, b in zip(trace._powerlaw_graph(500, 3000,
                                          np.random.default_rng(4)),
                    jax_trace._powerlaw_graph(500, 3000,
                                              np.random.default_rng(4))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", ["gcn_cora", "grad", "hash_join_skew"])
def test_trace_views_match_the_reference(name):
    got, want = _make(name, True), _make(name, False)
    assert got.footprint() == want.footprint()
    assert got.irregular_fraction == want.irregular_fraction
    assert got.as_lists() == want.as_lists()
    for a, b in [(got.iter_starts(), want.iter_starts()),
                 (got.iter_index(), want.iter_index()),
                 (got.cache_index(4), want.cache_index(4))]:
        assert np.array_equal(a, b)
    for spm in (0, 1024, 8192):
        assert np.array_equal(trace.plan_spm(got, spm),
                              jax_trace.plan_spm(want, spm))
        assert np.array_equal(got.spm_mask(spm), want.spm_mask(spm))
        assert np.array_equal(got.arbitration_extra(spm, 4),
                              want.arbitration_extra(spm, 4))
        assert np.array_equal(got.active_index(spm), want.active_index(spm))
        assert np.array_equal(got.walker_index(spm), want.walker_index(spm))
        geometry = ((8, 64, 512),) * 4
        assert got.geometry_lists(spm, 4, geometry) == \
            want.geometry_lists(spm, 4, geometry)


@pytest.mark.parametrize("seed", range(3))
def test_cache_models_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(ways=int(rng.integers(1, 9)), line=int(rng.choice([16, 64])),
               way_bytes=512)
    addrs = (rng.zipf(1.4, 3000) % 4096 * 4).tolist()
    got = cache.OracleCache(cache.CacheConfig(**cfg)).run(addrs)
    assert got == jax_cache.OracleCache(jax_cache.CacheConfig(**cfg)).run(
        addrs)
    port, ref = (c.Cache(c.CacheConfig(**cfg)) for c in (cache, jax_cache))
    for t, a in enumerate(addrs):
        hits = []
        for model in (port, ref):
            line = model.line_addr(a)
            entry = model.probe(line)
            hits.append(entry is not None)
            if entry is None:
                model.install(line, ready=t)
            else:
                model.touch(entry)
        assert hits[0] == hits[1] == got[t]


def test_presets_are_the_references():
    for name in PRESETS:
        assert dataclasses.asdict(getattr(presets, name)) == \
            dataclasses.asdict(getattr(jax_presets, name)), name


def _configs(mod_presets, mod_cache) -> list:
    """Every preset, runahead off and on, and two heterogeneous
    per-cache L1 geometries on the 4-cache system."""
    cfgs = []
    for name in PRESETS:
        base = getattr(mod_presets, name)
        cfgs += [dataclasses.replace(base, runahead=ra)
                 for ra in (False, True)]
    cc = mod_cache.CacheConfig
    hetero = (cc(ways=1, line=128, way_bytes=512),
              cc(ways=29, line=128, way_bytes=512),
              cc(ways=0, line=16, way_bytes=512),
              cc(ways=2, line=32, way_bytes=512))
    for ra in (False, True):
        cfgs.append(dataclasses.replace(mod_presets.RECONFIG,
                                        l1_per_cache=hetero, runahead=ra))
    return cfgs


@pytest.mark.parametrize("name", ["gcn_cora", "grad", "hash_join_skew"])
def test_simulate_matches_the_reference(name):
    got_tr, want_tr = _make(name, True), _make(name, False)
    port = _configs(presets, cache)
    ref = _configs(jax_presets, jax_cache)
    singles = [simulator.simulate(got_tr, c).to_dict() for c in port]
    assert singles == [jax_sim.simulate(want_tr, c).to_dict() for c in ref]
    batch = [s.to_dict() for s in simulator.simulate_batch(got_tr, port)]
    assert batch == [s.to_dict() for s in
                     jax_sim.simulate_batch(want_tr, ref)]
    assert batch == singles
