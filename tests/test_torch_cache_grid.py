"""The port's cache-grid profiler on the CPU against the JAX package.

The port's plain version (``cache_grid.hit_series(..., device="cpu")``) is
held exactly, hit for hit and miss count for miss count, against the
reference's ``jaxcache.hit_series`` (the ``lax.scan`` under ``vmap``),
``cache.OracleCache`` (a dict-of-lists LRU, one configuration at a time)
and ``_batch_engine.lru_miss_counts`` (LRU stack distances over the whole
ways axis).  The last two work on Python integers without the reference
profiler's int32 cast; addresses at or past 2**31 are therefore held
against ``jaxcache`` alone, which the port follows: int32 wrap, floor
division, and tags that start at -1.

The kernels' own order, ``hit_series_stack_ref`` (one capped LRU stack
per (line, sets) group and set), is held exactly against ``jaxcache`` and
the plain version over the same cases, the int32-wrap streams, a grid
whose groups mix set counts at one line size, and one-address streams.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro.core.cgra import _batch_engine, jaxcache
from repro.core.cgra.cache import CacheConfig, OracleCache
from repro_torch.core.cgra import cache_grid
from repro_torch.kernels import _build


def _port_hits(addrs, way_bytes, ways, lines) -> np.ndarray:
    grid = cache_grid.ConfigGrid.build(way_bytes, ways, lines)
    hits = cache_grid.hit_series(addrs, grid, device="cpu")
    assert hits.dtype == torch.bool and hits.shape == (len(grid), len(addrs))
    return hits.numpy()


def _jax_hits(addrs, way_bytes, ways, lines) -> np.ndarray:
    grid = jaxcache.ConfigGrid.build(way_bytes, ways, lines)
    return jaxcache.hit_series(np.asarray(addrs), grid)


def _oracle_hits(addrs, way_bytes, ways, lines) -> np.ndarray:
    return np.array([OracleCache(CacheConfig(ways=w, line=ln,
                                             way_bytes=way_bytes)).run(addrs)
                     for w in ways for ln in lines], dtype=bool)


def _stack_misses(addrs, way_bytes, ways, lines) -> np.ndarray:
    return _batch_engine.lru_miss_counts(addrs, ways, lines, way_bytes) \
        .reshape(-1)


def _repeats(rng):
    hot = rng.integers(0, 1 << 12, 20)
    addrs = rng.choice(hot, 400)
    addrs[100:140] = addrs[100]          # one address 40 times in a row
    return addrs


CASES = {
    # test_cgra_cache.py's multi-configuration grid
    "multi_config": (lambda rng: rng.integers(0, 1 << 14, 500),
                     512, [1, 2, 4], [16, 64]),
    "ways_zero": (lambda rng: rng.integers(0, 1 << 10, 200),
                  512, [0, 1, 3], [16, 64]),
    # 64-byte ways: 4, 2 and 1 sets against up to 8 ways
    "more_ways_than_sets": (lambda rng: rng.integers(0, 1 << 9, 300),
                            64, [1, 3, 6, 8], [16, 32, 64]),
    "repeated_addresses": (_repeats, 256, [1, 2, 5], [16, 32, 128]),
    # the §3.4 profiling grid of presets.RECONFIG: ways 0..32 x 4 lines
    "profiling_grid": (lambda rng: 4 * (rng.zipf(1.5, 600) % 4096),
                       512, list(range(33)), [16, 32, 64, 128]),
}
REFERENCES = {"jaxcache": _jax_hits, "oracle": _oracle_hits}


@pytest.mark.parametrize("ref_name", sorted(REFERENCES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_hit_series_matches_the_reference(case, ref_name):
    make, way_bytes, ways, lines = CASES[case]
    addrs = make(np.random.default_rng(0))
    got = _port_hits(addrs, way_bytes, ways, lines)
    np.testing.assert_array_equal(
        got, REFERENCES[ref_name](addrs, way_bytes, ways, lines))


@pytest.mark.parametrize("case", sorted(CASES))
def test_miss_counts_match_the_reference(case):
    make, way_bytes, ways, lines = CASES[case]
    addrs = make(np.random.default_rng(0))
    grid = cache_grid.ConfigGrid.build(way_bytes, ways, lines)
    got = cache_grid.miss_counts(addrs, grid, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, jaxcache.miss_counts(addrs, jaxcache.ConfigGrid.build(
            way_bytes, ways, lines)))
    np.testing.assert_array_equal(
        got, _stack_misses(addrs, way_bytes, ways, lines))


def test_zero_way_cache_never_hits():
    grid = cache_grid.ConfigGrid.build(512, [0], [64])
    assert not cache_grid.hit_series(np.zeros(3, np.int64), grid,
                                     device="cpu").any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_addresses_past_2_31_follow_the_int32_wrap(seed):
    """The reference casts addresses to int32 and divides with floor
    semantics; a wrapped address lands in the set floor division gives, and
    a tag of -1 (addresses just under 2**32) hits a cold way."""
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 1 << 12, 400)
    addrs[::3] += 2**31
    addrs[::7] = 2**32 - 1 - rng.integers(0, 40, len(addrs[::7]))
    addrs[::11] += 2**33                   # wraps to the same int32
    ways, lines = [0, 1, 2, 4, 8], [16, 32, 64, 128]
    got = _port_hits(addrs, 512, ways, lines)
    np.testing.assert_array_equal(got, _jax_hits(addrs, 512, ways, lines))
    wrapped = np.asarray(addrs, np.int64).astype(np.int32)
    assert (wrapped < 0).any()
    np.testing.assert_array_equal(
        cache_grid.as_int32(addrs, "cpu").numpy(), wrapped)


def test_config_grid_is_the_references():
    for args in [(512, range(33), (16, 32, 64, 128)), (64, [0], [128]),
                 (1024, [1, 2, 4], [16, 64])]:
        port, ref = (cache_grid.ConfigGrid.build(*args),
                     jaxcache.ConfigGrid.build(*args))
        for f in ("lines", "sets", "ways"):
            np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
            assert getattr(port, f).dtype == getattr(ref, f).dtype
        assert (port.max_sets, port.max_ways, len(port)) == \
            (ref.max_sets, ref.max_ways, len(ref))


def _wrap_stream(seed):
    """test_addresses_past_2_31_follow_the_int32_wrap's stream."""
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 1 << 12, 400)
    addrs[::3] += 2**31
    addrs[::7] = 2**32 - 1 - rng.integers(0, 40, len(addrs[::7]))
    addrs[::11] += 2**33
    return addrs


def _mixed_grid(module):
    """A grid no ``build`` gives: line 16 at 32 and 8 sets, line 64 at 8
    and 2, line 1 at 1 set (every address its own tag), and ways 0."""
    lines = [16, 16, 64, 64, 32, 16, 1, 64]
    sets = [32, 8, 8, 2, 16, 32, 1, 8]
    ways = [4, 2, 8, 1, 0, 7, 3, 5]
    return module.ConfigGrid(lines=np.asarray(lines, np.int32),
                             sets=np.asarray(sets, np.int32),
                             ways=np.asarray(ways, np.int32),
                             max_sets=max(sets), max_ways=max(ways))


def _built(way_bytes, ways, lines):
    return lambda module: module.ConfigGrid.build(way_bytes, ways, lines)


STACK_CASES = {
    **{f"case_{name}": (make, _built(*rest))
       for name, (make, *rest) in CASES.items()},
    **{f"wrap_{seed}": (lambda rng, seed=seed: _wrap_stream(seed),
                        _built(512, [0, 1, 2, 4, 8], [16, 32, 64, 128]))
       for seed in (0, 1, 2)},
    "mixed_sets": (lambda rng: rng.integers(-(1 << 11), 1 << 12, 500),
                   _mixed_grid),
    "mixed_sets_wrap": (lambda rng: _wrap_stream(3), _mixed_grid),
    "one_address": (lambda rng: np.full(60, 1000),
                    _built(512, list(range(33)), [16, 32, 64, 128])),
    # tag -1 in every group: hits from the first access on
    "one_address_tag_minus_1": (lambda rng: np.full(40, 2**32 - 1),
                                _built(512, [0, 1, 2, 32], [16, 128])),
    "one_access": (lambda rng: np.array([12345]), _mixed_grid),
}


@pytest.mark.parametrize("case", sorted(STACK_CASES))
def test_stack_version_equals_the_reference(case):
    make, grid_of = STACK_CASES[case]
    addrs = make(np.random.default_rng(0))
    grid = grid_of(cache_grid)
    a = cache_grid.as_int32(addrs, "cpu")
    got = cache_grid.hit_series_stack_ref(a, grid)
    assert got.dtype == torch.bool and got.shape == (len(grid), len(addrs))
    np.testing.assert_array_equal(
        got.numpy(), jaxcache.hit_series(np.asarray(addrs), grid_of(jaxcache)))
    assert torch.equal(got, cache_grid.hit_series_ref(a, grid))


def _chain_by_hand(addrs, line, sets):
    """Longest run of non-repeats in one set, one access at a time."""
    last, steps = {}, {}
    for x in cache_grid.as_int32(addrs, "cpu").tolist():
        s, tag = (x // line) % sets, (x // line) // sets
        if last.get(s, -1) != tag:
            steps[s] = steps.get(s, 0) + 1
        last[s] = tag
    return max(steps.values(), default=0)


@pytest.mark.parametrize("case", ["profiling_grid", "repeated_addresses",
                                  "wrap_1", "mixed_sets", "one_address",
                                  "one_address_tag_minus_1"])
def test_longest_chain_counts_the_non_repeats_of_a_set(case):
    make, grid_of = STACK_CASES.get(case) or STACK_CASES[f"case_{case}"]
    addrs = make(np.random.default_rng(0))
    grid = grid_of(cache_grid)
    groups = cache_grid.config_groups(grid)
    want = max((_chain_by_hand(addrs, ln, st) for ln, st, cap in
                zip(groups.lines, groups.sets, groups.caps) if cap > 0),
               default=0)
    assert cache_grid.longest_chain(addrs, grid) == want


def test_config_groups_pair_line_and_sets():
    grid = _mixed_grid(cache_grid)
    groups = cache_grid.config_groups(grid)
    # (16, 32), (16, 8), (64, 8), (64, 2), (32, 16), (1, 1): order of first
    # appearance; the sixth configuration joins the first group
    assert groups.lines.tolist() == [16, 16, 64, 64, 32, 1]
    assert groups.sets.tolist() == [32, 8, 8, 2, 16, 1]
    assert groups.caps.tolist() == [7, 2, 8, 1, 0, 3]
    assert groups.of_config.tolist() == [0, 1, 2, 3, 4, 0, 5, 2]
    assert groups.chains == 32 + 8 + 8 + 2 + 1
    profiling = cache_grid.config_groups(
        cache_grid.ConfigGrid.build(512, range(33), (16, 32, 64, 128)))
    assert (len(profiling), profiling.chains) == (4, 60)


def test_ctypes_signature_matches_the_source():
    src = _build.SOURCES["cache_grid"].read_text()
    params = re.search(r"int cache_grid_launch\((.*?)\)", src,
                       re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]
    assert cache_grid.LAUNCH_ARGTYPES == want
