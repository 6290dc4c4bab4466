"""The port's §3.4 loop and Algorithm-1 allocator against the JAX package's,
on the CPU.

``repro_torch.core.cgra.reconfig`` profiles through the cache-grid model
(its CPU route is the kernels' order, ``cache_grid.hit_series_stack_ref``),
the reference through ``_batch_engine.lru_miss_counts``: two algorithms,
held here to the same miss counts, hit rates, allocations, lines, profit
and configurations exactly.  ``core.runahead.allocate`` is held to the
reference's plan on seeded streams and on the smoke dbrx-132b streams
(the reference's weights carried into the port, so ``routing_trace``
gives the same expert ids).  The examples' twins print the reference
examples' numbers, and the profile refuses, rather than diverges on, what
the kernels compute differently (more than 32 ways; addresses outside
[0, 2**31)).
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.configs import registry as jax_registry
from repro.core.cgra import presets as jax_presets
from repro.core.cgra import reconfig as jax_reconfig
from repro.core.cgra.trace import KERNELS as JAX_KERNELS
from repro.core.runahead import vmem_allocator as jax_alloc
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.core.cgra import presets, reconfig
from repro_torch.core.cgra.trace import KERNELS
from repro_torch.core.runahead import allocate, vmem_allocator
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
GRID = dict(way_options=list(range(33)), line_options=[16, 32, 64, 128],
            way_bytes=512)


def _profits(seed: int, n: int, t_max: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    profit = rng.normal(size=(n, t_max + 1))
    if seed % 2:                 # ties, as log hit rates of 1.0 give
        profit = np.round(profit, 1)
    return profit


def _check_algorithm1(profit, t_max):
    got = reconfig.algorithm1(profit, t_max)
    assert got == jax_reconfig.algorithm1(profit, t_max)
    p_bf, _ = reconfig.brute_force_allocation(profit, t_max)
    assert (p_bf, _) == jax_reconfig.brute_force_allocation(profit, t_max)
    assert got[0] == pytest.approx(p_bf, abs=1e-9)
    assert sum(got[1]) <= t_max and min(got[1]) >= 0


@pytest.mark.parametrize("seed,n,t_max", [(s, 1 + s % 4, 1 + s % 6)
                                          for s in range(12)])
def test_algorithm1_matches_the_reference_and_brute_force(seed, n, t_max):
    _check_algorithm1(_profits(seed, n, t_max), t_max)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(min_value=1, max_value=4),
       t_max=st.integers(min_value=1, max_value=6), data=st.data())
def test_algorithm1_property(n, t_max, data):
    profit = np.array(data.draw(st.lists(
        st.lists(st.floats(min_value=-5, max_value=5, allow_nan=False),
                 min_size=t_max + 1, max_size=t_max + 1),
        min_size=n, max_size=n)))
    _check_algorithm1(profit, t_max)


def test_hit_rate_metrics_match_the_reference():
    rng = np.random.default_rng(0)
    hits, iters = rng.random(500) < 0.7, np.sort(rng.integers(0, 90, 500))
    for h, it in [(hits, iters), (hits[:0], iters[:0])]:
        assert reconfig.traditional_hit_rate(h) == \
            jax_reconfig.traditional_hit_rate(h)
        assert reconfig.time_hit_rate(h, it) == \
            jax_reconfig.time_hit_rate(h, it)


@pytest.mark.parametrize("window", [4096, None])
def test_sample_streams_match_the_reference(window):
    got = reconfig.sample_streams(KERNELS["grad"](), presets.RECONFIG,
                                  window)
    want = jax_reconfig.sample_streams(JAX_KERNELS["grad"](),
                                       jax_presets.RECONFIG, window)
    assert len(got) == len(want)
    for (a, i), (b, j) in zip(got, want):
        assert np.array_equal(a, b) and np.array_equal(i, j)


def _streams(kind: str) -> list:
    if kind == "gcn_cora":
        return jax_reconfig.sample_streams(JAX_KERNELS["gcn_cora"](),
                                           jax_presets.RECONFIG, 8192)
    rng = np.random.default_rng(5)
    addrs = rng.integers(0, 2**31 - 1, 3000)          # all of int32
    local = rng.zipf(1.3, 5000) % 2048 * 4
    return [(addrs, np.arange(addrs.size)),
            (local, np.repeat(np.arange(1000), 5)),
            (addrs[:0], np.arange(0))]


@pytest.mark.parametrize("metric", ["time", "traditional"])
@pytest.mark.parametrize("kind", ["gcn_cora", "random"])
def test_profile_curves_match_the_reference(kind, metric):
    streams = _streams(kind)
    got = reconfig.profile_curves(streams, metric=metric, device="cpu",
                                  **GRID)
    want = jax_reconfig.profile_curves(streams, metric=metric, **GRID)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _same_result(got, want):
    assert got.allocations == want.allocations
    assert got.lines == want.lines
    assert got.profit == want.profit
    assert got.h_curves.tobytes() == want.h_curves.tobytes()
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)


@pytest.mark.parametrize("name,window,metric", [
    ("gcn_cora", 8192, "time"), ("grad", 8192, "time"),
    ("radix_update", 8192, "time"), ("rgb", None, "time"),
    ("gcn_citeseer", 8192, "traditional"),
])
def test_reconfigure_matches_the_reference(name, window, metric):
    got = reconfig.reconfigure(KERNELS[name](), presets.RECONFIG,
                               window=window, metric=metric, device="cpu")
    want = jax_reconfig.reconfigure(JAX_KERNELS[name](),
                                    jax_presets.RECONFIG, window=window,
                                    metric=metric)
    _same_result(got, want)


def test_reconfigure_with_fewer_ways_and_lines():
    kw = dict(total_ways=12, line_options=(32, 128), window=2048)
    _same_result(
        reconfig.reconfigure(KERNELS["src2dest"](), presets.RECONFIG,
                             device="cpu", **kw),
        jax_reconfig.reconfigure(JAX_KERNELS["src2dest"](),
                                 jax_presets.RECONFIG, **kw))


def _same_plan(got, want):
    assert [dataclasses.astuple(s) for s in got.streams] == \
        [dataclasses.astuple(s) for s in want.streams]
    assert (got.depth, got.total_profit) == (want.depth, want.total_profit)


@pytest.mark.parametrize("seed", range(4))
def test_allocate_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    streams = {"zipf": rng.zipf(1.2 + 0.1 * seed, 4000) % 3000,
               "uniform": rng.integers(0, 20_000, 3000),
               "loop": np.tile(np.arange(50 * (seed + 1)), 30)}
    rows = {"zipf": 12_288, "uniform": 512}
    kw = dict(budget_tiles=4 + 4 * seed, row_bytes=rows)
    _same_plan(allocate(streams, device="cpu", **kw),
               jax_alloc.allocate(streams, **kw))


def _dbrx_streams():
    """The autotune example's streams from the smoke dbrx-132b, the
    reference's weights in both packages."""
    jcfg = jax_registry.smoke("dbrx-132b")
    tcfg = registry.smoke("dbrx-132b")
    jp = jax_api.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (8, 128))
    x = np.asarray(jp["embed"], np.float32)[tokens]
    block0 = jax.tree.map(lambda a: a[0], jp["groups"][0])
    want = np.asarray(jax_moe.routing_trace(block0["moe"], x, jcfg))
    with torch.no_grad():
        got = moe.routing_trace(tp.blocks[0].moe,
                                tp.embed[torch.from_numpy(tokens)], tcfg)
    assert np.array_equal(got.numpy(), want)
    rows = {"vocab_embedding": tcfg.d_model * 2,
            "moe_expert_rows": tcfg.d_ff * 2}
    return ({"vocab_embedding": tokens.reshape(-1),
             "moe_expert_rows": want.reshape(-1)}, rows)


def test_allocate_matches_the_reference_on_dbrx_streams():
    streams, rows = _dbrx_streams()
    for budget in (4, 16):
        _same_plan(allocate(streams, budget_tiles=budget, row_bytes=rows,
                            device="cpu"),
                   jax_alloc.allocate(streams, budget_tiles=budget,
                                      row_bytes=rows))


def test_profile_refuses_what_the_kernels_compute_differently():
    ok = [(np.arange(10) * 4, np.arange(10))]
    with pytest.raises(ValueError, match="at most 32"):
        reconfig.profile_curves(ok, list(range(34)), [64], 512,
                                device="cpu")
    for bad in (np.array([0, 2**31]), np.array([-4, 8])):
        with pytest.raises(ValueError, match=r"\[0, 2\*\*31\)"):
            reconfig.profile_curves([(bad, np.arange(2))], [0, 1], [64],
                                    512, device="cpu")
    with pytest.raises(ValueError, match="at most 32"):
        reconfig.reconfigure(KERNELS["rgb"](), presets.RECONFIG,
                             total_ways=40, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 2\*\*31\)"):
        vmem_allocator.allocate({"rows": np.array([1, 2**20])},
                                row_bytes={"rows": 4096}, device="cpu")


def _run_example(path: Path, argv=None) -> str:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main() if argv is None else module.main(argv)
    return out.getvalue()


def test_quickstart_twin_prints_the_references_numbers():
    got = _run_example(ROOT / "examples" / "quickstart_torch.py",
                       ["--device", "cpu"]).splitlines()
    want = _run_example(ROOT / "examples" / "quickstart.py").splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if not a.startswith("== 3."):      # part 3's header names the device
            assert a == b
    assert "correct=True" in got[-1]


def test_autotune_twin_prints_the_references_numbers():
    """With the reference's weights carried over, the twin's ``tune``
    prints what the reference example prints; its own ``main`` runs on its
    own random weights."""
    path = ROOT / "examples" / "autotune_vmem_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    jcfg, tcfg = jax_registry.smoke("dbrx-132b"), registry.smoke("dbrx-132b")
    jp = jax_api.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (8, 128))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        twin.tune(tcfg, tp, tokens.astype(np.int32), "cpu")
    want = _run_example(ROOT / "examples" / "autotune_vmem.py")
    assert out.getvalue() == want
    assert "runahead_gather params" in _run_example(path, ["--device", "cpu"])
