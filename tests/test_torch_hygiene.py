"""Boundaries of the PyTorch port: no JAX and nothing of the reference in
its imports, the card by default, no silent fallback from a kernel, and
config data identical to the reference's."""
import ast
import dataclasses
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro_torch.configs import registry
from repro_torch.core.cgra import (cache_grid, presets, reconfig, sweep,
                                   trace)
from repro_torch.core.runahead import allocate
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gather_runahead import gather_runahead as gather_kernel
from repro_torch.kernels.gather_runahead import ops as gather_ops
from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as kernel
from repro_torch.launch import serve_lm, steps, train_lm
from repro_torch.models import api, layers
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + sorted(
    (ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_engine_defaults_to_the_card(monkeypatch):
    """With no ``device`` the engine wants CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.smoke("qwen2-1.5b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, slots=2, max_len=32)


def test_cpu_tensors_take_the_plain_version_and_never_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU call must not build the kernel")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    b, h, hkv, d, page, pps = 2, 4, 2, 16, 4, 3
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, d, generator=gen)
    kp = torch.randn(8, page, hkv, d, generator=gen)
    vp = torch.randn(8, page, hkv, d, generator=gen)
    pt = torch.randint(0, 8, (b, pps), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([5, 12], dtype=torch.int32)
    before = kernel.paged_attention.launches
    out = ops.paged_attention(q, kp, vp, pt, lengths)
    assert out.shape == (b, h, d)
    assert kernel.paged_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):       # no silent CPU path
        kernel.paged_attention(q, kp, vp, pt, lengths)


def test_training_entry_points_default_to_the_card(monkeypatch):
    """With no device, train_lm and api.train_loss want CUDA and raise
    without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--steps", "1", "--reduced"])
    cfg = registry.smoke("qwen2-1.5b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": np.zeros((1, 8), np.int32),
             "labels": np.zeros((1, 8), np.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        api.train_loss(params, batch, cfg)
    assert torch.isfinite(api.train_loss(params, batch, cfg, device="cpu"))


def test_training_on_the_cpu_never_builds_or_launches_flash(monkeypatch):
    """The flash forward, blocked attention's grads and a train step take
    the plain version for CPU tensors: nothing is built, no launch is
    counted."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call must not build a kernel")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    before = fa_kernel.flash_attention.launches
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, h, 32, 16, generator=gen).requires_grad_(True)
               for h in (4, 2, 2))
    assert fa_ops.attention(q, k, v).shape == (1, 4, 32, 16)
    layers.blocked_attention(q, k, v, causal=True, q_chunk=16,
                             k_chunk=16).sum().backward()
    cfg = dataclasses.replace(registry.smoke("qwen2-1.5b"),
                              attn_impl="blocked")
    opt = steps.make_optimizer(cfg)
    state = train_lm.init_state(cfg, opt, "cpu")
    batch = {"tokens": np.ones((2, 16), np.int32),
             "labels": np.ones((2, 16), np.int32)}
    _, metrics = steps.train_step(state, batch, cfg, opt, device="cpu")
    assert np.isfinite(metrics["loss"].item())
    assert fa_kernel.flash_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):        # no silent CPU path
        fa_kernel.flash_attention(q.detach(), q.detach(), q.detach())
    assert fa_kernel.flash_attention.launches == before


def _launch_counts():
    return [f.launches for f in (gather_kernel.runahead_gather,
                                 gather_kernel.pipelined_gather,
                                 gather_kernel.gather_bag,
                                 cache_grid.cache_grid_scan)]


def test_runahead_path_on_the_cpu_never_builds_or_launches(monkeypatch):
    """The three gather ops and the profiler take their plain versions for
    CPU tensors: nothing is built and no launch counter moves."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call must not build a kernel")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(32, 8, generator=gen)
    idx = torch.randint(0, 32, (16,), generator=gen, dtype=torch.int32)
    before = _launch_counts()
    for impl in gather_ops.IMPLS:
        assert gather_ops.gather(table, idx, impl=impl).shape == (16, 8)
    bag = gather_ops.gather_bag(table, idx.reshape(4, 4),
                                torch.ones(4, 4))
    assert bag.shape == (4, 8)
    grid = cache_grid.ConfigGrid.build(512, [0, 2], [16, 64])
    assert cache_grid.hit_series(np.arange(10), grid,
                                 device="cpu").shape == (4, 10)
    assert cache_grid.miss_counts(np.arange(10), grid,
                                  device="cpu").shape == (4,)
    assert _launch_counts() == before


@pytest.mark.parametrize("wrapper", [
    lambda t, i: gather_kernel.runahead_gather(t, i),
    lambda t, i: gather_kernel.pipelined_gather(t, i),
    lambda t, i: gather_kernel.gather_bag(t, i.reshape(2, 4),
                                          torch.ones(2, 4)),
    lambda t, i: cache_grid.cache_grid_scan(
        i, cache_grid.ConfigGrid.build(512, [1], [64])),
], ids=["runahead_gather", "pipelined_gather", "gather_bag",
        "cache_grid_scan"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    """No silent CPU path: each CUDA wrapper raises on a CPU tensor."""
    table = torch.zeros(16, 8)
    idx = torch.zeros(8, dtype=torch.int32)
    before = _launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(table, idx)
    assert _launch_counts() == before


def test_profiler_defaults_to_the_card(monkeypatch):
    """With no ``device`` the profiler wants CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = cache_grid.ConfigGrid.build(512, [1], [64])
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_grid.hit_series(np.arange(4), grid)
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_grid.miss_counts(np.arange(4), grid)


def test_reconfiguration_and_allocator_default_to_the_card(monkeypatch,
                                                           tmp_path):
    """With no ``device``, reconfigure, its store-backed form
    reconfigure_cached (even when the store holds the result),
    profile_curves, allocate and the examples that reconfigure want CUDA
    and raise without it; nothing is profiled on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = trace.src2dest(n=256)
    stream = [(np.arange(16) * 4, np.arange(16))]
    with pytest.raises(RuntimeError, match="CUDA"):
        reconfig.reconfigure(tr, presets.RECONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        reconfig.profile_curves(stream, [0, 1], [64], 512)
    with pytest.raises(RuntimeError, match="CUDA"):
        allocate({"rows": np.arange(8)})
    store = sweep.SimCache(tmp_path)
    spec = ("src2dest", {"n": 256})
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.reconfigure_cached(spec, presets.RECONFIG, store=store)
    assert not any(tmp_path.iterdir())                  # nothing stored
    assert sweep.reconfigure_cached(spec, presets.RECONFIG, store=store,
                                    device="cpu").h_curves is not None
    with pytest.raises(RuntimeError, match="CUDA"):     # cached: still
        sweep.reconfigure_cached(spec, presets.RECONFIG, store=store)
    for argv in ([], ["--device", "cuda"]):
        for example in ("quickstart_torch", "autotune_vmem_torch",
                        "simulate_cgra_torch", "sweep_chaos_torch",
                        "sweep_elastic_torch"):
            with pytest.raises(RuntimeError, match="CUDA"):
                _example(example).main(argv)
    assert reconfig.reconfigure(tr, presets.RECONFIG,
                                device="cpu").allocations


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SOURCES) == {"paged_attention", "gather_runahead",
                                   "cache_grid", "flash_attention",
                                   "moe_dispatch", "ssd_scan"}
    for name, src in _build.SOURCES.items():
        assert src.exists() and src.suffix == ".cu", name
        assert _build.library_path(name).parent == \
            ROOT / "build" / "kernels"


def _moe_ssm_counts():
    return [f.launches for f in (moe_kernel.dispatch, moe_kernel.combine,
                                 ssd_kernel.ssd_scan)]


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_moe_and_ssm_on_the_cpu_never_build_or_launch(monkeypatch, arch):
    """The MoE and SSM layers take the plain versions for CPU tensors in
    training (forward and grads), prefill, the legacy decode and, for the
    MoE arch, the serve engine: nothing is built and no launch counter
    moves."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call must not build a kernel")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    before = _moe_ssm_counts()
    cfg = registry.smoke(arch)
    opt = steps.make_optimizer(cfg)
    state = train_lm.init_state(cfg, opt, "cpu")
    batch = {"tokens": np.ones((8, 16), np.int32),    # accum_steps | 8
             "labels": np.ones((8, 16), np.int32)}
    _, metrics = steps.train_step(state, batch, cfg, opt, device="cpu")
    assert np.isfinite(metrics["loss"].item())
    params = state["params"]
    assert api.prefill(params, batch, cfg, device="cpu").shape == \
        (8, cfg.vocab_size)
    cache = api.init_cache(cfg, 2, 8, device="cpu")
    logits, _ = api.decode(params, np.ones((2, 1), np.int32), cache, cfg)
    assert logits.shape == (2, cfg.vocab_size)
    if api.serve_supported(cfg)[0]:
        eng = ServeEngine(cfg, params, slots=2, max_len=32, prefill_chunk=8,
                          device="cpu")
        eng.submit([1, 2, 3], max_new_tokens=3)
        eng.run()
        eng.assert_no_leaks()
    assert _moe_ssm_counts() == before


@pytest.mark.parametrize("wrapper", [
    lambda: moe_kernel.dispatch(torch.zeros(4, 8),
                                torch.zeros(4, dtype=torch.int32), 4),
    lambda: moe_kernel.combine(torch.zeros(4, 8),
                               torch.zeros(4, 2, dtype=torch.int32),
                               torch.ones(4, 2)),
    lambda: ssd_kernel.ssd_scan(torch.zeros(1, 4, 2, 8), torch.ones(1, 4, 2),
                                torch.zeros(2), torch.zeros(1, 4, 4),
                                torch.zeros(1, 4, 4), torch.ones(2)),
], ids=["moe_dispatch", "moe_combine", "ssd_scan"])
def test_moe_and_ssd_wrappers_refuse_cpu_tensors(wrapper):
    before = _moe_ssm_counts()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper()
    assert _moe_ssm_counts() == before


def test_serving_and_decode_entry_points_default_to_the_card(monkeypatch):
    """With no device, serve_lm (both modes) and api.init_cache want CUDA
    and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--arch", "dbrx-132b"], ["--arch", "mamba2-2.7b",
                                           "--legacy"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_lm.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(registry.smoke("mamba2-2.7b"), 1, 8)


def test_configs_are_the_references():
    assert registry.list_archs() == jax_registry.list_archs()
    for name in registry.list_archs():
        for make in ("get", "smoke"):
            port = getattr(registry, make)(name)
            ref = getattr(jax_registry, make)(name)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), name
            assert port.pattern() == tuple(
                type(port.pattern()[0])(s.mixer, s.ffn)
                for s in ref.pattern())


def test_chip_smoke_refuses_without_the_card_or_the_repo(tmp_path):
    """No card: non-zero exit and no result line, from the repo and from a
    directory that holds the script alone."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
