"""Boundaries of the PyTorch port: no JAX and nothing of the reference in
its imports, the card by default, no silent fallback from a kernel, and
config data identical to the reference's."""
import ast
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro_torch.configs import registry
from repro_torch.core.cgra import cache_grid
from repro_torch.kernels import _build
from repro_torch.kernels.gather_runahead import gather_runahead as gather_kernel
from repro_torch.kernels.gather_runahead import ops as gather_ops
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as kernel
from repro_torch.models import api
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


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


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert set(_build.SOURCES) == {"paged_attention", "gather_runahead",
                                   "cache_grid"}
    for name, src in _build.SOURCES.items():
        assert src.exists() and src.suffix == ".cu", name
        assert _build.library_path(name).parent == \
            ROOT / "build" / "kernels"


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
