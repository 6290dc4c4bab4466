"""The serve engine's CUDA-graph replay of its model steps.

On the card without a mesh each step kind's model half runs eagerly once,
is captured on its second call and replayed after
(:mod:`repro_torch.launch.step_graph`); the sampler stays eager.  The
card's tests hold a graphed engine against the same engine whose steps
call ``api.serve_decode`` / ``api.serve_prefill`` eagerly, on a dense and
an MoE smoke model, through admissions, retirements and preemptions that
rewrite the page table and ``active`` between replays: the same greedy
tokens, logits within the bfloat16 tolerance of the serving tests, every
step after the first of its kind a replay, and launch counters that count
the replayed kernels.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_graph.py

On the CPU (tier 1), an engine and one under a one-rank host mesh replay
nothing and serve the tokens of the eager steps.
"""
import dataclasses
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import registry
from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.serve import ServeEngine
from repro_torch.sharding.rules import MeshRules

BF16_TOL = dict(rtol=5e-2, atol=5e-2)
ARCHS = ("qwen2-1.5b", "dbrx-132b")
# prompt lengths cross chunk boundaries; budgets end at different steps,
# so slots retire and the queue's requests join mid-run
PROMPT_LENS = (5, 19, 9, 33, 3, 14)
NEW_TOKENS = (6, 11, 4, 9, 7, 5)


def _params(cfg, device):
    return api.init_params(cfg, torch.Generator().manual_seed(0), "cpu"
                           ).to(device)


def _engine(cfg, params, device, **kw):
    kw = dict(dict(slots=3, max_len=64, page_size=8, prefill_chunk=8,
                   capture_logits=True, clock=lambda: 0.0), **kw)
    return ServeEngine(cfg, params, device=device, **kw)


def _eager_steps(eng: ServeEngine) -> None:
    """Swap the engine's steps for plain calls of ``api.serve_decode`` /
    ``api.serve_prefill``: the steps as they ran before any graph (the
    paged backend's default read, the kernel's)."""
    cfg, read = eng.cfg, "kernel"

    def decode(params, tokens, active, temps, key_data, cache):
        return api.serve_decode(params, tokens, active, temps, key_data,
                                cache, cfg, attn_read=read,
                                return_logits=True)

    def prefill(params, tokens, n_valid, slot, temp, key_data, cache):
        return api.serve_prefill(params, tokens, n_valid, slot, temp,
                                 key_data, cache, cfg, return_logits=True)

    eng.steps = dataclasses.replace(eng.steps, decode=decode,
                                    prefill=prefill, graphs=None)


def _serve(eng: ServeEngine, vocab: int) -> list:
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, vocab, n).tolist(), max_new_tokens=m)
            for n, m in zip(PROMPT_LENS, NEW_TOKENS)]
    eng.run()
    eng.assert_no_leaks()
    return reqs


def _streams(reqs) -> list:
    return [list(r.out_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# the CPU: nothing is graphed
# ---------------------------------------------------------------------------

PAGES = pytest.mark.parametrize("pages", [None, 9],
                                ids=["full", "pressure"])
SAME = ("steps", "decode_steps", "prefill_chunks", "tokens_sampled",
        "preemptions", "occupancy_mean", "pool_util_mean")


@PAGES
@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_engine_replays_nothing_and_serves_the_eager_tokens(arch, pages):
    """Full provisioning, and a pool of 9 pages that preempts."""
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    params = _params(cfg, "cpu")
    eng = _engine(cfg, params, "cpu", n_pages=pages)
    assert eng.steps.graphs is None
    got = _serve(eng, cfg.vocab_size)
    ref = _engine(cfg, params, "cpu", n_pages=pages)
    _eager_steps(ref)
    want = _serve(ref, cfg.vocab_size)
    assert _streams(got) == _streams(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.stack(g.logits_log),
                                      np.stack(w.logits_log))
    m, r = eng.metrics.summary(), ref.metrics.summary()
    assert {k: m[k] for k in SAME} == {k: r[k] for k in SAME}
    assert (m["graphed_decode_steps"], m["graphed_prefill_chunks"]) == (0, 0)
    assert m["decode_steps"] > 1 and m["prefill_chunks"] > 1
    assert (m["preemptions"] > 0) == (pages is not None)


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_engine_replays_nothing_and_serves_the_plain_tokens(
        one_rank_mesh):
    cfg = dataclasses.replace(registry.smoke("qwen2-1.5b"), dtype="float32")
    plain = _serve(_engine(cfg, _params(cfg, "cpu"), "cpu"), cfg.vocab_size)
    eng = _engine(cfg, _params(cfg, "cpu"), "cpu",
                  rules=MeshRules(one_rank_mesh))
    assert eng.steps.graphs is None
    assert _streams(_serve(eng, cfg.vocab_size)) == _streams(plain)
    assert eng.steps.replays() == (0, 0)
    assert (eng.metrics.graphed_decode_steps,
            eng.metrics.graphed_prefill_chunks) == (0, 0)


# ---------------------------------------------------------------------------
# the CPU, with CUDA graphs stood in for: replays read the live inputs
# ---------------------------------------------------------------------------

class _Recorder(TorchDispatchMode):
    """Records the aten ops a capture issues, the way a CUDA graph holds
    its kernels: on the tensors themselves, which a replay reads again.
    A host read of a tensor (``item``, ``nonzero``), which a capture
    refuses, raises; what the ops wrote is undone on exit, since a capture
    runs nothing."""

    HOST_READS = (torch.ops.aten._local_scalar_dense.default,
                  torch.ops.aten.nonzero.default)

    def __init__(self, graph):
        super().__init__()
        self.graph, self.undo = graph, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.HOST_READS:
            raise RuntimeError(f"{func} reads the device from the host "
                               f"inside a capture")
        schema = func._schema
        written = [a for i, a in enumerate(args)
                   if i < len(schema.arguments)
                   and schema.arguments[i].alias_info is not None
                   and schema.arguments[i].alias_info.is_write]
        self.undo += [(t, t.clone()) for t in written]
        out = func(*args, **kwargs)
        view = not written and any(r.alias_info is not None
                                   for r in schema.returns)
        if not view:
            self.graph.ops.append((func, args, kwargs, out, bool(written)))
        return out

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for t, was in reversed(self.undo):
            if t.shape == was.shape:    # not an ``out=`` buffer resized
                t.copy_(was)


class _FakeGraph:
    def __init__(self):
        self.ops = []
        self.replays = 0

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out, in_place in self.ops:
            got = func(*args, **kwargs)
            if not in_place:
                # an in-place view op (matmul's ``squeeze_``) may have
                # reshaped the captured output since
                for o, g in zip(tree_leaves(out), tree_leaves(got)):
                    o.copy_(g.reshape(o.shape))


@pytest.fixture
def fake_graphs(monkeypatch):
    """``torch.cuda``'s graph API on the CPU: ``_FakeGraph`` and a capture
    through ``_Recorder``."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: _Recorder(graph))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    # F.one_hot bounds-checks its indices on the host on the CPU only (on
    # the card a device assert does): the same values without the check
    monkeypatch.setattr(torch.nn.functional, "one_hot", lambda i, n: (
        i[..., None] == torch.arange(n, device=i.device)).long())


def _graph_steps(eng: ServeEngine) -> None:
    """The engine's steps as the card builds them, on the CPU."""
    eng.steps = steps._graphed_steps(eng.cfg, "kernel", True, True,
                                     eng.steps.init_cache)


@pytest.fixture
def counted_reads(monkeypatch):
    """The paged read's plain version counted as the kernel's launches."""
    plain = pa_ops.ref.paged_attention_ref

    def counted(*a, **k):
        pa_kernel.paged_attention.launches += 1
        return plain(*a, **k)

    monkeypatch.setattr(pa_ops.ref, "paged_attention_ref", counted)


@PAGES
@pytest.mark.parametrize("arch", ARCHS)
def test_replays_serve_the_eager_tokens_bit_for_bit(fake_graphs,
                                                    counted_reads, arch,
                                                    pages):
    """Every step after the first of its kind replays what its capture
    recorded, on the static inputs, ``lengths`` and ``page_table`` as the
    engine rewrote them; the counters count the replayed reads."""
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    params = _params(cfg, "cpu")
    runs = {}
    for name in ("graphed", "eager"):
        eng = _engine(cfg, params, "cpu", n_pages=pages)
        (_graph_steps if name == "graphed" else _eager_steps)(eng)
        before = pa_kernel.paged_attention.launches
        reqs = _serve(eng, cfg.vocab_size)
        runs[name] = (eng, reqs, pa_kernel.paged_attention.launches - before)
    (geng, greqs, glaunch), (eeng, ereqs, elaunch) = (runs["graphed"],
                                                      runs["eager"])
    assert _streams(greqs) == _streams(ereqs)
    for g, e in zip(greqs, ereqs):
        np.testing.assert_array_equal(np.stack(g.logits_log),
                                      np.stack(e.logits_log))
    m, r = geng.metrics.summary(), eeng.metrics.summary()
    assert {k: m[k] for k in SAME} == {k: r[k] for k in SAME}
    assert (m["graphed_decode_steps"], m["graphed_prefill_chunks"]) == (
        m["decode_steps"] - 1, m["prefill_chunks"] - 1)
    assert [g.replays for g in (geng.steps.graphs[0]._graph,
                                geng.steps.graphs[1]._graph)] == [
        m["decode_steps"] - 1, m["prefill_chunks"] - 1]
    assert glaunch == elaunch == m["decode_steps"] * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_new_params_are_captured_anew(fake_graphs, arch):
    """Decode with params A (eager), A (captured), then B: B's logits,
    from a graph captured for B."""
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    _decode_params_a_a_b(cfg, torch.device("cpu"),
                         steps._graphed_steps(cfg, "kernel", False, True,
                                              _cache_factory(cfg, "cpu")))


def _cache_factory(cfg, device):
    def make():
        cache = api.init_serve_cache(cfg, slots=2, max_len=32, page_size=8,
                                     device=device)
        cache["page_table"].copy_(torch.arange(
            1, 9, dtype=torch.int32).reshape(2, 4))
        return cache
    return make


def _decode_params_a_a_b(cfg, device, built) -> None:
    a = _params(cfg, device)
    b = api.init_params(cfg, torch.Generator().manual_seed(1), "cpu"
                        ).to(device)
    tokens = np.array([3, 7], np.int32)
    active = np.array([True, True])
    temps, keys = np.zeros(2, np.float32), np.zeros((2, 2), np.uint32)
    cache = built.init_cache()
    keys_seen = []
    for params in (a, a, b):
        cache["lengths"].fill_(2)
        _, got, _ = built.decode(params, tokens, active, temps, keys, cache)
        ref = built.init_cache()
        ref["lengths"].fill_(2)
        _, want, _ = api.serve_decode(params, tokens, active, temps, keys,
                                      ref, cfg, attn_read="kernel",
                                      sampling=False, return_logits=True)
        torch.testing.assert_close(got, want, **BF16_TOL)
        keys_seen.append(built.graphs[0]._key)
    assert built.replays() == (2, 0)
    assert keys_seen[0] is None and keys_seen[1][0] is a \
        and keys_seen[2][0] is b


# ---------------------------------------------------------------------------
# the card: every step after the first of its kind is a replay
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launches() -> tuple:
    return (pa_kernel.paged_attention.launches, moe_kernel.dispatch.launches,
            moe_kernel.combine.launches)


@pytest.mark.cuda
@PAGES
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_engine_matches_eager_steps(card, arch, pages):
    """Full provisioning, and a pool of 9 pages that preempts."""
    cfg = registry.smoke(arch)
    params = _params(cfg, card)
    runs = {}
    for name in ("graphed", "eager"):
        eng = _engine(cfg, params, card, n_pages=pages)
        if name == "eager":
            _eager_steps(eng)
        before = _launches()
        reqs = _serve(eng, cfg.vocab_size)
        torch.cuda.synchronize()
        runs[name] = (eng, reqs, [a - b for a, b in
                                  zip(_launches(), before)])
    (geng, greqs, glaunch), (eeng, ereqs, elaunch) = (runs["graphed"],
                                                      runs["eager"])
    assert _streams(greqs) == _streams(ereqs)
    for g, e in zip(greqs, ereqs):
        assert len(g.out_tokens) == g.params.max_new_tokens
        np.testing.assert_allclose(np.stack(g.logits_log),
                                   np.stack(e.logits_log), **BF16_TOL)
    m, r = geng.metrics.summary(), eeng.metrics.summary()
    assert {k: m[k] for k in SAME} == {k: r[k] for k in SAME}
    assert (m["graphed_decode_steps"], m["graphed_prefill_chunks"]) == (
        m["decode_steps"] - 1, m["prefill_chunks"] - 1)
    assert (m["preemptions"] > 0) == (pages is not None)
    n_moe = cfg.n_layers if cfg.n_experts else 0
    steps_ = m["decode_steps"] + m["prefill_chunks"]
    assert glaunch == elaunch == [m["decode_steps"] * cfg.n_layers,
                                  n_moe * steps_, n_moe * steps_]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_new_params_are_captured_never_replayed_stale(card, arch):
    """Decode with params A (eager), A (captured), then B: B's logits,
    from a graph captured for B."""
    cfg = registry.smoke(arch)
    built = steps.build_serve_engine_steps(
        cfg, slots=2, max_len=32, page_size=8, attn_read="kernel",
        sampling=False, return_logits=True, device=card)
    assert built.graphs is not None
    factory = _cache_factory(cfg, card)
    built = dataclasses.replace(built, init_cache=factory)
    _decode_params_a_a_b(cfg, card, built)
