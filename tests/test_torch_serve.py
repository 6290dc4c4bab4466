"""The port's serving path against the JAX package, and the serving
invariants the reference pins, held inside the port (CPU, smoke arch).

Against the reference: the same parameters (``api.init_params`` of the
reference, converted by ``checkpoint.convert``) and the same token inputs
go through both packages' prefill/decode steps and whole engines.  Float32
logits agree to 1e-4 (summation order over the 512-word head and the
128-wide MLP) with equal greedy tokens; bfloat16 logits to 5e-2, the
reference's own kernel-vs-gather tolerance.

Inside the port (the reference's tests/test_serve_engine.py, mirrored):
paged == dense bitwise, exact chunked prefill, transparent preemption,
sampling reproducible across batch composition, kernel read close to the
gather read, and the degradation paths (backpressure, capacity, timeout,
chaos drills).  Sampled (temperature > 0) tokens are the port's own
stream and are never compared with JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import api as jax_api
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.models import api, paged_lm
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import StragglerWatchdog
from repro_torch.serve import Backpressure, ServeEngine, drive
from repro_torch.serve.loadgen import RequestSpec
from repro_torch.serve.scheduler import RequestState

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}
PROMPTS = [list(range(1, 6)), list(range(20, 31)), [40, 41]]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(jax cfg, jax params, port cfg, port params) at one dtype."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_registry.smoke("qwen2-1.5b"), dtype=dtype)
    tcfg = dataclasses.replace(registry.smoke("qwen2-1.5b"), dtype=dtype)
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def setup():
    """The port's own smoke model (bfloat16, random init from a seed)."""
    cfg = registry.smoke("qwen2-1.5b")
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def mk_engine(setup, **kw):
    cfg, params = setup
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("device", "cpu")
    return ServeEngine(cfg, params, **kw)


def run_requests(eng, prompts=PROMPTS, max_new=(6, 5, 8),
                 temps=(0.0, 0.7, 0.0), seeds=(0, 9, 0)):
    rs = [eng.submit(p, max_new_tokens=m, temperature=t, seed=s)
          for p, m, t, s in zip(prompts, max_new, temps, seeds)]
    eng.run()
    eng.assert_no_leaks()
    return rs


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_jax_bitwise(pair):
    jcfg, jparams, tcfg, tparams = pair
    assert tparams.embed.dtype == getattr(torch, tcfg.dtype)
    np.testing.assert_array_equal(
        tparams.embed.float().numpy(),
        np.asarray(jparams["embed"], np.float32))
    g0 = jparams["groups"][0]
    for layer, block in enumerate(tparams.blocks):
        for name, leaf in (("attn.wq", g0["attn"]["wq"]),
                           ("attn.bk", g0["attn"]["bk"]),
                           ("mlp.wo", g0["mlp"]["wo"]),
                           ("ffn_norm.scale", g0["ffn_norm"]["scale"])):
            got = block.get_parameter(name)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(leaf[layer], np.float32))


def test_init_lm_layout_matches_reference():
    """Same leaves, shapes and dtypes as the reference's init; weights
    N(0, 0.02), norm scales ones, biases zeros."""
    cfg = registry.smoke("qwen2-1.5b")
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda: jax_api.init_params(
        jax.random.key(0), jax_registry.smoke("qwen2-1.5b")))
    for name, p in model.named_parameters():
        if name.startswith("blocks."):
            _, rest = name.split(".", 2)[1:]
            leaf = ref["groups"][0]
            for part in rest.split("."):
                leaf = leaf[part]
            shape = leaf.shape[1:]
        else:
            leaf = ref
            for part in name.split("."):
                leaf = leaf[part]
            shape = leaf.shape
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), name
        x = p.float()
        if name.endswith("scale"):
            assert torch.equal(x, torch.ones_like(x)), name
        elif name.split(".")[-1] in ("bq", "bk", "bv"):
            assert not x.any(), name
        else:
            assert abs(x.std().item() - 0.02) < 2e-3, name
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    assert sum(p.numel() for p in model.parameters()) == n_ref


# ---------------------------------------------------------------------------
# steps against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,attn_read", [
    ("paged", "gather"), ("paged", "kernel"), ("dense", "gather")])
def test_steps_match_jax(pair, backend, attn_read):
    """Two prefills (one in two chunks), then two decode steps over slots at
    different depths, with one slot inactive: logits and greedy tokens."""
    jcfg, jparams, tcfg, tparams = pair
    tol = LOGIT_TOL[tcfg.dtype]
    slots, max_len, page, chunk = 3, 32, 8, 8
    kw = dict(slots=slots, max_len=max_len, backend=backend, page_size=page)
    jc = jax_api.init_serve_cache(jcfg, **kw)
    tc = api.init_serve_cache(tcfg, device="cpu", **kw)
    pps = max_len // page
    table = (1 + np.arange(slots * pps, dtype=np.int32)).reshape(slots, pps)
    table = table[:, ::-1].copy()                    # non-trivial page order
    if backend == "paged":
        jc["page_table"] = jnp.asarray(table)
        tc["page_table"].copy_(torch.from_numpy(table))
    rng = np.random.default_rng(5)
    kd = np.zeros((2,), np.uint32)
    same_tokens = tcfg.dtype == "float32"
    jax_prefill = jax.jit(jax_api.serve_prefill, static_argnums=(7,),
                          static_argnames=("return_logits",))
    jax_decode = jax.jit(jax_api.serve_decode, static_argnums=(6,),
                         static_argnames=("attn_read", "return_logits"))

    for slot, n_valid in ((0, 5), (1, 8), (1, 3)):
        toks = np.zeros((chunk,), np.int32)
        toks[:n_valid] = rng.integers(0, tcfg.vocab_size, n_valid)
        jt, jl, jc = jax_prefill(
            jparams, jnp.asarray(toks), jnp.int32(n_valid), jnp.int32(slot),
            jnp.float32(0.0), jnp.asarray(kd), jc, jcfg, return_logits=True)
        tt, tl, tc = api.serve_prefill(
            tparams, toks, n_valid, slot, np.float32(0.0), kd, tc, tcfg,
            return_logits=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        if same_tokens:
            assert int(tt) == int(jt)
    active = np.array([True, True, False])
    tokens = rng.integers(0, tcfg.vocab_size, slots).astype(np.int32)
    for _ in range(2):
        temps = np.zeros((slots,), np.float32)
        keys = np.zeros((slots, 2), np.uint32)
        jt, jl, jc = jax_decode(
            jparams, jnp.asarray(tokens), jnp.asarray(active),
            jnp.asarray(temps), jnp.asarray(keys), jc, jcfg,
            attn_read=attn_read, return_logits=True)
        tt, tl, tc = api.serve_decode(
            tparams, tokens, active, temps, keys, tc, tcfg,
            attn_read=attn_read, return_logits=True)
        for b in np.flatnonzero(active):
            np.testing.assert_allclose(tl[b].numpy(), np.asarray(jl[b]),
                                       **tol)
            if same_tokens:
                assert int(tt[b]) == int(jt[b])
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
        tokens = tt.numpy().astype(np.int32)


@pytest.mark.parametrize("attn_read", ["gather", "kernel"])
def test_engine_matches_jax(pair, attn_read):
    """The reference's PROMPTS, greedy, through both engines."""
    jcfg, jparams, tcfg, tparams = pair
    kw = dict(slots=4, max_len=48, page_size=8, prefill_chunk=8,
              attn_read=attn_read, capture_logits=True)
    runs = []
    for eng in (JaxServeEngine(jcfg, jparams, **kw),
                ServeEngine(tcfg, tparams, device="cpu", **kw)):
        rs = [eng.submit(p, max_new_tokens=m)
              for p, m in zip(PROMPTS, (6, 5, 8))]
        eng.run()
        eng.assert_no_leaks()
        runs.append([(r.out_tokens, np.stack(r.logits_log)) for r in rs])
    for (jt, jl), (tt, tl) in zip(*runs):
        if tcfg.dtype == "float32":
            assert tt == jt
        # logits at step i come from the same inputs while the streams
        # agree before i (bf16 may split on a near-tie past that point)
        split = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b),
                     len(jt))
        n = min(split + 1, len(jt))
        np.testing.assert_allclose(tl[:n], jl[:n], **LOGIT_TOL[tcfg.dtype])
        assert n >= 2


# ---------------------------------------------------------------------------
# invariants inside the port (mirrors tests/test_serve_engine.py)
# ---------------------------------------------------------------------------

def test_basic_generation_and_metrics(setup):
    eng = mk_engine(setup)
    rs = run_requests(eng)
    for r, m in zip(rs, (6, 5, 8)):
        assert r.state is RequestState.FINISHED
        assert len(r.out_tokens) == m
        assert r.done_reason() == "length"
        assert r.metrics.ttft is not None and r.metrics.ttft >= 0
    assert eng.metrics.tokens_sampled == 6 + 5 + 8
    assert eng.metrics.prefill_chunks >= 3
    assert 0 < eng.metrics.occupancy_mean <= 1.0


def test_paged_matches_dense_bitwise(setup):
    streams, logs = [], []
    for backend in ("paged", "dense"):
        eng = mk_engine(setup, backend=backend, attn_read="gather",
                        capture_logits=True)
        rs = run_requests(eng)
        streams.append([r.out_tokens for r in rs])
        logs.append([np.stack(r.logits_log) for r in rs])
    assert streams[0] == streams[1]
    for la, lb in zip(*logs):
        assert np.array_equal(la, lb), np.abs(la - lb).max()


@pytest.mark.parametrize("kind", ["chunked_prefill", "preemption"])
def test_streams_unchanged(setup, kind):
    """Any prefill chunking, and preemption under page pressure (evict,
    requeue, re-prefill), emit exactly the streams of a plain run."""
    if kind == "chunked_prefill":
        ref = run_requests(mk_engine(setup, prefill_chunk=4))
        eng = mk_engine(setup, prefill_chunk=16)
        rs = run_requests(eng)
    else:
        prompts = [list(range(1, 9)), list(range(20, 26)),
                   list(range(40, 44))]
        kw = dict(prompts=prompts, max_new=(10, 10, 12),
                  temps=(0.0, 0.6, 0.9), seeds=(0, 3, 7))
        ref = run_requests(mk_engine(setup, page_size=4, prefill_chunk=4),
                           **kw)
        eng = mk_engine(setup, page_size=4, prefill_chunk=4, n_pages=10)
        rs = run_requests(eng, **kw)
        assert eng.sched.n_preemptions > 0
        assert sum(r.preemptions for r in rs) > 0
    for ra, rb in zip(ref, rs):
        assert rb.state is RequestState.FINISHED
        assert ra.out_tokens == rb.out_tokens
    assert eng.pool.used_pages == 0


def test_sampling_reproducible_across_batch_composition(setup):
    eng = mk_engine(setup)
    alone = eng.submit([5, 6, 7], temperature=0.8, seed=11, max_new_tokens=6)
    eng.run()
    eng.assert_no_leaks()
    eng2 = mk_engine(setup)
    eng2.submit([1, 2], max_new_tokens=8)
    eng2.submit([3, 4, 5, 6], max_new_tokens=8, temperature=0.5, seed=2)
    packed = eng2.submit([5, 6, 7], temperature=0.8, seed=11, max_new_tokens=6)
    eng2.run()
    eng2.assert_no_leaks()
    assert alone.out_tokens == packed.out_tokens
    assert alone.slot == packed.slot == -1 and len(alone.out_tokens) == 6


def test_sample_keys_pick_the_stream():
    """Temperature rows depend on their own key only; greedy rows argmax."""
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    temps = np.array([0.0, 1.0, 1.0], np.float32)
    keys = np.array([[0, 0], [1, 2], [1, 2]], np.uint32)
    out = paged_lm._sample(logits, temps, keys)
    assert out[0] == logits[0].argmax()
    row = paged_lm._sample(logits[1:2], temps[1:2], keys[1:2])
    assert out[1] == row[0]
    other = [int(paged_lm._sample(logits[1], 1.0, np.array([k, 5], np.uint32)))
             for k in range(8)]
    assert len(set(other)) > 1                      # the key matters


def test_kernel_attention_read_close(setup):
    logs = []
    for attn_read in ("gather", "kernel"):
        eng = mk_engine(setup, slots=2, max_len=32, attn_read=attn_read,
                        capture_logits=True)
        r = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
        eng.run()
        eng.assert_no_leaks()
        logs.append(np.stack(r.logits_log))
    assert np.allclose(logs[0], logs[1], atol=5e-2), \
        np.abs(logs[0] - logs[1]).max()


def test_backpressure_and_capacity_failure(setup):
    eng = mk_engine(setup, max_queue=2, slots=1, max_len=16,
                    prefill_chunk=4, page_size=4)
    hopeless = eng.submit(list(range(1, 15)), max_new_tokens=10)  # 24 > 16
    assert hopeless.state is RequestState.FAILED
    eng.submit([1, 2], max_new_tokens=2)
    eng.submit([3, 4], max_new_tokens=2)
    eng.submit([5, 6], max_new_tokens=2)              # 1 running + 2 queued
    with pytest.raises(Backpressure):
        eng.submit([7, 8], max_new_tokens=2)
    eng.run()
    eng.assert_no_leaks()


def test_timeout_cancels_request(setup):
    clock = {"t": 0.0}
    eng = mk_engine(setup, clock=lambda: clock["t"])
    slow = eng.submit([1, 2, 3], max_new_tokens=40, timeout=0.5)
    ok = eng.submit([4, 5], max_new_tokens=4)
    for _ in range(40):
        if not eng.sched.has_work():
            break
        eng.step()
        clock["t"] += 0.1
    assert slow.state is RequestState.CANCELLED
    assert slow.error == "timeout"
    assert ok.state is RequestState.FINISHED
    assert eng.metrics.timeouts == 1
    eng.assert_no_leaks()


def test_unsupported_arch_rejected(setup):
    cfg, params = setup
    bad = dataclasses.replace(cfg, kv_quant=True)
    ok, why = api.serve_supported(bad)
    assert not ok and "int8" in why
    with pytest.raises(ValueError):
        ServeEngine(bad, params, slots=2, max_len=32, device="cpu")
    ok, why = api.serve_supported(registry.smoke("mamba2-2.7b"))
    assert not ok and "attention mixers only" in why
    assert api.serve_supported(registry.smoke("dbrx-132b")) == (True, "")


def test_chaos_backpressure_rejects_deterministically(setup):
    plan = chaos.ChaosPlan(3, "t", (chaos.ChaosRule(
        "serve.backpressure", "backpressure", rate=0.5),))
    rejected = [rid for rid in range(12)
                if plan.fire("serve.backpressure", str(rid)) is not None]
    assert rejected and len(rejected) < 12
    eng = mk_engine(setup, chaos=plan)
    got = []
    for rid in range(12):
        try:
            eng.submit([1, 2, 3], max_new_tokens=1)
        except Backpressure:
            got.append(rid)
    assert got == rejected
    eng.run()
    eng.assert_no_leaks()
    done = [r for r in eng.finished if r.state is RequestState.FINISHED]
    assert len(done) == 12 - len(rejected)


def test_chaos_step_delay_trips_straggler_watchdog(setup):
    plan = chaos.ChaosPlan(5, "t", (chaos.ChaosRule(
        "serve.step", "delay", rate=0.3, seconds=30.0),))
    eng = mk_engine(setup, chaos=plan,
                    watchdog=StragglerWatchdog(window=16, threshold=3.0,
                                               min_samples=4))
    run_requests(eng)
    assert eng.metrics.stragglers > 0
    eng2 = mk_engine(setup, chaos=chaos.ChaosPlan(5, "off", ()),
                     watchdog=StragglerWatchdog(window=16, threshold=3.0,
                                                min_samples=4))
    rs = run_requests(eng2)
    assert all(r.state is RequestState.FINISHED for r in rs)


def test_loadgen_retries_the_ports_backpressure(setup):
    """``drive`` catches the port's own Backpressure and resubmits."""
    plan = chaos.ChaosPlan(1, "t", (chaos.ChaosRule(
        "serve.backpressure", "backpressure", rate=0.5),))
    specs = [RequestSpec(arrival=0.001 * i, prompt=[i + 1, i + 2],
                         temperature=0.0, seed=i, max_new_tokens=2)
             for i in range(6)]
    eng = mk_engine(setup, chaos=plan)
    out = drive(eng, specs)
    eng.assert_no_leaks()
    assert out["backpressured"] > 0
    assert len(out["requests"]) == 6
    assert all(r.state is RequestState.FINISHED for r in out["requests"])
