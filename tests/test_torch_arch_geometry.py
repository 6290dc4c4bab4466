"""Five archs at their own head geometry, held against the reference.

``registry.smoke`` gives every arch 4 query heads over 2 KV heads of 16,
so the smoke tests (tests/test_torch_arch_smoke.py) never run phi3-medium
(H 40 / Hkv 10), internlm2 (16 / 8), h2o-danube (32 / 8 at D 80, sliding
window), llama4-scout (40 / 8, top-1 routing plus a shared expert) or
internvl2 (64 / 8, embeddings input, bf16 AdamW moments, 4 microbatches)
at the geometry they have on the card.  Here each keeps its heads, head
width, attention kind, routing, input mode, moment dtype and
accumulation, and only its scale is cut: d_model 128, d_ff 256, vocab
512, 2 layers, 4 experts, danube's window 32 (so that S 64 masks).

On the reference's weights carried across by ``checkpoint/convert.py``,
in float32: prefill logits (1e-4), one ``train_step`` (loss, grad norm,
moments, every parameter, the embedding table's update included) against
``repro.launch.steps.train_step``, lockstep decode steps (1e-4; danube's
run wraps its ring), and for phi3 and llama4 the ``ServeEngine``'s greedy
tokens against the reference's engine.  Attention runs blocked (the flash
op, here its plain version), as the card's path does past 1,024 tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.optim import adamw as jax_adamw
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.serve import ServeEngine

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = ["phi3-medium-14b", "internlm2-1.8b", "h2o-danube-1.8b",
         "llama4-scout-17b-a16e", "internvl2-76b"]
# what each reduction keeps from the published config
KEPT = ("n_heads", "n_kv_heads", "d_head", "attention_kind", "top_k",
        "n_shared_experts", "input_mode", "adam_dtype", "accum_steps",
        "tie_embeddings", "rope_theta", "capacity_factor")
B, S = 4, 64
F32 = dict(rtol=1e-4, atol=1e-4)
OPT = dict(warmup_steps=1)          # full lr from the first step
# one train step's moments, as a norm relative to the reference's: f32
# moments differ by summation order; bf16 ones are the same f32 values
# rounded once each, so a value near a rounding boundary may land one bf16
# ulp (2^-8 relative) away.  An MoE arch's grads carry the same ulp: both
# packages round each expert input to bf16, also in a float32 model
# (models/moe.py in each), so an input whose f32 value differs by summation
# order across a rounding boundary moves by a bf16 ulp (the bound
# tests/test_torch_family_mesh.py holds MoE moments to)
MOMENTS = {"float32": 1e-4, "bfloat16": 2.0 ** -8, "moe": 2.0 ** -8}


def _cut(cfg):
    cut = dict(d_model=128, d_ff=256, vocab_size=512, n_layers=2,
               dtype="float32", attn_impl="blocked")
    if cfg.attention_kind == "swa":
        cut["window"] = 32
    if cfg.n_experts:
        cut["n_experts"] = 4
    return dataclasses.replace(cfg, name=cfg.name + "-geometry", **cut)


@functools.cache
def _reference(arch):
    """(reference cfg, the reference's params as numpy, port cfg)."""
    jcfg = _cut(jax_registry.get(arch))
    jparams = jax_api.init_params(jax.random.key(3), jcfg)
    return jcfg, jax.tree.map(np.asarray, jparams), _cut(registry.get(arch))


def _pair(arch):
    """Fresh reference params and the port's copy of them."""
    jcfg, np_params, tcfg = _reference(arch)
    return (jcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            convert.params_from_jax(np_params, tcfg, "cpu"))


def _batch(cfg, seed, train=False):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)
    if train:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S),
                                       dtype=np.int32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cut_keeps_the_published_geometry(arch):
    full, (jcfg, _, tcfg) = registry.get(arch), _reference(arch)
    for name in KEPT:
        assert getattr(tcfg, name) == getattr(full, name), name
        assert getattr(jcfg, name) == getattr(full, name), name
    assert tcfg.head_dim == full.head_dim
    assert tcfg.n_heads * tcfg.head_dim > tcfg.d_model   # wider than d
    if full.attention_kind == "swa":
        assert tcfg.window < S


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch)
    batch = _batch(tcfg, 0)
    want = np.asarray(jax.jit(jax_api.prefill, static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = api.prefill(tparams, batch, tcfg, device="cpu")
    assert got.shape == (B, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """One step with the arch's own accumulation and moment dtype: loss
    and grad norm, the moments m = (1 - b1) g and v = (1 - b2) g^2 (the
    clipped grads, leaf by leaf), and every updated parameter."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    batch = _batch(tcfg, 1, train=True)
    jopt = dataclasses.replace(jax_steps.make_optimizer(jcfg), **OPT)
    jstate, jm = jax.jit(jax_steps.train_step, static_argnums=(2, 3))(
        jax_adamw.init_state(jparams, jopt),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, jopt)
    opt = dataclasses.replace(steps.make_optimizer(tcfg), **OPT)
    state, tm = steps.train_step(adamw.init_state(tparams, opt), batch,
                                 tcfg, opt, device="cpu")
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-4, atol=1e-6)
    mdt = getattr(torch, tcfg.adam_dtype)
    assert all(t.dtype == mdt for t in state["m"].values())
    want = [_f32(jstate[k]) for k in ("params", "m", "v")]
    got = [convert.params_to_numpy(state[k], tcfg)
           for k in ("params", "m", "v")]
    assert [jax.tree.structure(t) for t in want] == \
        [jax.tree.structure(t) for t in got]
    for tree in (1, 2):
        for w, g in zip(jax.tree.leaves(want[tree]),
                        jax.tree.leaves(got[tree])):
            assert np.linalg.norm(g - w) <= MOMENTS[
                "moe" if tcfg.n_experts else tcfg.adam_dtype] \
                * np.linalg.norm(w)
    # a parameter moves by lr * (m_hat / (sqrt(v_hat) + eps) + wd p):
    # where v is tiny that ratio is ill-conditioned, so there the update
    # is held to its size only
    for w, g, v in zip(*(jax.tree.leaves(t) for t in
                         (want[0], got[0], want[2]))):
        well = np.sqrt(v / 0.05) > 1e-4
        close = np.abs(g - w) <= 2e-6 + 1e-5 * np.abs(w)
        assert close[well].all()
        assert (np.abs(g - w) <= 2 * opt.lr + 2e-6).all()
    if tcfg.input_mode == "embeddings":
        # embeds bypass the token table: no gradient, so its moments stay
        # zero and weight decay alone moves it, p (1 - lr wd), as in the
        # reference
        assert not want[1]["embed"].any() and not got[1]["embed"].any()
        embed = np.asarray(jparams["embed"], np.float32)
        shrink = embed * (1 - opt.lr * opt.weight_decay)
        np.testing.assert_allclose(got[0]["embed"], shrink, rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(want[0]["embed"], shrink, rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch):
    """Lockstep decode from an empty cache: 3 steps, and for danube 40, so
    that its 32-slot ring wraps and the window drops the oldest keys."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    n = 40 if tcfg.attention_kind == "swa" else 3
    rng = np.random.default_rng(2)
    jcache = jax_api.init_cache(jcfg, 2, S)
    cache = api.init_cache(tcfg, 2, S, device="cpu")
    if tcfg.attention_kind == "swa":
        assert cache["layers"][0]["k"].shape[2] == tcfg.window
    step = jax.jit(jax_api.decode, static_argnums=3)
    for i in range(n):
        tokens = rng.integers(0, tcfg.vocab_size, (2, 1), dtype=np.int32)
        want, jcache = step(jparams, jnp.asarray(tokens), jcache, jcfg)
        got, cache = api.decode(tparams, tokens, cache, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=f"step {i}")
    assert cache["pos"] == n


PROMPTS = [list(range(1, 6)), list(range(20, 41)), [40, 41]]


@pytest.mark.parametrize("arch", ["phi3-medium-14b",
                                  "llama4-scout-17b-a16e"])
def test_engine_matches_the_reference(arch):
    """Greedy requests through both engines, the port's reading its pages
    through the paged kernel's path (its plain version here), the
    reference's through its gather read: equal tokens, logits 1e-4."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    kw = dict(slots=4, max_len=48, page_size=8, prefill_chunk=8,
              capture_logits=True)
    runs = []
    for eng in (JaxServeEngine(jcfg, jparams, attn_read="gather", **kw),
                ServeEngine(tcfg, tparams, attn_read="kernel", device="cpu",
                            **kw)):
        rs = [eng.submit(p, max_new_tokens=m)
              for p, m in zip(PROMPTS, (6, 5, 8))]
        eng.run()
        eng.assert_no_leaks()
        runs.append([(r.out_tokens, np.stack(r.logits_log)) for r in rs])
    for (jt, jl), (tt, tl) in zip(*runs):
        assert tt == jt
        np.testing.assert_allclose(tl, jl, **F32)
