"""Whole models of every LM family on the CPU against the JAX package, and
the serving launcher.

For the smoke reduction of mamba2-2.7b (SSM), dbrx-132b and llama4-scout
(MoE; llama4 with a shared expert), jamba-1.5-large (hybrid: SSM and
attention mixers, MLP and MoE FFNs) and qwen2-1.5b (the attention branch
of the legacy decode, with and without the int8 KV cache), on the
reference's own parameters: ``lm_loss``, ``prefill_logits`` and 8 legacy
``api.decode`` steps, the reference's greedy tokens fed to both.  Float32:
loss, logits 1e-4 and equal greedy tokens.  Bfloat16: loss 1e-2, prefill
logits 5e-2 (the reference's serving bound), decode logits 5e-2, or 1e-1
for the MoE archs: a token whose top-k is a near tie (a margin under 1e-4
in probability occurs in these 8 steps) takes another expert in one
framework after the two round the residual stream differently.

``launch/serve_lm.py`` runs both modes end to end on the CPU, wants the
card when no device is given, and refuses the encoder-decoder arch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import api as jax_api
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.launch import serve_lm
from repro_torch.models import api

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = {  # arch: extra config fields
    "mamba2-2.7b": {}, "dbrx-132b": {}, "llama4-scout-17b-a16e": {},
    "jamba-1.5-large-398b": {}, "qwen2-1.5b": {},
    "qwen2-1.5b+kv_quant": {"kv_quant": True}}
MOE = ("dbrx-132b", "llama4-scout-17b-a16e", "jamba-1.5-large-398b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_model_matches_the_reference(name, dtype):
    arch = name.split("+")[0]
    extra = dict(ARCHS[name], dtype=dtype)
    jcfg = dataclasses.replace(jax_registry.smoke(arch), **extra)
    tcfg = dataclasses.replace(registry.smoke(arch), **extra)
    jp = jax_api.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    f32 = dtype == "float32"

    jl = float(jax.jit(jax_api.train_loss, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    tl = api.train_loss(tp, batch, tcfg, device="cpu").item()
    assert abs(tl - jl) <= (1e-4 if f32 else 1e-2)
    jlog = np.asarray(jax.jit(jax_api.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(tok)}, jcfg))
    tlog = api.prefill(tp, {"tokens": tok}, tcfg, device="cpu").numpy()
    tol = 1e-4 if f32 else 5e-2
    np.testing.assert_allclose(tlog, jlog, rtol=tol, atol=tol)

    decode_tol = 1e-4 if f32 else (1e-1 if arch in MOE else 5e-2)
    jc = jax_api.init_cache(jcfg, 2, 16)
    tc = api.init_cache(tcfg, 2, 16, device="cpu")
    jdecode = jax.jit(jax_api.decode, static_argnums=3)
    t = tok[:, :1]
    for step in range(8):
        jlo, jc = jdecode(jp, jnp.asarray(t), jc, jcfg)
        tlo, tc2 = api.decode(tp, t, tc, tcfg)
        assert tc2 is tc                                   # in place
        jlo = np.asarray(jlo)
        np.testing.assert_allclose(tlo.numpy(), jlo, rtol=decode_tol,
                                   atol=decode_tol, err_msg=f"step {step}")
        if f32:
            assert np.array_equal(tlo.argmax(-1).numpy(), jlo.argmax(-1))
        t = jlo.argmax(-1)[:, None].astype(np.int32)
    assert tc["pos"] == 8 == int(jc["pos"])
    if tcfg.kv_quant:
        assert tc["layers"][0]["k"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "dbrx-132b",
                                  "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b"])
def test_params_cross_both_ways_with_their_dtypes(arch):
    """The reference's MoE and SSM leaves land on the port's parameters in
    their dtypes (router, A_log, D, dt_bias, norm_scale float32) and come
    back out as the same tree (bf16 widened exactly to float32)."""
    cfg = registry.smoke(arch)
    jp = jax.tree.map(np.asarray, jax_api.init_params(
        jax.random.key(0), jax_registry.smoke(arch)))
    tp = convert.params_from_jax(jp, cfg, "cpu")
    named = dict(tp.named_parameters())
    leaves = []
    if any(spec.ffn == "moe" for spec in cfg.pattern()):
        leaves += ["router"]
    if any(spec.mixer == "ssm" for spec in cfg.pattern()):
        leaves += ["A_log", "D", "dt_bias", "norm_scale"]
    for leaf in leaves:
        want = [t.dtype for n, t in named.items() if n.endswith("." + leaf)]
        assert want and set(want) == {torch.float32}, leaf
    back = convert.params_to_numpy(tp, cfg)
    flat_ref, tree_ref = jax.tree.flatten(jp)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        assert np.array_equal(np.asarray(a, np.float32), b)


def test_swa_ring_decode_matches_the_reference():
    """h2o-danube's sliding window, cut to 8: the cache is a ring of 8
    slots, which 12 steps wrap."""
    jcfg = dataclasses.replace(jax_registry.smoke("h2o-danube-1.8b"),
                               dtype="float32", window=8)
    tcfg = dataclasses.replace(registry.smoke("h2o-danube-1.8b"),
                               dtype="float32", window=8)
    assert tcfg.attention_kind == "swa"
    jp = jax_api.init_params(jax.random.key(1), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jc = jax_api.init_cache(jcfg, 2, 24)
    tc = api.init_cache(tcfg, 2, 24, device="cpu")
    assert tc["layers"][0]["k"].shape[2] == 8
    jdecode = jax.jit(jax_api.decode, static_argnums=3)
    t = np.array([[3], [7]], np.int32)
    for step in range(12):
        jlo, jc = jdecode(jp, jnp.asarray(t), jc, jcfg)
        tlo, tc = api.decode(tp, t, tc, tcfg)
        np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        t = np.asarray(jlo).argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen2-1.5b"])
def test_serve_lm_engine_mode_on_the_cpu(arch):
    out = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--tokens", "4", "--cache-len", "64"])
    assert len(out["streams"]) == 4
    assert all(len(s) == 4 for s in out["streams"])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_serve_lm_legacy_mode_on_the_cpu(arch):
    out = serve_lm.main(["--device", "cpu", "--arch", arch, "--legacy",
                         "--batch", "2", "--tokens", "5", "--cache-len",
                         "16"])
    assert out["sequences"].shape == (2, 6) and out["pos"] == 5


def test_serve_lm_refuses_an_ssm_arch_in_engine_mode():
    with pytest.raises(SystemExit, match="--legacy"):
        serve_lm.main(["--device", "cpu", "--arch", "mamba2-2.7b"])


@pytest.mark.parametrize("mode", [[], ["--legacy"]])
def test_serve_lm_refuses_the_encdec_arch(mode):
    """whisper-small decodes against its encoder's cross K/V, which the
    example does not make (it would decode against zeros): both modes
    refuse and name the phase of chip_smoke.py that serves it."""
    with pytest.raises(SystemExit, match="phase 14"):
        serve_lm.main(["--device", "cpu", "--arch", "whisper-small", *mode])


def test_serve_lm_cuts_depth_and_takes_full_widths():
    cfg = serve_lm.build_config("dbrx-132b", full=True, layers=8)
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k) == \
        (8, 6144, 16, 4)
    assert serve_lm.build_config("dbrx-132b", False, None) == \
        registry.smoke("dbrx-132b")
