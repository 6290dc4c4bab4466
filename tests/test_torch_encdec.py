"""The encoder-decoder family (whisper-small's smoke reduction) on the CPU
against the JAX package.

The port's model is built from the reference's own parameters
(``convert.params_from_jax``) and fed the same seeded numpy inputs.  Held:
``sinusoid``, the GELU MLP, ``encode`` on the plain attention path (S 32)
and on the blocked path (S 2,048: the reference's jnp flash, the port's
kernel plain version), ``encdec_loss`` and its grads against ``jax.grad``,
``encdec_prefill``, ``precompute_cross`` and 8 lockstep ``api.decode``
steps (on the precomputed cross K/V and on the zero cross cache of
``api.init_cache``), the parameter conversion both ways and two
``steps.train_step``s.  Tolerances are those of test_torch_decode.py:
float32 loss and logits 1e-4 with equal greedy tokens, grads 2e-4;
bfloat16 loss 1e-2, logits 5e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.models.types import ShapeConfig as JaxShapeConfig
from repro.data import pipeline as jax_pipeline
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps
from repro_torch.models import api, encdec, layers
from repro_torch.optim import adamw

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = "whisper-small"
LOSS = {"float32": 1e-4, "bfloat16": 1e-2}
LOGITS = {"float32": 1e-4, "bfloat16": 5e-2}
GRADS = 2e-4
B, S = 2, 32
# the reference's functions, each compiled once for the whole file
jax_encode = jax.jit(jax_encdec.encode, static_argnums=2)
jax_cross = jax.jit(jax_encdec.precompute_cross, static_argnums=2)
jax_decode = jax.jit(jax_api.decode, static_argnums=3)


def _cfgs(dtype):
    return (dataclasses.replace(jax_registry.smoke(ARCH), dtype=dtype),
            dataclasses.replace(registry.smoke(ARCH), dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jparams = jax_api.init_params(jax.random.key(seed), jcfg)
    return jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    t = min(cfg.decoder_len, s)
    return {"frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
            "dec_tokens": rng.integers(0, cfg.vocab_size, (b, t),
                                       dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t),
                                   dtype=np.int32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("d", [64, 768])
def test_sinusoid_matches_the_reference(d):
    want = np.asarray(jax_encdec.sinusoid(jnp.arange(4096), d))
    got = encdec.sinusoid(torch.arange(4096), d)
    assert got.dtype == torch.float32 and got.shape == (4096, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_the_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jax_layers.init_mlp(jax.random.key(3), jcfg, gated=False)
    tp = layers.MLP(tcfg, gated=False, device="cpu")
    convert.load_module(tp, jax.tree.map(np.asarray, jp))
    assert sorted(n for n, _ in tp.named_parameters()) == ["wi", "wo"]
    x = np.random.default_rng(3).normal(size=(2, 8, tcfg.d_model))
    want = jax_layers.apply_mlp(jp, jnp.asarray(x, jcfg.dtype))
    got = layers.apply_mlp(tp, torch.as_tensor(x).to(getattr(torch, dtype)))
    _close(got.float(), want, LOGITS[dtype])


@pytest.mark.parametrize("b,s", [(B, S), (1, 2048)])
def test_encode_matches_the_reference(b, s, monkeypatch):
    """S 32 takes the plain attention in both packages; S 2,048 takes
    blocked attention in both (seen by spies)."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg, tcfg)
    frames = _batch(tcfg, b, s)["frames"]
    calls = {"jax": 0, "port": 0}
    jax_blocked, port_attention = jax_layers.blocked_attention, \
        flash_ops.attention

    def jax_spy(*a, **k):
        calls["jax"] += 1
        return jax_blocked(*a, **k)

    def port_spy(*a, **k):
        calls["port"] += 1
        return port_attention(*a, **k)

    monkeypatch.setattr(jax_layers, "blocked_attention", jax_spy)
    monkeypatch.setattr(flash_ops, "attention", port_spy)
    want = jax_encode(jp, jnp.asarray(frames), jcfg)
    with torch.no_grad():
        got = encdec.encode(tp, torch.from_numpy(frames), tcfg)
    blocked = s > 1024
    # the reference traces its scanned block once; the port runs each layer
    assert calls == {"jax": int(blocked),
                     "port": tcfg.n_encoder_layers * blocked}
    assert got.shape == (b, s, tcfg.d_model)
    _close(got, want, LOGITS["float32"])


def test_encode_refuses_the_frame_counts_the_reference_refuses():
    """Past 1,024 frames the blocked path wants S % 512 == S % 1,024 == 0
    in both packages: whisper's own 1,500 frames are refused."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg, tcfg)
    frames = _batch(tcfg, 1, 1500)["frames"]
    with pytest.raises(AssertionError):
        jax_encdec.encode(jp, jnp.asarray(frames), jcfg)
    with pytest.raises(AssertionError), torch.no_grad():
        encdec.encode(tp, torch.from_numpy(frames), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_prefill_match_the_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(tcfg)
    want = float(jax.jit(jax_api.train_loss, static_argnums=2)(
        jp, _jnp(batch), jcfg))
    got = api.train_loss(tp, batch, tcfg, device="cpu").item()
    assert abs(got - want) <= LOSS[dtype]
    prompt = {k: batch[k] for k in ("frames", "dec_tokens")}
    want = jax.jit(jax_api.prefill, static_argnums=2)(jp, _jnp(prompt), jcfg)
    got = steps.prefill_step(tp, prompt, tcfg, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (B, tcfg.vocab_size)
    _close(got, want, LOGITS[dtype])


def test_loss_grads_match_jax_grad():
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg, tcfg, seed=1)
    batch = _batch(tcfg, seed=1)
    want = jax.jit(jax.grad(jax_api.train_loss), static_argnums=2)(
        jp, _jnp(batch), jcfg)
    names, leaves = zip(*tp.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    loss = api.train_loss(tp, batch, tcfg, device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    got = convert.params_to_numpy(dict(zip(names, grads)), tcfg)
    flat_want, tree_want = jax.tree.flatten(want)
    flat_got, tree_got = jax.tree.flatten(got)
    assert tree_want == tree_got
    for path, w, g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                          flat_want, flat_got):
        assert np.abs(g).max() > 0, path[0]
        _close(g, w, GRADS, jax.tree_util.keystr(path[0]))


@pytest.mark.parametrize("cross", ["precomputed", "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_reference(dtype, cross):
    """8 lockstep steps, the reference's greedy tokens fed to both, on the
    cross K/V of one encoder output or on ``init_cache``'s zeros."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg, seed=2)
    batch = _batch(tcfg, seed=2)
    jc = jax_api.init_cache(jcfg, B, 16)
    tc = api.init_cache(tcfg, B, 16, device="cpu")
    assert tc["cross_k"].shape == (tcfg.n_decoder_layers, B,
                                   tcfg.n_kv_heads, tcfg.cross_len,
                                   tcfg.head_dim)
    assert not tc["cross_k"].any()
    if cross == "precomputed":
        jk, jv = jax_cross(
            jp, jax_encode(jp, jnp.asarray(batch["frames"]), jcfg), jcfg)
        with torch.no_grad():
            enc_out = encdec.encode(tp, torch.from_numpy(batch["frames"]),
                                    tcfg)
        tk, tv = encdec.precompute_cross(tp, enc_out, tcfg)
        assert tk.shape == jk.shape and tk.dtype == getattr(torch, dtype)
        _close(tk.float(), jk, LOGITS[dtype])
        _close(tv.float(), jv, LOGITS[dtype])
        jc = dict(jc, cross_k=jk, cross_v=jv)
        tc["cross_k"], tc["cross_v"] = tk, tv
    t = batch["dec_tokens"][:, :1]
    for step in range(8):
        jlo, jc = jax_decode(jp, jnp.asarray(t), jc, jcfg)
        tlo, tc2 = steps.serve_step(tp, t, tc, tcfg)
        assert tc2 is tc                                   # in place
        jlo = np.asarray(jlo)
        _close(tlo, jlo, LOGITS[dtype], f"step {step}")
        if dtype == "float32":
            assert np.array_equal(tlo.argmax(-1).numpy(), jlo.argmax(-1))
        t = jlo.argmax(-1)[:, None].astype(np.int32)
    assert tc["pos"] == 8 == int(jc["pos"])
    _close(tc["self_k"].float(), jc["self_k"], LOGITS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_both_ways_leaf_for_leaf(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jax.tree.map(np.asarray,
                      jax_api.init_params(jax.random.key(4), jcfg))
    tp = convert.params_from_jax(jp, tcfg, "cpu")
    assert isinstance(tp, encdec.EncDec)
    assert len(tp.encoder) == tcfg.n_encoder_layers
    assert len(tp.decoder) == tcfg.n_decoder_layers
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(a.size for a in jax.tree.leaves(jp))
    back = convert.params_to_numpy(tp, tcfg)
    flat_ref, tree_ref = jax.tree.flatten(jp)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        assert np.array_equal(np.asarray(a, np.float32), b)
    short = dataclasses.replace(tcfg, n_decoder_layers=1)
    with pytest.raises(ValueError, match="decoder"):
        convert.params_from_jax(jp, short, "cpu")


def test_train_steps_match_the_reference():
    """Two AdamW steps on synthetic_batch: loss and grad norm each step,
    every parameter after the second."""
    jcfg, tcfg = _cfgs("float32")
    jp, tp = _params(jcfg, tcfg, seed=5)
    shape = JaxShapeConfig("t", "train", S, B)
    batches = [jax_pipeline.synthetic_batch(jcfg, shape, 0, step)
               for step in range(2)]
    opt = jax_adamw.AdamWConfig(moment_dtype=jcfg.adam_dtype,
                                warmup_steps=1)
    jstep = jax.jit(lambda st, b: jax_steps.train_step(st, b, jcfg, opt))
    jstate = jax_adamw.init_state(jp, opt)
    topt = dataclasses.replace(steps.make_optimizer(tcfg), warmup_steps=1)
    tstate = adamw.init_state(tp, topt)
    for batch in batches:
        jstate, jm = jstep(jstate, batch)
        tstate, tm = steps.train_step(tstate, batch, tcfg, topt,
                                      device="cpu")
        _close(tm["loss"].item(), float(jm["loss"]), LOSS["float32"])
        _close(tm["grad_norm"].item(), float(jm["grad_norm"]),
               LOSS["float32"])
    got = convert.params_to_numpy(tstate["params"], tcfg)
    for w, g in zip(jax.tree.leaves(jstate["params"]), jax.tree.leaves(got)):
        _close(g, w, LOSS["float32"])
