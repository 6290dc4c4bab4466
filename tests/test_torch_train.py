"""The port's training path on the CPU against the JAX package (smoke
arch: 2 layers, d 64, 4/2 heads of 16, vocab 512).

The same seeded numpy inputs and the reference's own initial parameters
(``api.init_params``, carried across by ``convert.params_from_jax``) go
through both packages: blocked attention's forward and custom-VJP grads,
``lm_loss`` and ``prefill_logits``, and whole ``train_step``s (loss, grad
norm and every parameter after each update).  The data pipeline must give
the reference's batches bit for bit; the checkpointer and the crash ->
resume history are held inside the port, bitwise, as
tests/test_fault_tolerance.py holds the reference's.

Tolerances: float32 2e-4 for attention grads (tests/test_layers.py's
bound), 1e-5 for losses, logits and grad norms (summation order); bfloat16
5e-2 on logits (the reference's serving bound) and 1e-2 on losses and
grad norms.  After each update each leaf of the AdamW moments agrees in
relative norm, ||port - ref|| / ||ref||, to 1e-4 in float32, 2e-2 with
int8 error feedback (a gradient on a rounding edge lands one quantum
apart) and 5e-2 in bfloat16 (bf16 gradients, summed in other orders);
the parameters agree to 2e-6 in float32 wherever the update is well
conditioned: sqrt(v_hat) > 1e-4, a gradient far above both eps and the
frameworks' float32 gradient differences (~1e-7).  Below that, AdamW's
m_hat / (sqrt(v_hat) + eps) turns such a difference into a change of up
to lr, so there the bound is 2 lr a step.  bf16 gradients differ by
roundings of their partial sums, which flip the sign of the first update
of a few elements: in bfloat16, 99.9% of the well-conditioned elements
agree to one bf16 ulp (2^-7 relative) and all to 2 lr a step plus
one ulp.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.data import pipeline as jax_pipeline
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models.types import ShapeConfig as JaxShapeConfig
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_compression
from repro_torch.checkpoint import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.launch import steps, train_lm
from repro_torch.models import layers, lm
from repro_torch.models.types import ShapeConfig
from repro_torch.optim import adamw, compression
from repro_torch.runtime.fault_tolerance import SimulatedFailure, TrainDriver

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ATTN_GRAD = dict(rtol=2e-4, atol=2e-4)
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = {"float32": F32, "bfloat16": dict(rtol=5e-2, atol=5e-2)}
LOSS = {"float32": F32, "bfloat16": dict(rtol=1e-2, atol=1e-2)}
PARAMS = {"float32": dict(rtol=0, atol=2e-6, share=1.0),
          "bfloat16": dict(rtol=2.0**-7, atol=1e-6, share=0.999)}
MOMENTS = {"float32": 1e-4, "error_feedback": 2e-2, "bfloat16": 5e-2}
B, S = 4, 64
OPT = dict(warmup_steps=1)          # full lr from the first step


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jax_registry.smoke("qwen2-1.5b"),
                                dtype=dtype, **kw),
            dataclasses.replace(registry.smoke("qwen2-1.5b"), dtype=dtype,
                                **kw))


def _params(jcfg, tcfg, seed=0):
    jparams = jax_api.init_params(jax.random.key(seed), jcfg)
    return jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _batch(cfg, step=0):
    return jax_pipeline.synthetic_batch(cfg, JaxShapeConfig("t", "train", S,
                                                            B), 0, step)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# blocked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,triangular", [(None, False), (24, False),
                                               (None, True)])
def test_blocked_attention_forward_and_grads(window, triangular):
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, h, 64, 16)).astype(np.float32)
               for h in (4, 2, 2))
    kw = dict(causal=True, window=window, q_chunk=16, k_chunk=32,
              triangular=triangular)

    def jax_loss(q, k, v):
        return jnp.sum(jnp.sin(jax_layers.blocked_attention(q, k, v, **kw)))

    want_y = jax_layers.blocked_attention(q, k, v, **kw)
    want_g = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    y = layers.blocked_attention(*args, **kw)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **F32)
    for a, w in zip(args, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   **ATTN_GRAD)


# ---------------------------------------------------------------------------
# loss and prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["reference", "blocked"])
def test_lm_loss_and_prefill_logits(dtype, attn_impl):
    jcfg, tcfg = _cfgs(dtype)
    jparams, tparams = _params(jcfg, tcfg)
    batch = _batch(jcfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax_lm.lm_loss(jparams, batch, jcfg, attn_impl=attn_impl)
    got = lm.lm_loss(tparams, tbatch, tcfg, attn_impl=attn_impl)
    np.testing.assert_allclose(got.item(), float(want), **LOSS[dtype])
    want = jax_lm.prefill_logits(jparams, batch, jcfg, attn_impl=attn_impl)
    with torch.no_grad():
        got = lm.prefill_logits(tparams, tbatch, tcfg, attn_impl=attn_impl)
    assert got.dtype == torch.float32 and got.shape == (B, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS[dtype])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _jax_run(jcfg, jparams, batches, ef):
    opt = jax_adamw.AdamWConfig(moment_dtype=jcfg.adam_dtype, **OPT)
    comp = jax_compression.ErrorFeedback()

    @jax.jit
    def step(state, residual, batch):
        box = {"res": residual}

        def transform(g):
            deq, box["res"] = comp.compress(g, residual)
            return deq

        state, metrics = jax_steps.train_step(state, batch, jcfg, opt,
                                              transform if ef else None)
        return state, box["res"], metrics

    state = jax_adamw.init_state(jparams, opt)
    residual = comp.init(jparams)
    out = []
    for batch in batches:
        state, residual, metrics = step(state, residual, batch)
        out.append(([_f32(state[k]) for k in ("params", "m", "v")],
                    float(metrics["loss"]), float(metrics["grad_norm"])))
    return out


def _port_run(tcfg, tparams, batches, ef):
    opt = steps.make_optimizer(tcfg)
    opt = dataclasses.replace(opt, **OPT)
    comp = compression.ErrorFeedback(period=tcfg.period)
    state = adamw.init_state(tparams, opt)
    box = {}

    def transform(g):
        if "res" not in box:
            box["res"] = comp.init(g)
        deq, box["res"] = comp.compress(g, box["res"])
        return deq

    out = []
    for batch in batches:
        state, metrics = steps.train_step(state, batch, tcfg, opt,
                                          transform if ef else None,
                                          device="cpu")
        out.append(([convert.params_to_numpy(state[k], tcfg)
                     for k in ("params", "m", "v")],
                    metrics["loss"].item(), metrics["grad_norm"].item()))
    assert state["step"].item() == len(batches)
    return out


@pytest.mark.parametrize("dtype,accum,ef,n_steps", [
    ("float32", 1, False, 3),
    ("float32", 2, False, 3),
    ("float32", 1, True, 3),
    ("bfloat16", 1, False, 1),
    ("bfloat16", 2, False, 1),
])
def test_train_steps_match_the_reference(dtype, accum, ef, n_steps):
    """Held after step 1 and after the last: loss, grad norm, moments and
    every parameter."""
    jcfg, tcfg = _cfgs(dtype, accum_steps=accum, attn_impl="blocked")
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    batches = [_batch(jcfg, step) for step in range(n_steps)]
    want = _jax_run(jcfg, jparams, batches, ef)
    got = _port_run(tcfg, tparams, batches, ef)
    lr = dataclasses.replace(steps.make_optimizer(tcfg), **OPT).lr
    for step, ((wt, wl, wg), (gt, gl, gg)) in enumerate(zip(want, got), 1):
        np.testing.assert_allclose(gl, wl, **LOSS[dtype])
        np.testing.assert_allclose(gg, wg, **LOSS[dtype])
        assert [jax.tree.structure(t) for t in wt] == \
            [jax.tree.structure(t) for t in gt]
        moments_tol = MOMENTS["error_feedback" if ef else dtype]
        for tree in (1, 2):                  # m, v
            for w, g in zip(jax.tree.leaves(wt[tree]),
                            jax.tree.leaves(gt[tree])):
                assert np.linalg.norm(g - w) <= \
                    moments_tol * np.linalg.norm(w)
        bc2 = 1.0 - 0.95 ** step
        for w, g, v in zip(*(jax.tree.leaves(t) for t in
                             (wt[0], gt[0], wt[2]))):
            well = np.sqrt(v / bc2) > 1e-4
            tol = PARAMS[dtype]
            rounding = tol["atol"] + tol["rtol"] * np.abs(w)
            close = np.abs(g - w) <= rounding
            assert not well.any() or close[well].mean() >= tol["share"]
            assert (np.abs(g - w) <= 2 * lr * step + rounding).all()


def _snapshot(state) -> dict:
    """The state's parameters and moments, copied, by the port's names."""
    return {"params": {n: p.detach().clone()
                       for n, p in state["params"].named_parameters()},
            "m": {n: t.clone() for n, t in state["m"].items()},
            "v": {n: t.clone() for n, t in state["v"].items()}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_in_slices_is_bit_identical(monkeypatch, moments):
    """A leaf larger than ``adamw.UPDATE_CHUNK`` is updated a slice of its
    elements at a time: over two steps the same bits as the whole leaf at
    once (each element's arithmetic is unchanged), and after one step the
    reference's update to float32 rounding (bf16 moments: the same f32
    values rounded once, so at most one bf16 ulp, 2^-7 of the value,
    apart)."""
    jcfg, tcfg = _cfgs("float32", adam_dtype=moments)
    jparams, tparams = _params(jcfg, tcfg, seed=2)
    opt = dataclasses.replace(steps.make_optimizer(tcfg), **OPT)
    rng = np.random.default_rng(3)
    grads = {n: torch.from_numpy(rng.normal(scale=1e-2, size=p.shape)
                                 .astype(np.float32))
             for n, p in tparams.named_parameters()}
    assert max(g.numel() for g in grads.values()) > 1000
    runs = []
    for chunk in (adamw.UPDATE_CHUNK, 1000):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        state = adamw.apply_updates(
            adamw.init_state(copy.deepcopy(tparams), opt), grads, opt)
        first = _snapshot(state)
        runs.append((adamw.apply_updates(state, grads, opt), first))
    for a, b in zip(*(_leaves(state) for state, _ in runs)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    jopt = dataclasses.replace(jax_steps.make_optimizer(jcfg), **OPT)
    jstate = jax_adamw.apply_updates(jax_adamw.init_state(jparams, jopt),
                                     convert.params_to_numpy(grads, tcfg),
                                     jopt)
    first = runs[1][1]
    moment_tol = dict(rtol=2.0**-7 if moments == "bfloat16" else 1e-6,
                      atol=0)
    for k, tol in (("params", dict(rtol=1e-6, atol=1e-9)),
                   ("m", moment_tol), ("v", moment_tol)):
        for w, g in zip(jax.tree.leaves(_f32(jstate[k])), jax.tree.leaves(
                convert.params_to_numpy(first[k], tcfg))):
            np.testing.assert_allclose(g, w, **tol)


def test_error_feedback_matches_the_reference_on_equal_grads():
    """One int8 scale per reference leaf (all layers of a pattern position
    share it); quantization and residuals equal the reference's."""
    jcfg, tcfg = _cfgs("float32")
    jparams, _ = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), jparams)
    tgrads = convert.params_from_jax(grads, tcfg, "cpu")
    tgrads = {n: p.detach() for n, p in tgrads.named_parameters()}
    comp, jcomp = compression.ErrorFeedback(tcfg.period), \
        jax_compression.ErrorFeedback()
    res, jres = comp.init(tgrads), jcomp.init(grads)
    for _ in range(2):
        deq, res = comp.compress(tgrads, res)
        jdeq, jres = jcomp.compress(grads, jres)
    tree = lm.LM(tcfg, device="cpu")
    with torch.no_grad():
        for n, p in tree.named_parameters():
            p.copy_(res[n])
    for a, b in zip(jax.tree.leaves(_f32(jres)),
                    jax.tree.leaves(convert.params_to_numpy(tree, tcfg))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, dict(warmup_steps=10, total_steps=50,
                                         lr=1e-3, min_lr_ratio=0.2)])
def test_schedule(kw):
    jopt, topt = jax_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in (0, 1, 5, 10, 11, 30, 49, 50, 51, 100, 101, 5000, 10_000,
                 20_000):
        want = jax_adamw.schedule(jopt, jnp.int32(step))
        got = adamw.schedule(topt, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=0)


# ---------------------------------------------------------------------------
# data, checkpoints, crash -> resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-small",
                                  "internvl2-76b"])
def test_synthetic_batch_is_the_references(arch):
    shape = ShapeConfig("t", "train", 48, 3)
    jshape = JaxShapeConfig("t", "train", 48, 3)
    for step in (0, 7):
        want = jax_pipeline.synthetic_batch(jax_registry.smoke(arch), jshape,
                                            5, step)
        got = pipeline.synthetic_batch(registry.smoke(arch), shape, 5, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_runahead_loader_puts_batches_on_the_device():
    cfg = registry.smoke("qwen2-1.5b")
    shape = ShapeConfig("t", "train", 16, 2)
    loader = train_lm.make_loader(cfg, shape, "cpu", depth=2)
    try:
        for step in (0, 1, 3):
            got = loader.get(step)
            want = pipeline.synthetic_batch(cfg, shape, 0, step)
            for k in want:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        loader.close()


def _state(dtype, seed=0):
    cfg = dataclasses.replace(registry.smoke("qwen2-1.5b"), dtype=dtype)
    opt = steps.make_optimizer(cfg)
    return cfg, opt, train_lm.init_state(cfg, opt, "cpu", seed=seed)


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


def _leaves(state):
    return ([p for _, p in state["params"].named_parameters()]
            + list(state["m"].values()) + list(state["v"].values())
            + [state["step"]])


def test_checkpoint_round_trip_keeps_bf16_bits(tmp_path):
    cfg, opt, state = _state("bfloat16")
    state, _ = steps.train_step(state, _batch(cfg), cfg, opt, device="cpu")
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3):
        ck.save(step, state)                # async
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    manifest = (tmp_path / "step_3" / "manifest_0.json").read_text()
    assert '"bfloat16"' in manifest and '"float32"' in manifest
    _, _, target = _state("bfloat16", seed=1)
    restored = ck.restore(3, target)
    assert restored["params"] is target["params"]    # loaded in place
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert state["params"].embed.dtype == torch.bfloat16


def _driver(ck, cfg, opt):
    shape = ShapeConfig("t", "train", 32, 2)
    step_fn = functools.partial(steps.train_step, cfg=cfg, opt=opt,
                                device="cpu")
    return TrainDriver(step_fn,
                       lambda step: pipeline.synthetic_batch(cfg, shape, 0,
                                                             step),
                       ck, checkpoint_every=2)


def test_crash_resume_reproduces_bitwise_history(tmp_path):
    """Crash mid-step -> resume() from the latest durable checkpoint replays
    the tail of the metrics history bit for bit, and the final state
    equals the uninterrupted run's exactly."""
    cfg, opt, state = _state("float32")
    ref_state, ref_hist = _driver(Checkpointer(tmp_path / "ref"), cfg,
                                  opt).run(state, 6)
    assert [h["step"] for h in ref_hist] == list(range(6))

    driver = _driver(Checkpointer(tmp_path / "crash"), cfg, opt)
    with pytest.raises(SimulatedFailure):
        driver.run(_state("float32")[2], 6, fail_at=3)
    resumed_state, hist = driver.resume(_state("float32", seed=9)[2], 6)
    start = hist[0]["step"]
    assert 0 < start <= 3 and hist[-1]["step"] == 5
    assert hist == ref_hist[start:]          # bitwise: dict == on floats
    for a, b in zip(_leaves(ref_state), _leaves(resumed_state)):
        assert torch.equal(_bits(a), _bits(b))


def test_resume_without_checkpoint_raises(tmp_path):
    cfg, opt, _ = _state("float32")
    with pytest.raises(RuntimeError, match="no checkpoint"):
        _driver(Checkpointer(tmp_path), cfg, opt).resume(None, 4)


def test_train_lm_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The entry point's wiring (loader, driver, checkpoints) at the smoke
    width instead of --reduced's ~100M parameters."""
    monkeypatch.setattr(train_lm, "build_config",
                        lambda arch, reduced: registry.smoke(arch))
    hist = train_lm.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                          "--seq", "32", "--ckpt-dir", str(tmp_path),
                          "--checkpoint-every", "2"])
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "steps=4" in out and "ckpts=[2, 4]" in out
