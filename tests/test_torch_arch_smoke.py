"""Every registry arch in the port, the twin of tests/test_arch_smoke.py.

Smoke reductions on the CPU: one ``steps.train_step`` (finite loss,
nonzero grads), three lockstep ``api.decode`` steps, and prefill logits
held against the reference's on the reference's own weights (float32,
1e-4).  Full configs on the meta device, nothing allocated:
``api.abstract_params`` counts exactly the reference's parameters, and
``api.input_specs`` / ``api.abstract_cache`` give the reference's names,
shapes and dtypes in every arch x ``SHAPES`` cell (the port's per-layer
cache list stacked into the reference's per-pattern-position leaves; its
``pos`` is a host int where the reference's is an int32 scalar).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import api as jax_api
from repro.models.types import SHAPES as JAX_SHAPES
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models.types import SHAPES
from repro_torch.optim import adamw

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = registry.list_archs()


def smoke_batch(cfg, rng, b=2, s=32):
    """tests/test_arch_smoke.py's batch, as numpy (frames and embeddings
    float32; each model casts them to its dtype)."""
    if cfg.family == "encdec":
        t = min(cfg.decoder_len, 16)
        return {
            "frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
            "dec_tokens": rng.integers(0, cfg.vocab_size, (b, t),
                                       dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t),
                                   dtype=np.int32),
        }
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return batch


def _init(cfg, seed):
    return api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    # one gradient of one loss, as the reference's smoke step takes it
    # (accumulation is held against the reference in test_torch_train.py)
    cfg = dataclasses.replace(registry.smoke(arch), accum_steps=1)
    params = _init(cfg, 0)
    before = {n: p.clone() for n, p in params.named_parameters()}
    opt = steps.make_optimizer(cfg)
    state = adamw.init_state(params, opt)
    batch = smoke_batch(cfg, np.random.default_rng(0))
    state, metrics = steps.train_step(state, batch, cfg, opt, device="cpu")
    loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
    assert np.isfinite(loss) and loss > 0, arch
    assert np.isfinite(gnorm) and gnorm > 0, arch
    moved = [not torch.equal(p, before[n])
             for n, p in state["params"].named_parameters()]
    assert any(moved), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_steps(arch):
    cfg = registry.smoke(arch)
    rng = np.random.default_rng(1)
    params = _init(cfg, 1)
    b, s = 2, 64
    cache = api.init_cache(cfg, b, s, device="cpu")
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (b, 1), dtype=np.int32)
        logits, cache = api.decode(params, tokens, cache, cfg)
        assert logits.shape == (b, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), (arch, i)
    assert cache["pos"] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_matches_the_reference(arch):
    jcfg = dataclasses.replace(jax_registry.smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    jp = jax_api.init_params(jax.random.key(2), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batch = smoke_batch(tcfg, np.random.default_rng(2))
    batch.pop("labels")
    want = np.asarray(jax.jit(jax_api.prefill, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = api.prefill(tp, batch, tcfg, device="cpu")
    assert got.shape == (2, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# FULL configs: shapes only, on the meta device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    cfg = registry.get(arch)
    params = api.abstract_params(cfg)
    assert all(p.is_meta for p in params.parameters())
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax_api.abstract_params(jax_registry.get(arch))))
    assert sum(p.numel() for p in params.parameters()) == want
    if arch == "whisper-small":
        assert want == 277_940_736


def _spec(x) -> tuple:
    """(shape, dtype name) of a reference stand-in or a port meta tensor;
    the port's host-int ``pos`` stands for the reference's int32 scalar."""
    if isinstance(x, int):
        return (), "int32"
    if isinstance(x, torch.Tensor):
        assert x.is_meta
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), str(x.dtype)


def _reference_layout(cache: dict, cfg) -> dict:
    """The port's cache in the reference's layout: the LM's per-layer list
    stacked into one dict a pattern position (``[n_groups, ...]``)."""
    if cfg.family == "encdec":
        return {k: _spec(v) for k, v in cache.items()}
    layers = [{k: _spec(v) for k, v in c.items()} for c in cache["layers"]]
    stacked = []
    for p_idx in range(cfg.period):
        group = layers[p_idx::cfg.period]
        assert all(g == group[0] for g in group)
        stacked.append({k: ((len(group),) + shape, dt)
                        for k, (shape, dt) in group[0].items()})
    return {"pos": _spec(cache["pos"]), "layers": tuple(stacked)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_cache_match_the_reference(arch, shape):
    cfg, jcfg = registry.get(arch), jax_registry.get(arch)
    tshape, jshape = SHAPES[shape], JAX_SHAPES[shape]
    got = {k: _spec(v) for k, v in api.input_specs(cfg, tshape).items()}
    want = {k: _spec(v) for k, v in jax_api.input_specs(jcfg, jshape).items()}
    assert got == want
    if tshape.kind == "decode":
        cache = api.abstract_cache(cfg, tshape)
        want = jax.tree.map(_spec, jax_api.abstract_cache(jcfg, jshape))
        assert _reference_layout(cache, cfg) == want
