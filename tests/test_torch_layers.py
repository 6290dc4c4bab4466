"""The port's serving layers against ``repro.models.layers`` on the CPU.

Parameters come from the reference's ``init_*`` functions and are copied
into the port's modules; activations are seeded numpy arrays handed to
both.  Everything runs in float32 at 1e-5, or 1e-4 where a product sums
over 128 or more terms (the two frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import layers as jl
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.models import layers

F32 = dict(rtol=1e-5, atol=1e-5)
F32_LONG_SUM = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_registry.smoke("qwen2-1.5b"),
                               dtype="float32", **kw)
    tcfg = dataclasses.replace(registry.smoke("qwen2-1.5b"),
                               dtype="float32", **kw)
    return jcfg, tcfg


def _np(x):
    return np.asarray(x, np.float32)


def _module(cls, tcfg, tree):
    m = cls(tcfg, device="cpu")
    convert.load_module(m, jax.tree.map(np.asarray, tree))
    return m


@pytest.mark.parametrize("norm_kind", ["rms", "layer"])
def test_apply_norm(norm_kind):
    jcfg, tcfg = _cfgs(norm_kind=norm_kind)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, tcfg.d_model)).astype(np.float32)
    tree = {k: v * 0.5 + 0.25 for k, v in jl.init_norm(jcfg).items()}
    want = jl.apply_norm(tree, jnp.asarray(x), jcfg)
    got = layers.apply_norm(_module(layers.Norm, tcfg, tree),
                            torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


@pytest.mark.parametrize("pos_shape", ["per_row", "per_token"])
def test_apply_rope(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 6, 16)).astype(np.float32)     # [B,H,S,D]
    if pos_shape == "per_row":      # decode: one position per slot
        pos = rng.integers(0, 500, size=(3, 1, 1))
    else:                           # prefill: one position per token
        pos = rng.integers(0, 500, size=(1, 1, 6))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_apply_mlp():
    jcfg, tcfg = _cfgs()
    tree = jl.init_mlp(jax.random.key(2), jcfg)
    x = np.random.default_rng(2).normal(size=(2, 5, tcfg.d_model))
    x = x.astype(np.float32)
    want = jl.apply_mlp(tree, jnp.asarray(x))
    got = layers.apply_mlp(_module(layers.MLP, tcfg, tree),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_LONG_SUM)


def test_project_qkv_and_merge_heads():
    jcfg, tcfg = _cfgs()
    tree = jl.init_attention(jax.random.key(3), jcfg)
    rng = np.random.default_rng(3)
    tree = dict(tree, **{k: jnp.asarray(rng.normal(size=tree[k].shape),
                                        jnp.float32)
                         for k in ("bq", "bk", "bv")})  # non-zero biases
    p = _module(layers.Attention, tcfg, tree)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    want = jl._project_qkv(tree, jnp.asarray(x), jnp.asarray(x),
                           jl.attn_dims(jcfg))
    got = layers._project_qkv(p, torch.from_numpy(x), torch.from_numpy(x),
                              layers.attn_dims(tcfg))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), **F32)
    y = rng.normal(size=(2, tcfg.n_heads, 5, tcfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        layers._merge_heads(p, torch.from_numpy(y)).numpy(),
        _np(jl._merge_heads(tree, jnp.asarray(y))), **F32)


@pytest.mark.parametrize("rows", ["decode", "prefill"])
def test_cache_attention_per_row_positions(rows):
    """Rows at different depths share one call; -1 marks empty slots."""
    rng = np.random.default_rng(4)
    b, hq, hkv, d, s = 3, 4, 2, 16, 12
    c = 1 if rows == "decode" else 5
    q = rng.normal(size=(b, hq, c, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    kpos = np.tile(np.arange(s), (b, 1))
    kpos[1, 4:7] = -1                              # empty ring slots
    kpos[2, 0] = -1
    if rows == "decode":
        qpos = np.array([[0], [9], [11]])          # one depth per row
    else:
        qpos = np.array([[2, 3, 4, 5, 6]])         # shared by every row
    want = jl.cache_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(kpos), jnp.asarray(qpos))
    got = layers.cache_attention(*map(torch.from_numpy, (q, k, v, kpos, qpos)))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
