"""The port's blocked-attention forward on the CPU against the JAX package.

The same numpy inputs (seeded) go to the port's ``ops.attention`` (which
takes its plain PyTorch version for CPU tensors) and to the reference's
Pallas kernel in interpret mode (``fa_ops.attention(impl="pallas",
interpret=True)``); the port's row log-sum-exp and its ``q_offset`` are
held against the training path's forward, ``layers._blocked_fwd_impl``.
The cases mirror tests/test_kernels.py's flash-attention sweep, plus
h2o-danube's heads of 80 (8 query heads over 2 KV heads), the width the
tensor-core route takes besides 64 and 128.
Tolerances are that file's ``TOLS``: f32 1e-5, bf16 3e-2; lse (float32
in both, from the same float32 scores) 1e-5.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.models import layers as jax_layers
from repro_torch.checkpoint.convert import to_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as kernel
from repro_torch.kernels.flash_attention import ops, ref

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=3e-2, atol=3e-2)}
LSE_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(dtype, b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=(b, h, s, d)), dtype)
            for h, s in ((hq, sq), (hkv, sk), (hkv, sk))]


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return to_tensor(np.asarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
@pytest.mark.parametrize("s,hq,hkv,d", [
    pytest.param(256, 4, 4, 128, id="256-4-4"),
    pytest.param(256, 4, 2, 128, id="256-4-2"),
    pytest.param(256, 8, 2, 80, id="256-8-2-80"),     # h2o-danube's heads
])
def test_attention_matches_the_pallas_kernel(dtype, causal, window, s, hq,
                                             hkv, d):
    q, k, v = _inputs(dtype, 2, hq, hkv, s, s, d, seed=2)
    want = jax_fa_ops.attention(q, k, v, causal=causal, window=window,
                                impl="pallas", interpret=True)
    before = kernel.flash_attention.launches
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert kernel.flash_attention.launches == before    # the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset,q_chunk,k_chunk", [
    (64, 64, True, None, 0, 16, 32),
    (64, 64, True, 24, 0, 16, 32),
    (64, 64, False, None, 0, 32, 16),
    (64, 64, False, 8, 0, 16, 16),        # window without causality
    (32, 128, True, None, 96, 16, 32),    # the last rows of a longer run
    (32, 128, True, 40, 64, 16, 64),
    (48, 48, True, 0, 0, 16, 16),         # no row sees a key: y 0, lse -46
])
def test_lse_and_offset_match_the_training_forward(dtype, sq, sk, causal,
                                                   window, q_offset, q_chunk,
                                                   k_chunk):
    q, k, v = _inputs(dtype, 2, 3, 3, sq, sk, 16, seed=4)
    want_y, want_lse = jax_layers._blocked_fwd_impl(
        q, k, v, causal, window, q_chunk, k_chunk, q_offset)
    y, lse = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                           q_offset=q_offset, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, sq)
    np.testing.assert_allclose(y.float().numpy(), _np(want_y), **TOLS[dtype])
    np.testing.assert_allclose(lse.numpy(), _np(want_lse), **LSE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset,d", [
    # tail: 200 is not a multiple of 64
    pytest.param(200, 200, True, None, 0, 16, id="200-200-True-None-0"),
    pytest.param(128, 128, False, None, 0, 16, id="128-128-False-None-0"),
    pytest.param(128, 128, True, 24, 0, 16, id="128-128-True-24-0"),
    # first tiles fully masked
    pytest.param(40, 160, True, 30, 120, 16, id="40-160-True-30-120"),
    # no row sees a key
    pytest.param(48, 48, True, 0, 0, 16, id="48-48-True-0-0"),
    # h2o-danube's width: a tail, a window and a fully masked first tile
    pytest.param(200, 260, True, 96, 60, 80, id="200-260-True-96-60-80"),
])
def test_tiled_order_matches_the_plain_version(dtype, sq, sk, causal, window,
                                               q_offset, d):
    """The kernel-order version (64-key tiles, running max, unnormalised p
    rounded) that the card's check holds the bf16 kernel to computes the
    plain version's function; p_max is the row's largest probability."""
    q, k, v = (_t(a) for a in _inputs(dtype, 2, 3, 3, sq, sk, d, seed=6))
    want_y, want_lse = ref.attention_ref(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)
    y, lse, p_max = ref.attention_tiled(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset)
    assert y.dtype == q.dtype and p_max.shape == lse.shape == (2, 3, sq)
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               **TOLS[dtype])
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **LSE_TOL)
    s = (q.float() @ k.float().transpose(-1, -2)) / d ** 0.5
    q_pos = q_offset + torch.arange(sq)[:, None]
    k_pos = torch.arange(sk)[None, :]
    seen = (q_pos >= k_pos) if causal else torch.ones(sq, sk, dtype=bool)
    if window is not None:
        seen &= q_pos - k_pos < window
    top = s.masked_fill(~seen, -torch.inf).amax(-1)
    want_p = torch.where(seen.any(-1), torch.exp(top - want_lse), 0.0)
    np.testing.assert_allclose(p_max.numpy(), want_p.numpy(), **LSE_TOL)


def test_gqa_is_expanded_by_repeat():
    """Query head h reads KV head h // (Hq / Hkv), as jnp.repeat orders."""
    q, k, v = _inputs("float32", 1, 6, 2, 32, 32, 16, seed=5)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True)
    ke, ve = (_t(jnp.repeat(a, 3, axis=1)) for a in (k, v))
    np.testing.assert_array_equal(got.numpy(), ops.attention(
        _t(q), ke, ve, causal=True).numpy())


def test_kernel_routes():
    """bf16 heads of a multiple of 16 in [64, 128] take the tensor cores;
    float32, other bf16 widths and heads past 128 the scalar kernel."""
    for d in (64, 80, 96, 112, 128):
        assert kernel.route(torch.bfloat16, d) == "mma"
    for d in (72, 144):
        assert kernel.route(torch.bfloat16, d) == "simt"
    for d in (80, 128):
        assert kernel.route(torch.float32, d) == "simt"


def test_mma_widths_match_the_launcher():
    """The widths ``route`` sends to the tensor cores are exactly those
    ``flash_attention_launch`` instantiates the wgmma kernel for (any other
    would be refused on the card)."""
    src = _build.SOURCES["flash_attention"].read_text()
    body = re.search(r"int flash_attention_launch\(.*?\n}\n", src,
                     re.S).group(0)
    launched = {int(d) for d in re.findall(r"launch_wgmma<(\d+)>", body)}
    routed = {d for d in range(16, kernel.MAX_D + 1, 8)
              if kernel.route(torch.bfloat16, d) == "mma"}
    assert routed == launched == set(kernel.TENSOR_CORE_DIMS)


def test_ctypes_signature_matches_the_source():
    """The wrapper's argtypes follow the C entry point, parameter for
    parameter (ctypes would pass a float as an int, or cut a pointer)."""
    src = _build.SOURCES["flash_attention"].read_text()
    params = re.search(r"int flash_attention_launch\((.*?)\)", src,
                       re.S).group(1).split(",")
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else ctype[p.split()[0]]
            for p in params]
    assert kernel.ARGTYPES == want


@pytest.mark.parametrize("route,name", [("mma", "kMmaKeys"),
                                        ("simt", "kSimtKeys")])
def test_key_tile_matches_the_source(route, name):
    """The kernel-order plain version tiles keys as each CUDA route does,
    and at that tile computes the plain version's function."""
    src = _build.SOURCES["flash_attention"].read_text()
    tile = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert tile == ref.KEY_TILES[route]
    q, k, v = (_t(a) for a in _inputs("float32", 1, 2, 2, 70, 3 * tile + 5,
                                      16, seed=8))
    y, lse, _ = ref.attention_tiled(q, k, v, causal=True, q_offset=3 * tile,
                                    key_tile=tile)
    want_y, want_lse = ref.attention_ref(q, k, v, causal=True,
                                         q_offset=3 * tile)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **TOLS["float32"])
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **LSE_TOL)
