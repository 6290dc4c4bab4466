"""The port's SSM (Mamba-2 SSD) layer and kernel path on the CPU against
the JAX package.

The scan: ``ssm.ssd_chunked`` against the reference's at chunks 4, 8 and
16 and against the per-token recurrence (tests/test_layers.py's shape,
float32 1e-4); ``ops.ssd`` (the plain chunked version at the CUDA kernel's
64-row sub-chunks, what a CPU tensor takes) against the Pallas kernel in
interpret mode at tests/test_kernels.py's shapes (bfloat16 5e-2, float32
1e-4, its bounds), including a ragged S; the per-token ``ssd_ref`` against
the reference's (y and final state, 1e-5).

The layer: ``apply_ssm`` against the reference's on its own parameters
(float32 1e-4, bfloat16 5e-2); ``decode_ssm`` token by token against
``apply_ssm`` (float32 1e-4; tests/test_layers.py holds the reference's
own pair to 2e-2); grads of ``apply_ssm`` against ``jax.grad`` in float32
where every intra-chunk decay exponent stays below 88 (1e-4 relative to
each leaf's largest grad).  Where one does not, the reference's gradient
is NaN and the port's finite: the registered reference gap.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.kernels.ssd_scan import ref as jax_ssd_ref
from repro.models import ssm as jax_ssm
from repro.models.types import ModelConfig as JaxModelConfig
from repro_torch.checkpoint import convert
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan as kernel
from repro_torch.models import ssm
from repro_torch.models.types import ModelConfig

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SOURCE = "ssd_scan"
CFG = dict(name="t", family="ssm", n_layers=1, d_model=32, d_ff=0,
           ssm_state=8, ssm_expand=2, ssm_d_head=8, ssm_chunk=8,
           rope_theta=0.0)


def _c_signature(entry: str) -> list:
    """ctypes types of a C entry point's parameters, read from its source
    (ctypes would pass a float as an int, or cut a pointer)."""
    src = _build.SOURCES[SOURCE].read_text()
    params = re.search(rf"int {entry}\((.*?)\)", src, re.S).group(1)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else ctype[p.split()[0]]
            for p in params.split(",")]


def test_ctypes_signature_matches_the_source():
    assert kernel.ARGTYPES == _c_signature("ssd_scan_launch")


def test_kernel_constants_match_the_source():
    """The plain version's chunk is the kernel's sub-chunk; the wrapper's
    limit on P and N is the kernel's."""
    src = _build.SOURCES[SOURCE].read_text()
    for name, value in (("kQ", ref.SUB_CHUNK), ("kMaxDim", kernel.MAX_DIM)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1)) == value


def _inputs(rng, b, s, h, p, n, dt_range=(0.01, 0.5)):
    return dict(
        xh=rng.normal(size=(b, s, h, p)).astype(np.float32),
        dt=rng.uniform(*dt_range, size=(b, s, h)).astype(np.float32),
        a_log=rng.uniform(-1, 0.5, size=(h,)).astype(np.float32),
        b_mat=rng.normal(size=(b, s, n)).astype(np.float32),
        c_mat=rng.normal(size=(b, s, n)).astype(np.float32),
        d_skip=rng.normal(size=(h,)).astype(np.float32))


def _t(arrays, dtype=None):
    out = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    if dtype is not None:
        for k in ("xh", "b_mat", "c_mat"):
            out[k] = out[k].to(dtype)
    return out


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_the_reference(chunk):
    arrays = _inputs(np.random.default_rng(3), 2, 32, 3, 8, 4)
    want, _ = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays.values()),
                                  chunk=chunk)
    got = ssm.ssd_chunked(*_t(arrays).values(), chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    naive, _ = ref.ssd_ref(*_t(arrays).values())
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ssd_ref_matches_the_reference():
    arrays = _inputs(np.random.default_rng(4), 2, 24, 3, 8, 4)
    want_y, want_s = jax_ssd_ref.ssd_ref(*map(jnp.asarray, arrays.values()))
    y, state = ref.ssd_ref(*_t(arrays).values())
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_op_matches_the_pallas_kernel(dtype, chunk):
    """tests/test_kernels.py's case: the TPU kernel at ``chunk`` and the
    port's op (64-row chunks) give the same y, in xh's type."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    arrays = _inputs(np.random.default_rng(4), 2, 128, 4, 16, 8,
                     dt_range=(0.01, 0.4))
    arrays["a_log"] = np.random.default_rng(5).uniform(
        -1, 0.3, (4,)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    for k in ("xh", "b_mat", "c_mat"):
        j[k] = j[k].astype(jdt)
    want = jax_ssd_ops.ssd(*j.values(), chunk=chunk)
    tdt = getattr(torch, dtype)
    got = ops.ssd(*_t({k: np.asarray(v.astype(jnp.float32))
                       for k, v in j.items()}, tdt).values())
    assert got.dtype == tdt
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_ssd_op_takes_a_ragged_last_chunk():
    """S = 100: the op's last 64-row chunk is 36 rows (the CUDA kernel's
    padding), against the per-token recurrence."""
    arrays = _inputs(np.random.default_rng(6), 1, 100, 2, 8, 4)
    got = ops.ssd(*_t(arrays).values())
    naive, _ = ref.ssd_ref(*_t(arrays).values())
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _ssm_pair(dtype="float32", **kw):
    jcfg = JaxModelConfig(**{**CFG, "dtype": dtype, **kw})
    tcfg = ModelConfig(**{**CFG, "dtype": dtype, **kw})
    jp = jax_ssm.init_ssm(jax.random.key(0), jcfg)
    tp = ssm.SSM(tcfg, device="cpu")
    convert.load_module(tp, jax.tree.map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_matches_the_reference(dtype):
    jcfg, jp, tcfg, tp = _ssm_pair(dtype)
    x = np.random.default_rng(4).normal(size=(2, 32, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want = np.asarray(jax_ssm.apply_ssm(jp, jx, jcfg), np.float32)
    got = ssm.apply_ssm(tp, convert.to_tensor(np.asarray(jx)), tcfg)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_decode_matches_prefill():
    """decode_ssm token by token reproduces apply_ssm; the cache is
    updated in place."""
    _, _, tcfg, tp = _ssm_pair()
    b, s = 2, 16
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(b, s, tcfg.d_model)).astype(np.float32))
    full = ssm.apply_ssm(tp, x, tcfg)
    cache = ssm.init_ssm_cache(tcfg, b, "cpu")
    state = cache["state"]
    outs = [ssm.decode_ssm(tp, x[:, t:t + 1], cache, tcfg) for t in range(s)]
    assert cache["state"] is state and state.abs().max() > 0
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_decode_ssm_matches_the_reference():
    jcfg, jp, tcfg, tp = _ssm_pair()
    x = np.random.default_rng(8).normal(size=(2, 6, 32)).astype(np.float32)
    jc = jax_ssm.init_ssm_cache(jcfg, 2)
    tc = ssm.init_ssm_cache(tcfg, 2, "cpu")
    for t in range(6):
        jy, jc = jax_ssm.decode_ssm(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        ty = ssm.decode_ssm(tp, torch.from_numpy(x[:, t:t + 1]), tc, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _grads(jcfg, jp, tcfg, tp, x):
    def jloss(p, xx):
        return jnp.sum(jnp.sin(jax_ssm.apply_ssm(p, xx, jcfg)))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = dict(tp.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(ssm.apply_ssm(tp, xt, tcfg)).sum().backward()
    got = {name: t.grad.numpy() for name, t in params.items()}
    got["x"] = xt.grad.numpy()
    want = {name: np.asarray(jgp[name]) for name in params}
    want["x"] = np.asarray(jgx)
    return got, want


@pytest.mark.parametrize("chunk", [8, 16])
def test_apply_ssm_grads_match_jax_grad(chunk):
    """Init dt ~ softplus(0) = 0.69 and A = -1: over a 16-row chunk the
    decay exponents stay below 11, far from exp's overflow."""
    jcfg, jp, tcfg, tp = _ssm_pair(ssm_chunk=chunk)
    x = np.random.default_rng(9).normal(size=(2, 32, 32)).astype(np.float32)
    got, want = _grads(jcfg, jp, tcfg, tp, x)
    for name in want:
        assert np.isfinite(want[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4 * max(1.0,
                                                   np.abs(want[name]).max()),
                                   err_msg=name)


def test_reference_ssd_grad_is_nan_where_the_ports_is_finite():
    """The registered reference gap: with dt * |A| = 10 a step, the
    exponent exp(cum_i - cum_j) above the diagonal reaches 150 in a
    16-row chunk.  The reference masks exp's result with where, so its
    forward is finite but its gradient is inf * 0 = NaN; the port takes
    exp of the masked exponent."""
    arrays = _inputs(np.random.default_rng(2), 1, 16, 2, 4, 4)
    arrays["dt"] = np.full((1, 16, 2), 10.0, np.float32)
    arrays["a_log"] = np.zeros(2, np.float32)
    j = [jnp.asarray(v) for v in arrays.values()]

    def jloss(dt):
        return jnp.sum(jax_ssm.ssd_chunked(j[0], dt, *j[2:], chunk=16)[0])

    assert np.isfinite(float(jloss(j[1])))
    assert np.isnan(np.asarray(jax.grad(jloss)(j[1]))).any()
    t = _t(arrays)
    t["dt"].requires_grad_(True)
    y = ssm.ssd_chunked(*t.values(), chunk=16)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(t["dt"].grad).all()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax_ssm.ssd_chunked(
                                   *j, chunk=16)[0]), rtol=1e-4, atol=1e-4)
