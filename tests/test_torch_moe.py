"""The port's MoE family on the CPU against the JAX package.

Kernels: the plain dispatch and combine (what a CPU tensor takes) against
the Pallas kernels in interpret mode and the JAX oracles, in float32 and
bfloat16, at fan-ins 1, 2 and 4 with dropped choices.  Dispatch moves rows
and must be bit-exact; combine sums K float32 products in another order
than the oracle's einsum: float32 1e-5 (the Pallas test's bound), bfloat16
within one bf16 rounding (2^-8 relative) plus 1e-6.

The layer: ``apply_moe`` against ``repro.models.moe.apply_moe`` on the
reference's own parameters.  The reference's dispatch and combine einsums
are observed as they run (its module's ``jnp`` is wrapped): the port's
slots must give exactly the reference's dispatch one-hots, its expert
inputs must equal the reference's bit for bit, y agrees within 1e-5 in
float32 and 2e-2 in bfloat16 (the expert FFN's bf16 roundings fall in
other places: silu in one rounding here, several there), and the aux loss
within 1e-6.  Grads against ``jax.grad`` in float32 within 1e-4.

The serve engines on dbrx-smoke in float32: equal greedy streams, logits
within 1e-4, no page leaks.  Whole MoE models are held against the
reference in tests/test_torch_decode.py.
"""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels.moe_dispatch import ops as jax_moe_ops
from repro.kernels.moe_dispatch import ref as jax_moe_ref
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch import moe_dispatch as kernel
from repro_torch.kernels.moe_dispatch import ops
from repro_torch.models import moe
from repro_torch.serve import ServeEngine

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SOURCE = "moe_dispatch"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _c_signature(entry: str) -> list:
    """ctypes types of a C entry point's parameters, read from its source
    (ctypes would pass a float as an int, or cut a pointer)."""
    src = _build.SOURCES[SOURCE].read_text()
    params = re.search(rf"int {entry}\((.*?)\)", src, re.S).group(1)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else ctype[p.split()[0]]
            for p in params.split(",")]


def test_ctypes_signatures_match_the_source():
    assert kernel.DISPATCH_ARGTYPES == _c_signature("moe_dispatch_launch")
    assert kernel.COMBINE_ARGTYPES == _c_signature("moe_combine_launch")
    assert kernel.PARTS_ARGTYPES == _c_signature("moe_combine_parts")


def test_combine_limits_match_the_source():
    src = _build.SOURCES[SOURCE].read_text()
    assert int(re.search(r"constexpr int kMaxFanin = (\d+);",
                         src).group(1)) == kernel.MAX_FANIN


def _torch(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# kernels: dispatch / combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dispatch_matches_pallas_and_ref(dtype):
    """The Pallas test's shape (64 tokens, 48 distinct slots, 16 dropped)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    t, d, n_slots = 64, 128, 48
    x = jnp.asarray(rng.normal(size=(t, d)), jdt)
    slot = np.full(t, -1, np.int32)
    slot[rng.choice(t, size=n_slots, replace=False)] = \
        rng.permutation(n_slots)
    want = np.asarray(jax_moe_ops.dispatch(x, jnp.asarray(slot),
                                           n_slots=n_slots))
    assert (want == np.asarray(jax_moe_ref.dispatch_ref(
        x, jnp.asarray(slot), n_slots))).all()
    out = ops.dispatch(_torch(x), torch.from_numpy(slot), n_slots=n_slots)
    assert out.dtype == tdt
    assert np.array_equal(_np(out), np.asarray(want, np.float32))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dispatch_of_k_choices(dtype, k):
    """slot [T, K]: every kept choice receives its token, bit for bit, as
    the reference's dispatch of the token repeated K times."""
    jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(k)
    t, d, n_slots = 24, 64, 40
    x = jnp.asarray(rng.normal(size=(t, d)), jdt)
    flat = np.full(t * k, -1, np.int32)
    kept = rng.choice(t * k, size=min(n_slots, t * k * 3 // 4),
                      replace=False)
    flat[kept] = rng.permutation(n_slots)[:kept.size]
    want = np.asarray(jax_moe_ref.dispatch_ref(
        jnp.repeat(x, k, axis=0), jnp.asarray(flat), n_slots), np.float32)
    out = ops.dispatch(_torch(x), torch.from_numpy(flat.reshape(t, k)),
                       n_slots=n_slots)
    assert np.array_equal(_np(out), want)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_combine_matches_pallas_and_ref(dtype, k, seed):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    t, d, n_slots = 32, 128, 64
    ye = jnp.asarray(rng.normal(size=(n_slots, d)), jdt)
    slot = rng.integers(0, n_slots, (t, k)).astype(np.int32)
    slot[rng.random((t, k)) < 0.2] = -1                   # dropped choices
    w = rng.random((t, k)).astype(np.float32)
    out = ops.combine(_torch(ye), torch.from_numpy(slot),
                      torch.from_numpy(w))
    assert out.dtype == tdt and out.shape == (t, d)
    for want in (jax_moe_ops.combine(ye, jnp.asarray(slot), jnp.asarray(w)),
                 jax_moe_ref.combine_ref(ye, jnp.asarray(slot),
                                         jnp.asarray(w))):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_np(out), want, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(_np(out) - want)
                    <= 2.0**-8 * np.abs(want) + 1e-6).all()


def test_combine_never_reads_a_dropped_slot():
    """A dropped choice adds nothing, even where row 0 holds inf (the TPU
    kernel fetches row 0 and multiplies it by 0, which gives NaN)."""
    ye = torch.ones(4, 8)
    ye[0] = float("inf")
    slot = torch.tensor([[-1, 1], [2, -1]], dtype=torch.int32)
    y = ops.combine(ye, slot, torch.full((2, 2), 0.5))
    assert torch.equal(y, torch.full((2, 8), 0.5))


def test_dispatch_combine_roundtrip():
    """combine(dispatch(x)) with k=1, weight 1 recovers every token
    (tests/test_kernels.py's round trip)."""
    rng = np.random.default_rng(9)
    t, d = 32, 128
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    slot = torch.from_numpy(rng.permutation(t).astype(np.int32))
    xe = ops.dispatch(x, slot, n_slots=t)
    y = ops.combine(xe, slot[:, None], torch.ones(t, 1))
    assert torch.equal(y, x)


# ---------------------------------------------------------------------------
# the layer: apply_moe, routing_trace, grads
# ---------------------------------------------------------------------------

class _EinsumSpy:
    """Stands in for ``jnp`` inside ``repro.models.moe``: every einsum
    runs as before and its operands and result are kept by spec."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *args, **kw):
        out = jnp.einsum(spec, *args, **kw)
        self.calls[spec] = (args, out)
        return out


def _moe_pair(dtype, top_k=2, capacity_factor=1.25, n_experts=4,
              shared=0, seed=0):
    base = dataclasses.replace(jax_registry.smoke("dbrx-132b"), dtype=dtype,
                               top_k=top_k, n_experts=n_experts,
                               capacity_factor=capacity_factor,
                               n_shared_experts=shared)
    tcfg = dataclasses.replace(registry.smoke("dbrx-132b"), dtype=dtype,
                               top_k=top_k, n_experts=n_experts,
                               capacity_factor=capacity_factor,
                               n_shared_experts=shared)
    jp = jax_moe.init_moe(jax.random.key(seed), base)
    tp = moe.MoE(tcfg, device="cpu")
    convert.load_module(tp, jax.tree.map(np.asarray, jp))
    return base, jp, tcfg, tp


CASES = [  # (top_k, capacity_factor, n_experts, shared): drops at cf 0.5
    (1, 1.25, 4, 1), (2, 1.25, 4, 0), (2, 0.5, 4, 0), (4, 0.5, 8, 0)]


@pytest.mark.parametrize("top_k,cf,n_experts,shared", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_moe_matches_the_reference(monkeypatch, dtype, top_k, cf,
                                         n_experts, shared):
    jcfg, jp, tcfg, tp = _moe_pair(dtype, top_k, cf, n_experts, shared)
    jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(top_k)
    x = jnp.asarray(rng.normal(size=(2, 64, tcfg.d_model)), jdt)  # G = 2
    spy = _EinsumSpy()
    monkeypatch.setattr(jax_moe, "jnp", spy)
    jy, jaux = jax_moe.apply_moe(jp, x, jcfg)
    (dispatch, _), jxe = spy.calls["gsec,gsd->egcd"]
    (_, combine), _ = spy.calls["egcd,gsec->gsd"]
    g, gs, e, cap = dispatch.shape

    xt = _torch(x)
    probs, top_i, top_w, slot = moe._route(tp, xt.reshape(g, gs, -1), tcfg)
    # the slots, as one-hots, are the reference's dispatch tensor
    onehot = np.zeros((g * gs, e * g * cap), np.float32)
    rows, ks = np.nonzero(slot.numpy() >= 0)
    onehot[rows, slot.numpy()[rows, ks]] = 1.0
    ref_onehot = np.zeros_like(onehot)
    d = np.asarray(dispatch, np.float32)                   # [G,S,E,C]
    for gi in range(g):
        block = d[gi].reshape(gs, e, cap)
        for ei in range(e):
            ref_onehot[gi * gs:(gi + 1) * gs,
                       (ei * g + gi) * cap:(ei * g + gi + 1) * cap] = \
                block[:, ei]
    assert np.array_equal(onehot, ref_onehot)
    if cf < 1:
        assert (slot.numpy() < 0).any()                   # drops happened
    # combine weights: top_w rounded to bf16 where the token was kept
    wt = np.zeros_like(onehot)
    wt[rows, slot.numpy()[rows, ks]] = _np(top_w.reshape(g * gs, -1)
                                           .to(torch.bfloat16))[rows, ks]
    c = np.asarray(combine, np.float32)
    ref_w = np.zeros_like(wt)
    for gi in range(g):
        for ei in range(e):
            ref_w[gi * gs:(gi + 1) * gs,
                  (ei * g + gi) * cap:(ei * g + gi + 1) * cap] = \
                c[gi, :, ei]
    assert np.array_equal(wt, ref_w)
    # the expert inputs, bit for bit
    xe = ops.dispatch(xt.reshape(-1, tcfg.d_model).to(torch.bfloat16), slot,
                      n_slots=e * g * cap)
    assert np.array_equal(_np(xe), np.asarray(jxe, np.float32)
                          .reshape(e * g * cap, -1))

    ty, taux = moe.apply_moe(tp, xt, tcfg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)
    assert abs(taux.item() - float(jaux)) <= 1e-6
    assert ty.dtype == xt.dtype and ty.shape == xt.shape


def test_routing_trace_matches_the_reference():
    jcfg, jp, tcfg, tp = _moe_pair("float32", top_k=2)
    x = np.random.default_rng(3).normal(size=(3, 40, 64)).astype(np.float32)
    want = np.asarray(jax_moe.routing_trace(jp, jnp.asarray(x), jcfg))
    got = moe.routing_trace(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k,cf,n_experts,shared", CASES[1:3])
def test_moe_grads_match_jax_grad(top_k, cf, n_experts, shared):
    """d/d(x, router, experts) of sum(sin(y)) + aux, float32."""
    jcfg, jp, tcfg, tp = _moe_pair("float32", top_k, cf, n_experts, shared)
    x = np.random.default_rng(7).normal(size=(2, 64, 64)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe.apply_moe(p, xx, jcfg)
        return jnp.sum(jnp.sin(y)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = dict(tp.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.apply_moe(tp, xt, tcfg)
    (torch.sin(y).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-4)
    for name, t in params.items():
        want = np.asarray(jgp[name])
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

def _model_pair(arch, dtype):
    jcfg = dataclasses.replace(jax_registry.smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(registry.smoke(arch), dtype=dtype)
    jp = jax_api.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def test_serve_engine_on_dbrx_matches_the_reference():
    jcfg, jp, tcfg, tp = _model_pair("dbrx-132b", "float32")
    kw = dict(slots=4, max_len=48, page_size=8, prefill_chunk=8,
              capture_logits=True)
    prompts = [list(range(1, 6)), list(range(20, 31)), [40, 41],
               list(range(60, 80))]
    runs = []
    for eng in (JaxServeEngine(jcfg, jp, **kw),
                ServeEngine(tcfg, tp, device="cpu", **kw)):
        rs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        runs.append([(r.out_tokens, np.stack(r.logits_log)) for r in rs])
    for (jt, jl), (tt, tl) in zip(*runs):
        assert tt == jt and len(tt) == 6
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
