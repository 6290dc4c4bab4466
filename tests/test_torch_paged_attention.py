"""The port's paged decode attention on the CPU against the JAX package.

The same numpy inputs (seeded) go to the port's ``ops.paged_attention``
(which takes its plain PyTorch version for CPU tensors), and to its
kernel-order split version ``ref.paged_attention_split`` at the wrapper's
own split count, and to the reference's Pallas kernel in interpret mode and
its pure-jnp oracle.  The
reference kernel has one KV head per query head, so for GQA it is fed the
pages repeated to H heads (``jnp.repeat(..., axis=2)``, as
``repro.models.paged_lm`` calls it) while the port reads the grouped pages
natively.  Tolerances are the reference's kernel tolerances
(tests/test_kernels.py ``TOLS``): f32 1e-5, bf16 3e-2.
"""
import ctypes
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.checkpoint.convert import to_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.kernels.paged_attention import paged_attention as kernel
from repro_torch.models import layers

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _inputs(dtype, page, pps, h, hkv, table_kind, seed=6):
    rng = np.random.default_rng(seed)
    b, d = 4, 128
    pool = 64 if table_kind == "distinct" else 8
    q = jnp.asarray(rng.normal(size=(b, h, d)), dtype)
    kp = jnp.asarray(rng.normal(size=(pool, page, hkv, d)), dtype)
    vp = jnp.asarray(rng.normal(size=(pool, page, hkv, d)), dtype)
    if table_kind == "distinct":
        pt = rng.choice(pool, size=(b, pps), replace=False)
    else:       # a small pool: rows share and repeat physical pages
        pt = rng.integers(0, pool, (b, pps))
    pt = jnp.asarray(pt, jnp.int32)
    # a zero-length row, a single token, a ragged tail, a full row
    lengths = jnp.asarray([0, 1, page + 3, page * pps], jnp.int32)
    return q, kp, vp, pt, lengths


def _port(*arrays):
    return [to_tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("table_kind", ["distinct", "duplicates"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (6, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("page,pps", [(16, 4), (32, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax(dtype, page, pps, h, hkv, table_kind):
    q, kp, vp, pt, lengths = _inputs(dtype, page, pps, h, hkv, table_kind)
    out = ops.paged_attention(*_port(q, kp, vp, pt, lengths))
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    got = out.float().numpy()
    rep = h // hkv
    kpf, vpf = jnp.repeat(kp, rep, axis=2), jnp.repeat(vp, rep, axis=2)
    for want in (jax_ops.paged_attention(q, kpf, vpf, pt, lengths),
                 jax_ref.paged_attention_ref(q, kpf, vpf, pt, lengths)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOLS[dtype])
    assert not got[0].any()                    # zero-length row gives zeros


def test_dead_table_entries_are_not_read():
    """Entries past ceil(length / page) may hold anything, even ids out of
    the pool; lengths past the table clamp to its capacity."""
    q, kp, vp, pt, lengths = _inputs("float32", 16, 4, 6, 2, "distinct")
    want = ops.paged_attention(*_port(q, kp, vp, pt, lengths))
    bad = np.asarray(pt).copy()
    bad[0, :] = 10**6                          # length 0: no entry is live
    bad[1, 1:] = -7                            # length 1: one live entry
    bad[2, 2:] = 10**6                         # length page + 3: two live
    q_t, kp_t, vp_t, _, len_t = _port(q, kp, vp, pt, lengths)
    got = ops.paged_attention(q_t, kp_t, vp_t, torch.from_numpy(bad), len_t)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    over = ops.paged_attention(q_t, kp_t, vp_t, to_tensor(pt),
                               len_t + torch.tensor([0, 0, 0, 100],
                                                    dtype=torch.int32))
    np.testing.assert_array_equal(over.numpy(), want.numpy())


def test_paged_attention_matches_dense_decode():
    """Paged KV with an identity page table equals dense decode attention
    (the reference's identity, tests/test_kernels.py), here for GQA too."""
    rng = np.random.default_rng(7)
    b, h, hkv, d, page, pps = 2, 4, 2, 64, 16, 4
    s = page * pps
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    kc = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    vc = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    pos = s - 1
    ref = jax_layers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.arange(s), pos=pos)
    dense = layers.cache_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.arange(s)[None, :], torch.full((1, 1), pos))
    kp = kc.transpose(0, 2, 1, 3).reshape(b * pps, page, hkv, d)
    vp = vc.transpose(0, 2, 1, 3).reshape(b * pps, page, hkv, d)
    pt = np.arange(b * pps, dtype=np.int32).reshape(b, pps)
    paged = ops.paged_attention(
        torch.from_numpy(q[:, :, 0]), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(pt),
        torch.full((b,), pos + 1, dtype=torch.int32))
    for got in (paged.numpy(), dense[:, :, 0].numpy()):
        np.testing.assert_allclose(got, np.asarray(ref)[:, :, 0],
                                   rtol=2e-5, atol=2e-5)


def _split_lengths(pps, page, n_split):
    """A zero-length row, one token, a full row, and rows one short of, at
    and one past the first, middle and last split boundaries (every row
    shorter than the table leaves splits wholly past its length)."""
    run = -(-pps // n_split) * page
    bounds = sorted({run, (n_split // 2) * run, (n_split - 1) * run} - {0})
    lens = [0, 1, pps * page]
    for edge in bounds:
        lens += [edge - 1, edge, edge + 1]
    return [min(max(x, 0), pps * page) for x in lens]


@pytest.mark.parametrize("h,hkv,d,page,pps", [
    (4, 4, 64, 16, 8),         # rep 1, one page a split
    (4, 2, 80, 32, 8),         # rep 2, h2o-danube's D, page 32
    (12, 2, 128, 16, 40),      # rep 6 (qwen2-1.5b), two pages a split
    (16, 2, 128, 32, 12),      # rep 8, page 32
    (12, 2, 128, 16, 32),      # the serving path's table: 32 pages of 16
    (40, 10, 128, 16, 8),      # rep 4 over 10 KV heads (phi3-medium)
    (40, 8, 128, 16, 8),       # rep 5, a pass short of 8 (llama4-scout)
    (64, 8, 128, 16, 8),       # rep 8 over 8 KV heads (internvl2)
], ids=["rep1-d64", "rep2-d80-p32", "rep6-d128", "rep8-p32", "rep6-p32x16",
        "rep4-hkv10", "rep5-hkv8", "rep8-hkv8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_order_matches_jax(dtype, h, hkv, d, page, pps):
    """The split version at the wrapper's split count computes the
    reference's function: lengths crossing split boundaries, a zero-length
    row, splits wholly past a row's length."""
    n_split = kernel.n_splits(6, hkv, pps, page)
    lengths = _split_lengths(pps, page, n_split)
    b = len(lengths)
    rng = np.random.default_rng(11)
    pool = b * pps + 1
    q = jnp.asarray(rng.normal(size=(b, h, d)), dtype)
    kp = jnp.asarray(rng.normal(size=(pool, page, hkv, d)), dtype)
    vp = jnp.asarray(rng.normal(size=(pool, page, hkv, d)), dtype)
    pt = jnp.asarray(rng.permutation(pool - 1)[:b * pps].reshape(b, pps) + 1,
                     jnp.int32)
    ln = jnp.asarray(lengths, jnp.int32)
    args = _port(q, kp, vp, pt, ln)
    out = ref.paged_attention_split(*args, n_split)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    got = out.float().numpy()
    rep = h // hkv
    kpf, vpf = jnp.repeat(kp, rep, axis=2), jnp.repeat(vp, rep, axis=2)
    for want in (jax_ops.paged_attention(q, kpf, vpf, pt, ln),
                 jax_ref.paged_attention_ref(q, kpf, vpf, pt, ln)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOLS[dtype])
    assert not got[0].any()                    # zero-length row gives zeros
    np.testing.assert_allclose(got, ref.paged_attention_ref(*args)
                               .float().numpy(), **TOLS[dtype])


@pytest.mark.parametrize("b,hkv,pps,page", [
    (8, 2, 32, 16), (8, 8, 32, 16), (8, 2, 256, 16), (1, 1, 1, 16),
    (4, 2, 8, 32), (3, 1, 7, 16), (64, 8, 5, 128), (2, 2, 1000, 8)])
def test_split_count_covers_every_page_once(b, hkv, pps, page):
    """The split count is a function of shapes alone (no lengths), takes at
    least one page a split, and its runs of ceil(P / n) pages cover each
    page of the table once; it halves the run while the grid is short of
    one wave on the card's SMs."""
    assert list(inspect.signature(kernel.n_splits).parameters) == [
        "b", "hkv", "pages_per_seq", "page"]
    n = kernel.n_splits(b, hkv, pps, page)
    assert 1 <= n <= pps
    run = -(-pps // n)
    covered = [p for s in range(n) for p in range(s * run,
                                                  min((s + 1) * run, pps))]
    assert covered == list(range(pps))
    assert run * page <= max(kernel.SPLIT_TOKENS, page)
    assert b * hkv * n >= kernel.SMS or run == 1 \
        or run == max(1, kernel.SPLIT_TOKENS // page)


def test_ctypes_signature_matches_the_source():
    """The wrapper's argtypes follow the C entry point, parameter for
    parameter (ctypes would cut a pointer passed as an int)."""
    src = _build.SOURCES["paged_attention"].read_text()
    params = re.search(r"int paged_attention_launch\((.*?)\)", src,
                       re.S).group(1).split(",")
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else ctype[p.split()[0]]
            for p in params]
    assert kernel.ARGTYPES == want
