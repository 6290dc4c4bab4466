"""The port's new CUDA kernels against their plain versions at edge shapes.

These need the card and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` holds the same kernels at the full sizes of their path;
here the shapes reach the corners the full sizes do not: rows of more
than 32 chunks of 16 bytes, fan-ins over 32, block_rows that are no
multiple of the warps of a block, depths clamped by the item count, a
grid with more sets than ways, addresses that wrap in int32, and
attention tiles that the causal diagonal, the window, the tail or a query
offset cut.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cgra import cache_grid
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gather_runahead import gather_runahead as kernel
from repro_torch.kernels.gather_runahead import ops, ref
from repro_torch.models import layers

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _table(v, d, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(v, d, generator=gen).to(dtype).to(device)


def _bits(t):
    return t.contiguous().view(torch.uint8).cpu()


@pytest.mark.parametrize("v,d,dtype,n,block_rows,depth", [
    (300, 200, torch.float32, 48, 3, 3),       # 50 chunks a row
    (1000, 128, torch.bfloat16, 64, 8, 8),
    (50, 8, torch.bfloat16, 16, 16, 5),        # one tile: depth clamps to 1
    (4096, 64, torch.float32, 8000, 8, 2),
    (700, 1024, torch.bfloat16, 40, 5, 4),     # 128 chunks a row
])
@pytest.mark.parametrize("grid_blocks", [None, 1, 7])
def test_gathers_are_bit_identical(card, v, d, dtype, n, block_rows, depth,
                                   grid_blocks):
    table = _table(v, d, dtype, 0, card)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, v, n).astype(np.int32)).to(card)
    want = _bits(ref.gather_ref(table, idx))
    out = kernel.runahead_gather(table, idx, block_rows=block_rows,
                                 depth=depth, grid_blocks=grid_blocks)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), want)
    assert torch.equal(_bits(kernel.pipelined_gather(table, idx)), want)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take(card):
    table = _table(64, 32, torch.float32, 0, card)
    idx = torch.zeros(12, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        kernel.runahead_gather(table, idx, block_rows=8)
    with pytest.raises(ValueError, match="depth"):
        kernel.runahead_gather(table, idx, block_rows=4, depth=9)
    with pytest.raises(ValueError, match="grid_blocks"):
        kernel.runahead_gather(table, idx, block_rows=4, grid_blocks=0)
    with pytest.raises(ValueError, match="16"):
        kernel.pipelined_gather(_table(64, 6, torch.float32, 0, card), idx)
    with pytest.raises(ValueError, match="int32"):
        kernel.pipelined_gather(table, idx.long())
    empty = kernel.runahead_gather(table, idx[:0])
    assert empty.shape == (0, 32)


@pytest.mark.parametrize("v,d,dtype,s,k,depth", [
    (500, 96, torch.float32, 37, 40, 3),        # K over 32
    (300, 512, torch.bfloat16, 19, 5, 8),       # 64 chunks a row
    (90, 512, torch.float32, 70, 33, 1),        # 128 chunks; 67.6 KB ring
    (200, 128, torch.bfloat16, 64, 23, 4),
    (100, 4, torch.float32, 3, 1, 2),           # one chunk
])
def test_gather_bag_within_its_bound(card, v, d, dtype, s, k, depth):
    rng = np.random.default_rng(2)
    table = _table(v, d, dtype, 3, card)
    idx = torch.from_numpy(rng.integers(0, v, (s, k)).astype(np.int32)) \
        .to(card)
    w = torch.from_numpy(rng.normal(size=(s, k)).astype(np.float32)).to(card)
    out = kernel.gather_bag(table, idx, w, depth=depth)
    want = ref.gather_bag_ref(table, idx, w)
    # two orders of a K-term f32 sum of rounded products, plus one
    # bfloat16 rounding of the sum for a bfloat16 table
    order = k * 2.0**-23 * ref.gather_bag_ref(table.float().abs(), idx,
                                              w.abs())
    exact = ref.gather_bag_ref(table.float(), idx, w)
    tol = order if dtype == torch.float32 else \
        order + 2.0**-7 * (exact.abs() + order)
    diff = (out.float() - want.float()).abs()
    assert out.dtype == dtype and out.shape == (s, d)
    assert bool((diff <= tol).all()), diff.max().item()


def test_gather_bag_takes_float32_weights(card):
    table = _table(8, 32, torch.bfloat16, 0, card)
    idx = torch.zeros(2, 3, dtype=torch.int32, device=card)
    w = torch.ones(2, 3, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="float32 weights"):
        kernel.gather_bag(table, idx, w)
    assert torch.equal(ops.gather_bag(table, idx, w).cpu(),
                       ref.gather_bag_ref(table.cpu(), idx.cpu(), w.cpu()))


def test_gather_bag_refuses_rows_past_its_accumulator(card):
    table = _table(8, 1024, torch.float32, 0, card)    # 4096-byte rows
    idx = torch.zeros(2, 3, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="accumulator"):
        kernel.gather_bag(table, idx, torch.ones(2, 3, device=card))


def test_cache_grid_kernel_equals_the_plain_version(card):
    rng = np.random.default_rng(4)
    t_len = 3000                                   # not a multiple of 32
    addrs = rng.integers(0, 1 << 13, t_len)
    addrs[::7] += 2**31                            # wrap to negative int32
    addrs[::11] = 2**32 - 1 - rng.integers(0, 64, len(addrs[::11]))
    addrs[1::5] = addrs[::5][:len(addrs[1::5])]    # repeats
    grid = cache_grid.ConfigGrid.build(1024, [0, 1, 2, 3, 5, 8, 32],
                                       (16, 32, 64, 128))
    a = cache_grid.as_int32(addrs, card)
    got = cache_grid.cache_grid_scan(a, grid)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cache_grid.hit_series_ref(a, grid).cpu())
    assert torch.equal(got.cpu(), cache_grid.hit_series(addrs, grid,
                                                        device="cpu"))


def test_cache_grid_kernel_refuses_too_many_ways(card):
    grid = cache_grid.ConfigGrid.build(512, [33], (64,))
    with pytest.raises(ValueError, match="max_ways"):
        cache_grid.cache_grid_scan(
            torch.zeros(4, dtype=torch.int32, device=card), grid)


# y: bf16 3e-2 (p rounded to bf16 before P.V, here and in the plain
# version at different points), f32 1e-4 (summation order over up to 128
# terms of D and 4,096 keys); lse 1e-4 (float32 in both)
FLASH_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


def _qkv(b, h, sq, sk, d, dtype, device, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=gen).to(dtype).to(device)
            for s in (sq, sk, sk)]


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 72),   # scalar route
                                     (torch.float32, 128),
                                     (torch.float32, 36)])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (256, 256, True, None, 0),
    (200, 200, True, None, 0),        # tails of 64- and 32-row tiles
    (200, 200, False, None, 0),
    (256, 256, True, 96, 0),          # rows whose first tiles all drop out
    (130, 333, False, 50, 0),         # window without causality
    (64, 320, True, None, 256),       # the last rows of a longer sequence
    (100, 300, True, 70, 190),
    (1, 5, True, None, 0),            # one query row; rows past 1 see none
])
def test_flash_attention_matches_its_plain_version(card, dtype, d, sq, sk,
                                                   causal, window, q_offset):
    q, k, v = _qkv(2, 3, sq, sk, d, dtype, card)
    before = fa_kernel.flash_attention.launches
    y, lse = fa_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    want_y, want_lse = fa_ref.attention_ref(q, k, v, causal=causal,
                                            window=window, q_offset=q_offset)
    assert y.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(lse).all()
    assert (y.float() - want_y.float()).abs().max().item() <= FLASH_TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4


def test_flash_attention_rows_that_see_no_key(card):
    """q_offset 0 and a window of 0 mask every key: y = 0 and lse =
    log(1e-20), as the reference's isfinite guards give."""
    q, k, v = _qkv(1, 2, 70, 70, 128, torch.bfloat16, card)
    y, lse = fa_kernel.flash_attention(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert y.abs().max().item() == 0.0
    assert torch.allclose(lse, torch.full_like(lse, float(np.log(1e-20))))


def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(1, 2, 16, 16, 64, torch.bfloat16, card)
    before = fa_kernel.flash_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="expanded"):
        fa_kernel.flash_attention(q, k[:, :1].contiguous(),
                                  v[:, :1].contiguous())
    with pytest.raises(ValueError, match="16 bytes"):
        fa_kernel.flash_attention(*_qkv(1, 2, 16, 16, 300, torch.float32,
                                        card))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q.cpu(), k.cpu(), v.cpu())
    assert fa_kernel.flash_attention.launches == before
    # ops realigns and expands what the wrapper refuses
    y = fa_ops.attention(q[:, :, 1:], k, v, causal=False)
    assert y.shape == (1, 2, 15, 64)


@pytest.mark.parametrize("triangular,window", [(False, None), (True, None),
                                               (False, 24)])
def test_blocked_attention_grads_on_the_card(card, triangular, window):
    """The kernel-forward Function's grads against autograd through the
    plain reference attention, f32 2e-4 (tests/test_layers.py's bound)."""
    q, k, v = _qkv(2, 4, 256, 256, 128, torch.float32, card, seed=7)
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()      # GQA 4/2
    grads = []
    for fn in (lambda *a: layers.reference_attention(*a, causal=True,
                                                     window=window),
               lambda *a: layers.blocked_attention(
                   *a, causal=True, window=window, q_chunk=64, k_chunk=128,
                   triangular=triangular)):
        args = [t.detach().requires_grad_(True) for t in (q, k, v)]
        torch.sin(fn(*args).float()).sum().backward()
        grads.append([a.grad.float() for a in args])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 2e-4
