"""The port's new CUDA kernels against their plain versions at edge shapes.

These need the card and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` holds the same kernels at the full sizes of their path;
here the shapes reach the corners the full sizes do not: rows of more
than 32 chunks of 16 bytes, fan-ins over 32, block_rows that are no
multiple of the warps of a block, depths clamped by the item count, a
grid with more sets than ways, and addresses that wrap in int32.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.cgra import cache_grid
from repro_torch.kernels.gather_runahead import gather_runahead as kernel
from repro_torch.kernels.gather_runahead import ops, ref

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
