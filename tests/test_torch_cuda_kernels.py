"""The port's new CUDA kernels against their plain versions at edge shapes.

These need the card and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` holds the same kernels at the full sizes of their path;
here the shapes reach the corners the full sizes do not: rows of more
than 32 chunks of 16 bytes, fan-ins over 32, block_rows that are no
multiple of the warps of a block, both routes of the runahead gather
(TMA bulk copies and cp.async) at every depth 1 to 16 with rings that
wrap, depths clamped by the item count, a
grid with more sets than ways, addresses that wrap in int32, attention
tiles that the causal diagonal, the window, the tail or a query offset
cut, the wgmma route's tiles one past and one short (Sq, Sk around 128
query rows and 64 keys, D 64 and 128; whisper's encoder shape, 12
non-causal heads of 64 over 2,048 and 4,096 frames), paged decode
attention split across blocks at lengths that cross split boundaries,
zero-length rows, rep 1 to 8,
D 64, 80 and 128, pages of 16 and 32 and 8 rows of 4,096 tokens, MoE
dispatch and combine at T = 1, K = 1 and 8, and with every choice dropped
(combine bit for bit at T 1 to 4,096, its rows split over blocks and not),
the bag bit for bit against its kernel-order plain version where
deduplicating a batch's rows could go wrong (all-pad rows, one index K
times, repeats across lane 32 at K 33 and 40, phase 6's padded CSR, an
inf pad row under weight 0) at depths 1 to 8, D 4 to 512, and at S
65,536, where each warp walks many batches and its ring wraps,
the profiler's stack kernels at T 1, 31, 33 and 16,384, one-address and
negative streams, max_ways 1 and 32 and 1,024 sets,
and SSD scans of one chunk, one head, a ragged last chunk and
4,096 rows whose decay exponents would overflow above the diagonal, on
the scalar and the tensor-core route (P and N 64 and 128).  The
last cases run the MoE, SSM and encoder-decoder model paths on the card
and count their launches.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.cgra import cache_grid, presets
from repro_torch.core.cgra.reconfig import reconfigure, sample_streams
from repro_torch.core.cgra.trace import KERNELS
from repro_torch.core.runahead import allocate
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gather_runahead import gather_runahead as kernel
from repro_torch.kernels.gather_runahead import ops, ref
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import layers

pytestmark = pytest.mark.cuda
ARCHS = registry.list_archs()


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
@pytest.mark.parametrize("use", kernel.ROUTES)
def test_gathers_are_bit_identical(card, v, d, dtype, n, block_rows, depth,
                                   grid_blocks, use):
    table = _table(v, d, dtype, 0, card)
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, v, n).astype(np.int32)).to(card)
    want = _bits(ref.gather_ref(table, idx))
    out = kernel.runahead_gather(table, idx, block_rows=block_rows,
                                 depth=depth, grid_blocks=grid_blocks,
                                 use=use)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), want)
    assert torch.equal(_bits(kernel.pipelined_gather(table, idx)), want)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take(card):
    table = _table(64, 32, torch.float32, 0, card)
    idx = torch.zeros(12, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        kernel.runahead_gather(table, idx, block_rows=8)
    for depth in (0, kernel.MAX_RUNAHEAD_DEPTH + 1):
        with pytest.raises(ValueError, match="depth"):
            kernel.runahead_gather(table, idx, block_rows=4, depth=depth)
    with pytest.raises(ValueError, match="grid_blocks"):
        kernel.runahead_gather(table, idx, block_rows=4, grid_blocks=0)
    with pytest.raises(ValueError, match="16"):
        kernel.pipelined_gather(_table(64, 6, torch.float32, 0, card), idx)
    with pytest.raises(ValueError, match="int32"):
        kernel.pipelined_gather(table, idx.long())
    empty = kernel.runahead_gather(table, idx[:0])
    assert empty.shape == (0, 32)


@pytest.mark.parametrize("depth", range(9, 17))
@pytest.mark.parametrize("v,d,dtype,n,block_rows,grid_blocks", [
    (4096, 64, torch.float32, 8000, 8, None),
    (1000, 128, torch.bfloat16, 640, 2, 3),    # each block's ring wraps
    (300, 200, torch.float32, 36, 3, None),    # 12 tiles: depth clamps
])
@pytest.mark.parametrize("use", kernel.ROUTES)
def test_runahead_gather_at_the_allocators_depths(card, depth, v, d, dtype,
                                                   n, block_rows,
                                                   grid_blocks, use):
    """Depths 9 to 16, which ``core.runahead.allocate`` plans, bit for
    bit on both routes."""
    table = _table(v, d, dtype, 0, card)
    idx = torch.from_numpy(np.random.default_rng(depth).integers(
        0, v, n).astype(np.int32)).to(card)
    out = kernel.runahead_gather(table, idx, block_rows=block_rows,
                                 depth=depth, grid_blocks=grid_blocks,
                                 use=use)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref.gather_ref(table, idx)))
    assert torch.equal(_bits(ops.gather(table, idx, impl="runahead",
                                        block_rows=block_rows,
                                        depth=depth)), _bits(out))


def test_runahead_gather_ring_at_the_shared_memory_limit(card):
    """A ring of 16 one-row tiles that fills a block's shared memory
    exactly runs; 16 bytes more a row is refused, unless the depth clamps
    to fewer tiles first (the reference's min(depth, n_blocks))."""
    fits = kernel.MAX_SMEM_BYTES // (16 * 4)          # 3,632 f32: 14,528 B
    assert 16 * fits * 4 == kernel.MAX_SMEM_BYTES
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        0, 40, 64).astype(np.int32)).to(card)
    table = _table(40, fits, torch.float32, 0, card)
    out = kernel.runahead_gather(table, idx, block_rows=1, depth=16)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref.gather_ref(table, idx)))
    wide = _table(40, fits + 4, torch.float32, 0, card)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.runahead_gather(wide, idx, block_rows=1, depth=16)
    few = idx[:8]                                     # 8 tiles: depth 8
    out = kernel.runahead_gather(wide, few, block_rows=1, depth=16)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref.gather_ref(wide, few)))


# (row bytes, block_rows, depth) for every ring of rows of 16, 512 and
# 12,288 B and 1, 3, 8 and 16 rows a tile that fits a block
RINGS = [(row, rows, depth) for row in (16, 512, 12_288)
         for rows in (1, 3, 8, 16) for depth in range(1, 17)
         if depth * rows * row <= kernel.MAX_SMEM_BYTES]


@pytest.mark.parametrize("row_bytes,block_rows,depth", RINGS)
@pytest.mark.parametrize("use", kernel.ROUTES)
def test_runahead_gather_routes_at_every_depth(card, row_bytes, block_rows,
                                                depth, use):
    """Both routes bit for bit at every depth 1-16, f32 and bf16, on the
    grid that fills the card and on 1 and 7 blocks, with tiles enough that
    every block's ring wraps on the full grid too (one more than a ring
    for each block the card can hold, plus a ragged 3)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    smem = depth * (block_rows * row_bytes + kernel.BARRIER_BYTES) + 1024
    per_sm = min(32 if use == "bulk" else 8, 233_472 // smem)
    n = (sms * per_sm * (depth + 1) + 3) * block_rows
    rng = np.random.default_rng(depth)
    for dtype in (torch.float32, torch.bfloat16):
        d = row_bytes // torch.tensor([], dtype=dtype).element_size()
        v = 4096 if row_bytes < 12_288 else 1024
        table = _table(v, d, dtype, depth, card)
        idx = torch.from_numpy(rng.integers(0, v, n).astype(np.int32)) \
            .to(card)
        want = ref.gather_ref(table, idx).view(torch.uint8)
        for grid_blocks in (None, 1, 7):
            out = kernel.runahead_gather(table, idx, block_rows=block_rows,
                                         depth=depth, grid_blocks=grid_blocks,
                                         use=use)
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.uint8), want), (dtype,
                                                              grid_blocks)


def test_runahead_gather_counts_launches_by_route(card):
    """``route_launches`` counts each launch once, on the route it took:
    the route rule's without ``use``; ``use="bulk"`` is refused where the
    ring leaves no room for the barriers, and the cp_async route takes
    that ring."""
    fits = kernel.MAX_SMEM_BYTES // (16 * 4)          # the exact-limit ring
    table = _table(40, fits, torch.float32, 0, card)
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, 40, 64).astype(np.int32)).to(card)
    small = _table(64, 128, torch.float32, 0, card)
    before = dict(kernel.runahead_gather.route_launches)
    kernel.runahead_gather(small, idx, block_rows=8, depth=2)
    kernel.runahead_gather(small, idx, block_rows=8, depth=2,
                           use="cp_async")
    with pytest.raises(ValueError, match="barriers"):
        kernel.runahead_gather(table, idx, block_rows=1, depth=16,
                               use="bulk")
    out = kernel.runahead_gather(table, idx, block_rows=1, depth=16)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref.gather_ref(table, idx)))
    rule = kernel.route(512, 8, 2)
    want = dict(before)
    want[rule] += 1
    want["cp_async"] += 2
    assert kernel.runahead_gather.route_launches == want


@pytest.mark.parametrize("name", ["gcn_cora", "grad", "rgb"])
@pytest.mark.parametrize("window", [8192, None])
def test_reconfigure_profiles_on_the_card_as_on_the_cpu(card, name, window):
    """The §3.4 loop with its profile on the card: one cache_grid_scan
    launch per non-empty stream, and the CPU route's result bit for bit."""
    tr = KERNELS[name]()
    streams = sample_streams(tr, presets.RECONFIG, window)
    before = cache_grid.cache_grid_scan.launches
    got = reconfigure(tr, presets.RECONFIG, window=window)
    assert cache_grid.cache_grid_scan.launches - before == sum(
        a.size > 0 for a, _ in streams)
    want = reconfigure(tr, presets.RECONFIG, window=window, device="cpu")
    assert got.h_curves.tobytes() == want.h_curves.tobytes()
    assert (got.allocations, got.lines, got.profit, got.config) == \
        (want.allocations, want.lines, want.profit, want.config)


@pytest.mark.parametrize("seed", range(3))
def test_allocate_on_the_card_as_on_the_cpu(card, seed):
    rng = np.random.default_rng(seed)
    streams = {"zipf": rng.zipf(1.3, 20_000) % 5_000,
               "uniform": rng.integers(0, 50_000, 30_000),
               "loop": np.tile(np.arange(300), 40),
               "empty": np.zeros(0, np.int64)}
    rows = {"zipf": 12_288, "uniform": 256, "loop": 2_048}
    before = cache_grid.cache_grid_scan.launches
    got = allocate(streams, budget_tiles=16, row_bytes=rows)
    assert cache_grid.cache_grid_scan.launches - before == 3
    assert got == allocate(streams, budget_tiles=16, row_bytes=rows,
                           device="cpu")


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


def _bag_pattern(pattern, s, k, v, rng):
    """idx, w [S, K] of a shape that deduplicating a batch's rows could get
    wrong."""
    idx = rng.integers(1, v, (s, k))
    w = rng.normal(size=(s, k))
    if pattern == "all_pad":                   # every entry the pad
        idx[:], w[:] = 0, 0.0
    elif pattern == "one_index":               # K entries, one row each
        idx[:] = idx[:, :1]
    elif pattern == "straddle":                # repeats across lane 32
        idx = rng.integers(1, 5, (s, k))
        idx[:, 30:34] = idx[:, 29:30]
    elif pattern == "phase6":                  # padded CSR: pad 0, weight 0
        deg = np.minimum(rng.poisson(6.9, s), k)
        idx = (rng.zipf(1.5, (s, k)) % v).astype(np.int64)
        pad = np.arange(k)[None, :] >= deg[:, None]
        idx[pad], w[pad] = 0, 0.0
    return (torch.from_numpy(idx.astype(np.int32)),
            torch.from_numpy(w.astype(np.float32)))


@pytest.mark.parametrize("d,dtype", [
    (4, torch.float32), (128, torch.float32), (512, torch.float32),
    (8, torch.bfloat16),                       # bf16's narrowest 16-byte row
    (128, torch.bfloat16), (512, torch.bfloat16)])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("pattern,s,k", [
    ("all_pad", 512, 23), ("one_index", 512, 23), ("straddle", 512, 33),
    ("straddle", 512, 40), ("phase6", 4096, 23),
    ("straddle", 65536, 40), ("phase6", 65536, 23)])
def test_gather_bag_is_bit_identical_to_its_ordered_version(
        card, pattern, s, k, depth, d, dtype):
    """Each batch fetches its distinct rows once and every entry reads its
    leader's copy: the output is the kernel-order plain version's, bit for
    bit.  At S 65,536 every warp of the full grid walks many batches, so
    its ring of slots wraps."""
    v = 1000
    table = _table(v, d, dtype, 5, card)
    idx, w = _bag_pattern(pattern, s, k, v, np.random.default_rng(6))
    idx, w = idx.to(card), w.to(card)
    out = kernel.gather_bag(table, idx, w, depth=depth)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (s, d)
    assert torch.equal(_bits(out),
                       _bits(ref.gather_bag_ordered_ref(table, idx, w)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_gather_bag_keeps_zero_times_inf(card, dtype, depth):
    """A pad row of inf under weight 0: NaN exactly where the plain version
    gives NaN, the same bits everywhere else."""
    table = _table(1000, 128, dtype, 5, card)
    table[0, :64] = float("inf")
    idx, w = _bag_pattern("phase6", 4096, 23, 1000, np.random.default_rng(7))
    idx, w = idx.to(card), w.to(card)
    out = kernel.gather_bag(table, idx, w, depth=depth).float().cpu()
    want = ref.gather_bag_ordered_ref(table, idx, w).float().cpu()
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(out), nan)
    assert torch.equal(torch.isnan(ref.gather_bag_ref(table, idx, w))
                       .cpu(), nan)
    assert torch.equal(out[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


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


def test_gather_bag_takes_any_depth_at_any_fan_in(card):
    """The ring holds one batch of 32 rows whatever the depth, so shapes
    whose depth x K rows of 2 KB passed a block's shared memory run; an
    empty bag (K 0) is zeros."""
    table = _table(64, 512, torch.float32, 0, card)   # 2048-byte rows
    rng = np.random.default_rng(8)
    for k, depth in ((113, 8), (200, 2), (0, 4)):
        idx = torch.from_numpy(rng.integers(0, 64, (9, k)).astype(np.int32))
        w = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32))
        idx, w = idx.to(card), w.to(card)
        out = kernel.gather_bag(table, idx, w, depth=depth)
        assert torch.equal(_bits(out),
                           _bits(ref.gather_bag_ordered_ref(table, idx, w)))
    assert kernel.bag_warps_per_sm(table, 23) >= 1


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


GRID_STREAMS = {
    "uniform": lambda rng, t: rng.integers(0, 1 << 14, t),
    "one_address": lambda rng, t: np.full(t, 4100),
    # negative int32 after the wrap, and tag -1 (hits a cold set)
    "negative": lambda rng, t: np.where(rng.random(t) < 0.5,
                                        2**32 - 1 - rng.integers(0, 256, t),
                                        rng.integers(0, 1 << 12, t) + 2**31),
}
GRIDS = {
    "max_ways_1": ((1024, [0, 1], (16, 64)), 1),
    "max_ways_32": ((512, [1, 3, 8, 32], (16, 32, 64, 128)), 32),
}


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("stream", sorted(GRID_STREAMS))
@pytest.mark.parametrize("t_len", [1, 31, 33, 16_384])
def test_cache_grid_stack_kernels_are_exact(card, t_len, stream, grid_name):
    """The stack and expand kernels against the plain step-by-step version
    on the host and the stack version in the kernels' order."""
    args, max_ways = GRIDS[grid_name]
    grid = cache_grid.ConfigGrid.build(*args)
    assert grid.max_ways == max_ways
    addrs = GRID_STREAMS[stream](np.random.default_rng(t_len), t_len)
    a = cache_grid.as_int32(addrs, card)
    before = cache_grid.cache_grid_scan.launches
    got = cache_grid.cache_grid_scan(a, grid)
    torch.cuda.synchronize()
    assert cache_grid.cache_grid_scan.launches == before + 1
    host = a.cpu()
    assert torch.equal(got.cpu(), cache_grid.hit_series_ref(host, grid))
    assert torch.equal(got.cpu(), cache_grid.hit_series_stack_ref(host, grid))


def test_cache_grid_kernel_takes_sets_past_shared_memory(card):
    """1,024 sets x 32 ways of tags and stamps (262,144 bytes) were past
    the shared memory of the old one-warp-per-configuration kernel; the
    stacks live in registers, one warp per set."""
    grid = cache_grid.ConfigGrid.build(16384, [32], [16])
    assert (grid.max_sets, grid.max_ways) == (1024, 32)
    rng = np.random.default_rng(9)
    addrs = rng.integers(0, 1 << 20, 16_384)
    addrs[1::3] = addrs[::3][:len(addrs[1::3])] + 16 * 1024  # same set
    a = cache_grid.as_int32(addrs, card)
    got = cache_grid.cache_grid_scan(a, grid)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cache_grid.hit_series_ref(a.cpu(), grid))
    assert got.any() and not got.all()


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


def _tiled_gate(y, q, k, v, route, **mask):
    """y against the kernel-order plain version at the route's key tile:
    summation order may move y's rounding by an ulp (2^-7 |y|) and one p's
    by an ulp (2^-7 p_max |v|); two of each, plus 1e-4."""
    want, _, p_max = fa_ref.attention_tiled(
        q, k, v, key_tile=fa_ref.KEY_TILES[route], **mask)
    want = want.float()
    tol = 2.0 ** -6 * (want.abs() + p_max[..., None]
                       * v.float().abs().max()) + 1e-4
    return ((y.float() - want).abs() / tol).max().item()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk", [(127, 63), (129, 65), (128, 64),
                                   (1, 64), (255, 129), (257, 191)])
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (False, None, 0), (True, 40, 0), (True, None, 61)])
def test_flash_attention_at_the_wgmma_tile_edges(card, d, sq, sk, causal,
                                                 window, q_offset):
    """The tensor-core route at Sq one past and one short of its 128-row
    query tile and Sk of its 64-key tile: the TMA boxes past S zero-fill
    inside their head, the diagonal and tail tiles mask."""
    q, k, v = _qkv(2, 3, sq, sk, d, torch.bfloat16, card, seed=9)
    assert fa_kernel.route(q.dtype, d) == "mma"
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    y, lse = fa_kernel.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    want_y, want_lse = fa_ref.attention_ref(q, k, v, **mask)
    assert torch.isfinite(y.float()).all() and torch.isfinite(lse).all()
    assert (y.float() - want_y.float()).abs().max().item() \
        <= FLASH_TOL[torch.bfloat16]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    assert _tiled_gate(y, q, k, v, "mma", **mask) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [2048, 4096])
def test_flash_attention_at_whispers_encoder_shape(card, dtype, s):
    """whisper-small's encoder self-attention: non-causal, 12 heads of 64
    (bf16 takes the wgmma route, f32 the scalar one, as in chip_smoke.py
    phase 14's float32 check) over 2,048 and 4,096 frames."""
    q, k, v = _qkv(2, 12, s, s, 64, dtype, card, seed=11)
    before = fa_kernel.flash_attention.launches
    y, lse = fa_kernel.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    want_y, want_lse = fa_ref.attention_ref(q, k, v, causal=False)
    assert torch.isfinite(y.float()).all() and torch.isfinite(lse).all()
    assert (y.float() - want_y.float()).abs().max().item() <= FLASH_TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    route = fa_kernel.route(dtype, 64)
    assert route == ("mma" if dtype == torch.bfloat16 else "simt")
    if dtype == torch.bfloat16:
        assert _tiled_gate(y, q, k, v, route, causal=False) <= 1.0


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


# ---------------------------------------------------------------------------
# paged decode attention, split across blocks
# ---------------------------------------------------------------------------

PAGED_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


def _pages(b, h, hkv, d, page, pps, dtype, device, seed=3):
    gen = torch.Generator().manual_seed(seed)
    n_pages = 1 + b * pps
    table = (torch.randperm(n_pages - 1, generator=gen)[:b * pps] + 1) \
        .reshape(b, pps).to(torch.int32).to(device)
    q = torch.randn(b, h, d, generator=gen).to(dtype).to(device)
    kp, vp = (torch.randn(n_pages, page, hkv, d, generator=gen).to(dtype)
              .to(device) for _ in range(2))
    return q, kp, vp, table


def _paged_lengths(b, page, pps, hkv):
    """Lengths one short of, at and one past split boundaries, a zero-length
    row and a full one, cycled over b rows."""
    n = pa_kernel.n_splits(b, hkv, pps, page)
    run = -(-pps // n) * page
    lens = [0, pps * page, 1]
    for edge in sorted({run, (n // 2) * run, (n - 1) * run} - {0}):
        lens += [edge - 1, edge, edge + 1]
    return [lens[i % len(lens)] for i in range(b)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,hkv,d,page,pps", [
    (8, 12, 2, 128, 16, 32),       # the serving path: qwen2-1.5b's heads
    (8, 12, 2, 128, 16, 256),      # 8 rows of 4,096 tokens
    (12, 4, 4, 64, 16, 8),         # rep 1
    (9, 8, 4, 80, 32, 8),          # rep 2, D 80, page 32
    (9, 48, 8, 128, 16, 24),       # rep 6 (dbrx-132b)
    (9, 16, 2, 128, 32, 12),       # rep 8, page 32
])
def test_paged_attention_matches_its_plain_versions(card, dtype, b, h, hkv,
                                                    d, page, pps):
    """The split kernel against the plain version within bf16 3e-2 / f32
    1e-4, and elementwise against the split plain version at the wrapper's
    split count (the two differ by float32 summation order only: an ulp of
    the output, 2^-7 |y| in bf16, plus 1e-5)."""
    q, kp, vp, table = _pages(b, h, hkv, d, page, pps, dtype, card)
    if pps == 256:
        lengths = [pps * page] * b
    else:
        lengths = _paged_lengths(b, page, pps, hkv)
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = pa_kernel.paged_attention.launches
    out = pa_kernel.paged_attention(q, kp, vp, table, ln)
    torch.cuda.synchronize()
    assert pa_kernel.paged_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    want = pa_ref.paged_attention_ref(q, kp, vp, table, ln).float()
    assert (out.float() - want).abs().max().item() <= PAGED_TOL[dtype]
    split = pa_ref.paged_attention_split(
        q, kp, vp, table, ln,
        pa_kernel.n_splits(b, hkv, pps, page)).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    assert bool(((out.float() - split).abs()
                 <= ulp * split.abs() + 1e-5).all())
    for i, n in enumerate(lengths):
        if n == 0:
            assert out[i].abs().max().item() == 0.0


def test_paged_attention_refuses_what_the_kernel_does_not_take(card):
    q, kp, vp, table = _pages(2, 4, 2, 64, 16, 4, torch.bfloat16, card)
    ln = torch.tensor([5, 64], dtype=torch.int32, device=card)
    before = pa_kernel.paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        pa_kernel.paged_attention(q.cpu(), kp.cpu(), vp.cpu(), table.cpu(),
                                  ln.cpu())
    with pytest.raises(ValueError, match="int32"):
        pa_kernel.paged_attention(q, kp, vp, table.long(), ln)
    with pytest.raises(ValueError, match="16 bytes"):
        f = _pages(2, 4, 2, 6, 16, 4, torch.float32, card)
        pa_kernel.paged_attention(*f, ln)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
        pa_kernel.paged_attention(flat[1:].view(q.shape), kp, vp, table, ln)
    with pytest.raises(ValueError, match="dtype"):
        pa_kernel.paged_attention(q, kp.float(), vp, table, ln)
    assert pa_kernel.paged_attention.launches == before


# ---------------------------------------------------------------------------
# MoE dispatch / combine
# ---------------------------------------------------------------------------

def _slots(rng, t, k, n_slots, drop):
    """Distinct kept slots for a share of the T x K choices, -1 the rest."""
    flat = np.full(t * k, -1, np.int32)
    n_keep = min(n_slots, int(round(t * k * (1 - drop))))
    flat[rng.choice(t * k, size=n_keep, replace=False)] = \
        rng.permutation(n_slots)[:n_keep]
    return flat.reshape(t, k)


@pytest.mark.parametrize("t,k,d,dtype,n_slots,drop", [
    (1, 1, 6144, torch.bfloat16, 4, 0.0),      # T = 1
    (8, 4, 6144, torch.bfloat16, 64, 0.1),     # dbrx decode shape
    (64, 4, 6144, torch.bfloat16, 320, 0.3),   # dbrx prefill chunk
    (33, 1, 4, torch.float32, 40, 0.5),        # K = 1; one 16-byte chunk
    (20, 2, 200, torch.float32, 30, 1.0),      # every choice dropped
    (17, 8, 96, torch.float32, 100, 0.4),      # K = 8, rows of 24 chunks
])
def test_dispatch_is_bit_identical(card, t, k, d, dtype, n_slots, drop):
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref

    rng = np.random.default_rng(t)
    x = _table(t, d, dtype, 1, card)
    slot = torch.from_numpy(_slots(rng, t, k, n_slots, drop)).to(card)
    for s in ((slot, slot[:, 0].contiguous()) if k == 1 else (slot,)):
        before = moe_kernel.dispatch.launches
        out = moe_kernel.dispatch(x, s, n_slots)
        torch.cuda.synchronize()
        assert moe_kernel.dispatch.launches == before + 1
        assert torch.equal(_bits(out), _bits(moe_ref.dispatch_ref(x, s,
                                                                  n_slots)))


@pytest.mark.parametrize("t,k,d,dtype,drop", [
    (1, 4, 6144, torch.bfloat16, 0.0),         # T = 1
    (8, 4, 6144, torch.bfloat16, 0.2),         # dbrx decode shape
    (63, 4, 6144, torch.float32, 0.3),         # rows of 1,536 chunks
    (40, 1, 128, torch.bfloat16, 0.1),         # K = 1
    (17, 8, 96, torch.float32, 0.5),           # K = 8, rows of 24 chunks
    (12, 2, 64, torch.bfloat16, 1.0),          # every choice dropped
])
def test_combine_within_one_rounding(card, t, k, d, dtype, drop):
    """Against the plain version that sums in the kernel's order: float32
    by at most K 2^-23 sum|w x| (the kernel and the plain version both
    round each product, then each sum), bfloat16 within one more bf16
    rounding (2^-8 of the value)."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref

    rng = np.random.default_rng(k)
    n_slots = max(1, t * k)
    ye = _table(n_slots, d, dtype, 2, card)
    slot = torch.from_numpy(_slots(rng, t, k, n_slots, drop)).to(card)
    w = torch.from_numpy(rng.random((t, k)).astype(np.float32)).to(card)
    out = moe_kernel.combine(ye, slot, w)
    torch.cuda.synchronize()
    want = moe_ref.combine_ref(ye, slot, w).float()
    tol = k * 2.0**-23 * moe_ref.combine_ref(ye.float().abs(), slot,
                                             w.abs()).float()
    if dtype == torch.bfloat16:
        tol = tol + 2.0**-8 * want.abs()
    assert out.dtype == dtype and out.shape == (t, d)
    assert bool(((out.float() - want).abs() <= tol).all())
    if drop == 1.0:
        assert out.abs().max().item() == 0.0


COMBINE_BITS_CASES = [
    (t, k, 6144, dtype, 0.25)
    for t in (1, 8, 64, 4096) for k in (1, 4, 8)
    for dtype in (torch.bfloat16, torch.float32)
] + [
    (8, 4, 96, torch.float32, 0.3),            # 24 chunks: one part
    (8, 4, 6144, torch.bfloat16, 1.0),         # every choice dropped, parts
    (4096, 4, 128, torch.bfloat16, 1.0),       # every choice dropped, one
]


@pytest.mark.parametrize("t,k,d,dtype,drop", COMBINE_BITS_CASES)
def test_combine_is_bit_identical_to_its_plain_version(card, t, k, d, dtype,
                                                       drop):
    """Both round each f32 product, add in k order and round once to ye's
    type, so they agree bit for bit, whether a token's row is split over
    blocks (few tokens) or not."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.moe_dispatch import ref as moe_ref

    rng = np.random.default_rng(100 * t + k)
    n_slots = t * k
    ye = _table(n_slots, d, dtype, 3, card)
    slot = torch.from_numpy(_slots(rng, t, k, n_slots, drop)).to(card)
    w = torch.from_numpy(rng.random((t, k)).astype(np.float32)).to(card)
    row_bytes = d * ye.element_size()
    parts = moe_kernel.combine_parts(t, row_bytes)
    assert (parts == 1) == (t >= 264 or row_bytes // 16 < 64)
    before = moe_kernel.combine.launches
    out = moe_kernel.combine(ye, slot, w)
    torch.cuda.synchronize()
    assert moe_kernel.combine.launches == before + 1
    assert torch.equal(_bits(out), _bits(moe_ref.combine_ref(ye, slot, w)))
    if drop == 1.0:
        assert out.abs().max().item() == 0.0


def test_moe_wrappers_refuse_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel

    x = _table(4, 64, torch.bfloat16, 0, card)
    slot = torch.zeros(4, 2, dtype=torch.int32, device=card)
    w = torch.ones(4, 2, device=card)
    before = (moe_kernel.dispatch.launches, moe_kernel.combine.launches)
    with pytest.raises(ValueError, match="int32"):
        moe_kernel.dispatch(x, slot.long(), 8)
    with pytest.raises(ValueError, match="16"):
        moe_kernel.dispatch(_table(4, 6, torch.float32, 0, card), slot, 8)
    with pytest.raises(ValueError, match="fan-in"):
        moe_kernel.dispatch(x, torch.zeros(4, 9, dtype=torch.int32,
                                           device=card), 8)
    with pytest.raises(ValueError, match="fan-in"):
        moe_kernel.combine(x, torch.zeros(4, 9, dtype=torch.int32,
                                          device=card),
                           torch.ones(4, 9, device=card))
    with pytest.raises(ValueError, match="float32 weights"):
        moe_kernel.combine(x, slot, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.combine(x.cpu(), slot.cpu(), w.cpu())
    assert (moe_kernel.dispatch.launches,
            moe_kernel.combine.launches) == before


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, dtype, device, seed=0, a_log=None):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    dt = torch.nn.functional.softplus(0.5 * f(b, s, h))      # ~0.7, as init
    a = (torch.zeros(h) if a_log is None else
         torch.from_numpy(rng.uniform(*a_log, h).astype(np.float32)))
    xs = [f(b, s, h, p).to(dtype), dt, a, f(b, s, n).to(dtype),
          f(b, s, n).to(dtype), f(h)]
    return [t.to(device) for t in xs]


def _ssd_gate(y, want):
    """Elementwise relative: |dy| <= 1e-4 |want| + 1e-5 max|want|."""
    tol = 1e-4 * want.abs() + 1e-5 * want.abs().max()
    return ((y.float() - want).abs() / tol).max().item()


SSD_CASES = [
    (1, 64, 1, 8, 16, torch.float32, torch.float32),    # one chunk, H = 1
    (2, 100, 3, 8, 16, torch.float32, torch.float32),   # ragged last chunk
    (2, 256, 4, 64, 128, torch.bfloat16, torch.float32),  # mamba2's head
    (1, 192, 2, 128, 128, torch.bfloat16, torch.float32),  # jamba's head
    (2, 128, 4, 16, 8, torch.float32, torch.float32),   # test_kernels' shape
    (2, 128, 4, 16, 8, torch.bfloat16, torch.bfloat16),
]
SSD_ROUTES = ["simt", "simt", "mma", "mma", "simt", "simt"]


@pytest.mark.parametrize("b,s,h,p,n,dtype,out", SSD_CASES)
def test_ssd_scan_matches_the_plain_versions(card, b, s, h, p, n, dtype,
                                             out):
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    args = _ssd_inputs(b, s, h, p, n, dtype, card, a_log=(-1, 0.3))
    before = ssd_kernel.ssd_scan.launches
    y = ssd_kernel.ssd_scan(*args, out_dtype=out)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.launches == before + 1
    assert y.dtype == out and y.shape == (b, s, h, p)
    chunked = ssd_ref.ssd_chunked_ref(*args, chunk=64)
    naive, _ = ssd_ref.ssd_ref(*args)
    if out == torch.bfloat16:   # one bf16 rounding of y
        for want in (chunked, naive):
            assert bool(((y.float() - want).abs()
                         <= 2.0**-8 * want.abs() + 1e-4).all())
    else:
        assert _ssd_gate(y, chunked) <= 1.0
        assert _ssd_gate(y, naive) <= 1.0


def test_ssd_scan_masks_before_the_exponential(card):
    """dt ~ 0.7 and A = -1 over 4,096 rows: the exponent above the
    diagonal reaches ~45 in a 64-row chunk and cum ~ -2,900 at the end;
    y stays finite and equal to the plain version at chunk 256 (exponents
    to ~180, masked before exp)."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    args = _ssd_inputs(1, 4096, 2, 64, 128, torch.bfloat16, card)
    assert ssd_kernel.route(torch.bfloat16, 64, 128) == "mma"
    before = ssd_kernel.ssd_scan.route_launches["mma"]
    y = ssd_kernel.ssd_scan(*args, out_dtype=torch.float32)
    assert ssd_kernel.ssd_scan.route_launches["mma"] == before + 1
    want = ssd_ref.ssd_chunked_ref(*args, chunk=256)
    assert torch.isfinite(y).all()
    assert _ssd_gate(y, want) <= 1.0


@pytest.mark.parametrize("case,want", list(zip(SSD_CASES, SSD_ROUTES)))
def test_ssd_scan_route_of_each_case(card, case, want):
    """bf16 heads of P, N in {64, 128} take the tensor cores, the rest the
    scalar kernel; the launch is counted under its route."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    b, s, h, p, n, dtype, out = case
    assert ssd_kernel.route(dtype, p, n) == want
    before = dict(ssd_kernel.ssd_scan.route_launches)
    ssd_kernel.ssd_scan(*_ssd_inputs(b, s, h, p, n, dtype, card),
                        out_dtype=out)
    torch.cuda.synchronize()
    after = ssd_kernel.ssd_scan.route_launches
    assert {k: after[k] - before[k] for k in after} == {
        r: int(r == want) for r in ("simt", "mma")}


@pytest.mark.parametrize("a_log", [None, (-1, 0.3)])
@pytest.mark.parametrize("b,s,h,p,n,out", [
    (2, 256, 4, 64, 128, torch.float32),    # mamba2's head
    (1, 192, 2, 128, 128, torch.float32),   # jamba's head
    (1, 100, 3, 64, 128, torch.float32),    # ragged last sub-chunk
    (1, 130, 2, 128, 64, torch.float32),    # N 64, ragged
    (2, 64, 1, 64, 64, torch.float32),      # one sub-chunk
    (2, 256, 4, 64, 128, torch.bfloat16),   # y in bf16
])
def test_ssd_scan_mma_route_matches_the_plain_versions(card, b, s, h, p, n,
                                                       out, a_log):
    """The tensor-core route within the elementwise gate of the float32
    chunked form (at the kernel's 64 and the model's 256), the per-token
    recurrence and the split-bf16 plain version in the kernel's order; a
    bf16 y within one bf16 rounding of them."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    args = _ssd_inputs(b, s, h, p, n, torch.bfloat16, card, a_log=a_log)
    assert ssd_kernel.route(torch.bfloat16, p, n) == "mma"
    y = ssd_kernel.ssd_scan(*args, out_dtype=out)
    torch.cuda.synchronize()
    assert y.dtype == out and y.shape == (b, s, h, p)
    wants = [ssd_ref.ssd_chunked_ref(*args, chunk=64),
             ssd_ref.ssd_chunked_ref(*args, chunk=256),
             ssd_ref.ssd_ref(*args)[0],
             ssd_ref.ssd_chunked_split(*args, pieces=2)]
    for want in wants:
        if out == torch.bfloat16:   # one bf16 rounding on top of the gate
            tol = (2.0**-8 + 1e-4) * want.abs() + 1e-5 * want.abs().max()
            assert bool(((y.float() - want).abs() <= tol).all())
        else:
            assert _ssd_gate(y, want) <= 1.0


def test_ssd_scan_simt_route_on_request(card):
    """``use="simt"`` runs the scalar kernel on operands the mma route
    would take (chip_smoke.py times the two); "mma" on operands it does
    not take is refused."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    args = _ssd_inputs(1, 128, 2, 64, 128, torch.bfloat16, card)
    before = dict(ssd_kernel.ssd_scan.route_launches)
    y = ssd_kernel.ssd_scan(*args, out_dtype=torch.float32, use="simt")
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.route_launches["simt"] == before["simt"] + 1
    assert ssd_kernel.ssd_scan.route_launches["mma"] == before["mma"]
    assert _ssd_gate(y, ssd_ref.ssd_chunked_ref(*args, chunk=64)) <= 1.0
    small = _ssd_inputs(1, 64, 1, 8, 16, torch.bfloat16, card)
    with pytest.raises(ValueError, match="does not take"):
        ssd_kernel.ssd_scan(*small, use="mma")


def test_ssd_scan_refuses_what_the_kernel_does_not_take(card):
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    args = _ssd_inputs(1, 64, 2, 8, 16, torch.float32, card)
    before = ssd_kernel.ssd_scan.launches
    with pytest.raises(ValueError, match="1..128"):
        ssd_kernel.ssd_scan(*_ssd_inputs(1, 64, 1, 256, 16, torch.float32,
                                         card))
    with pytest.raises(ValueError, match="one dtype"):
        ssd_kernel.ssd_scan(args[0], args[1], args[2],
                            args[3].to(torch.bfloat16), args[4], args[5])
    with pytest.raises(ValueError, match="float32"):
        ssd_kernel.ssd_scan(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(*[a.cpu() for a in args])
    assert ssd_kernel.ssd_scan.launches == before


# ---------------------------------------------------------------------------
# the model paths reach the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_paths_launch_the_kernels(card, arch):
    """Prefill at B 2 x S 2,048 and 4 legacy decode steps of each registry
    arch's smoke model on the card launch the kernels of its layers
    (flash attention where a layer attends, through blocked attention at
    that length; MoE dispatch and combine; the SSD scan) and agree with
    the same model on the CPU (float32: 1e-3, kernel and plain version
    sum in other orders)."""
    import dataclasses

    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
    from repro_torch.models import api
    from repro_torch.models.types import ShapeConfig

    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    cpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu") \
        .to(card)
    batch = synthetic_batch(cfg, ShapeConfig("p", "prefill", 2048, 2),
                            seed=0, step=0)
    batch.pop("labels", None)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (2, 8)).astype(np.int32)
    counters = (fa_kernel.flash_attention, moe_kernel.dispatch,
                moe_kernel.combine, ssd_kernel.ssd_scan)
    before = [f.launches for f in counters]
    with torch.no_grad():
        want = api.prefill(cpu, batch, cfg, device="cpu")
        got = api.prefill(gpu, batch, cfg, device=card)
        torch.cuda.synchronize()
        assert (got.cpu() - want).abs().max().item() <= 1e-3
        caches = [api.init_cache(cfg, 2, 8, device=d) for d in ("cpu", card)]
        for t in range(4):
            lo = [api.decode(m, tok[:, t:t + 1], c, cfg)[0]
                  for m, c in ((cpu, caches[0]), (gpu, caches[1]))]
            assert (lo[1].cpu() - lo[0]).abs().max().item() <= 1e-3
    moved = [f.launches - b for f, b in zip(counters, before)]
    pattern = cfg.pattern()
    has_attn = cfg.family == "encdec" or any(s.mixer == "attn"
                                             for s in pattern)
    has_moe = any(s.ffn == "moe" for s in pattern)
    has_ssm = any(s.mixer == "ssm" for s in pattern)
    assert (moved[0] > 0) == has_attn
    assert (moved[1] > 0 and moved[2] > 0) == has_moe
    assert (moved[3] > 0) == has_ssm


# ---------------------------------------------------------------------------
# the custom ops: each fake against its kernel
# ---------------------------------------------------------------------------

def _op_cases(card):
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel

    gen = torch.Generator(device=card).manual_seed(7)
    bf = dict(device=card, dtype=torch.bfloat16)
    q, k, v = (torch.randn(2, 4, 256, 128, generator=gen, **bf)
               for _ in range(3))
    x = torch.randn(64, 128, generator=gen, **bf)
    slot = torch.randperm(64, device=card, generator=gen)[:64].reshape(
        16, 4).to(torch.int32)
    return {
        "flash_attention": ((q, k, v), (True, 96, 0),
                            fa_kernel.flash_attention),
        "moe_dispatch": ((x[:16], slot, 64), (), moe_kernel.dispatch),
        "moe_combine": ((x, slot, torch.rand(16, 4, generator=gen,
                                             device=card)), (),
                        moe_kernel.combine),
        "ssd_scan": (tuple(_ssd_inputs(2, 128, 2, 64, 128, torch.bfloat16,
                                       card)), (64, torch.float32),
                     ssd_kernel.ssd_scan)}


@pytest.mark.parametrize("name", ["flash_attention", "moe_dispatch",
                                  "moe_combine", "ssd_scan"])
def test_custom_op_fake_matches_its_kernel(card, name):
    """The op on CUDA tensors launches the kernel once; its fake, on meta
    tensors and under FakeTensorMode, gives the same output shapes,
    dtypes and strides and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    tensors, rest, kernel_fn = _op_cases(card)[name]
    args = [t for t in tensors if isinstance(t, torch.Tensor)]
    extra = [t for t in tensors if not isinstance(t, torch.Tensor)]
    op = getattr(torch.ops.repro_torch, name)
    before = kernel_fn.launches
    got = op(*args, *extra, *rest)
    torch.cuda.synchronize()
    assert kernel_fn.launches == before + 1
    meta = op(*(t.to("meta") for t in args), *extra, *rest)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(t) for t in args), *extra, *rest)

    def layout(out):
        outs = out if isinstance(out, tuple) else (out,)
        return [(tuple(t.shape), t.dtype, t.stride()) for t in outs]

    assert layout(meta) == layout(fake) == layout(got)
    assert kernel_fn.launches == before + 1


def test_encdec_path_launches_flash_once_an_encoder_layer(card):
    """whisper-small's smoke model at 2,048 frames: the encoder's blocked
    attention runs the flash kernel once a layer in prefill and in
    ``encode``; prefill and 4 decode steps on ``precompute_cross``'s K/V
    agree with the same model on the CPU (float32, 1e-3)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import api, encdec

    cfg = dataclasses.replace(registry.smoke("whisper-small"),
                              dtype="float32")
    cpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu") \
        .to(card)
    rng = np.random.default_rng(0)
    batch = {"frames": rng.normal(size=(2, 2048, cfg.d_model))
             .astype(np.float32),
             "dec_tokens": rng.integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32)}
    before = fa_kernel.flash_attention.launches
    with torch.no_grad():
        want = api.prefill(cpu, batch, cfg, device="cpu")
        got = api.prefill(gpu, batch, cfg, device=card)
        torch.cuda.synchronize()
        assert fa_kernel.flash_attention.launches \
            == before + cfg.n_encoder_layers
        assert (got.cpu() - want).abs().max().item() <= 1e-3
        caches = []
        for m, d in ((cpu, "cpu"), (gpu, card)):
            c = api.init_cache(cfg, 2, 8, device=d)
            frames = torch.from_numpy(batch["frames"]).to(d)
            c["cross_k"], c["cross_v"] = encdec.precompute_cross(
                m, encdec.encode(m, frames, cfg), cfg)
            caches.append(c)
        assert fa_kernel.flash_attention.launches \
            == before + 2 * cfg.n_encoder_layers
        tok = batch["dec_tokens"]
        for t in range(4):
            lo = [api.decode(m, tok[:, t:t + 1], c, cfg)[0]
                  for m, c in ((cpu, caches[0]), (gpu, caches[1]))]
            assert (lo[1].cpu() - lo[0]).abs().max().item() <= 1e-3
