"""The port's new CUDA kernels against their plain versions at edge shapes.

These need the card and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

``chip_smoke.py`` holds the same kernels at the full sizes of their path;
here the shapes reach the corners the full sizes do not: rows of more
than 32 chunks of 16 bytes, fan-ins over 32, block_rows that are no
multiple of the warps of a block, depths clamped by the item count, a
grid with more sets than ways, addresses that wrap in int32, attention
tiles that the causal diagonal, the window, the tail or a query offset
cut, MoE dispatch and combine at T = 1, K = 1 and 8, and with every choice
dropped, and SSD scans of one chunk, one head, a ragged last chunk and
4,096 rows whose decay exponents would overflow above the diagonal.  The
last cases run the MoE and SSM model paths on the card and count their
launches.
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


@pytest.mark.parametrize("b,s,h,p,n,dtype,out", [
    (1, 64, 1, 8, 16, torch.float32, torch.float32),    # one chunk, H = 1
    (2, 100, 3, 8, 16, torch.float32, torch.float32),   # ragged last chunk
    (2, 256, 4, 64, 128, torch.bfloat16, torch.float32),  # mamba2's head
    (1, 192, 2, 128, 128, torch.bfloat16, torch.float32),  # jamba's head
    (2, 128, 4, 16, 8, torch.float32, torch.float32),   # test_kernels' shape
    (2, 128, 4, 16, 8, torch.bfloat16, torch.bfloat16),
])
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
    y = ssd_kernel.ssd_scan(*args, out_dtype=torch.float32)
    want = ssd_ref.ssd_chunked_ref(*args, chunk=256)
    assert torch.isfinite(y).all()
    assert _ssd_gate(y, want) <= 1.0


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

@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_model_paths_launch_the_kernels(card, arch):
    """Prefill and legacy decode of the smoke arch on the card launch the
    MoE and SSD kernels and agree with the same model on the CPU (float32:
    1e-3, kernel and plain version sum in other orders)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
    from repro_torch.models import api

    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    cpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu") \
        .to(card)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (2, 32)).astype(np.int32)
    counters = (moe_kernel.dispatch, moe_kernel.combine, ssd_kernel.ssd_scan)
    before = [f.launches for f in counters]
    with torch.no_grad():
        want = api.prefill(cpu, {"tokens": tok}, cfg, device="cpu")
        got = api.prefill(gpu, {"tokens": tok}, cfg, device=card)
        torch.cuda.synchronize()
        assert (got.cpu() - want).abs().max().item() <= 1e-3
        caches = [api.init_cache(cfg, 2, 8, device=d) for d in ("cpu", card)]
        for t in range(4):
            lo = [api.decode(m, tok[:, t:t + 1], c, cfg)[0]
                  for m, c in ((cpu, caches[0]), (gpu, caches[1]))]
            assert (lo[1].cpu() - lo[0]).abs().max().item() <= 1e-3
    moved = [f.launches - b for f, b in zip(counters, before)]
    has_moe = any(s.ffn == "moe" for s in cfg.pattern())
    has_ssm = any(s.mixer == "ssm" for s in cfg.pattern())
    assert (moved[0] > 0 and moved[1] > 0) == has_moe
    assert (moved[2] > 0) == has_ssm
