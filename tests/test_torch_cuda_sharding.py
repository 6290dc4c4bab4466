"""The sharding layer's kernel call sites on the card, over a one-rank
NCCL mesh (1, 1).  These need the card and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharding.py

Every ctypes kernel wrapper refuses a CUDA DTensor with ``TypeError``
before it reads ``data_ptr()`` (tests/test_torch_dtensor_sites.py holds
the same with CPU DTensors); blocked attention (the flash kernel's
forward, one launch, and the plain backward), the MoE dispatch and
combine (routing and dispatch in one region, combine in another), the
SSD scan and the paged decode read, each in its ``local_map`` region at
(1, 1), give their plain calls' values bit for bit, and gradients too.
The paged read's per-shard body, called for each of 4 simulated "model"
ranks' query heads, gives the unsharded kernel's heads bit for bit, and
the kernel reading a run of KV heads that starts past 0 matches its plain
versions as the whole-pool call does (tests/test_torch_cuda_kernels.py's
tolerances).
"""
import dataclasses
import datetime
import types

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import sharding
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers, moe, paged_lm, ssm
from repro_torch.sharding.rules import MeshRules
from test_torch_cuda_kernels import PAGED_TOL, _pages
from test_torch_dtensor_sites import WRAPPERS

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120),
                            device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _on_mesh(mesh, t, placements=None):
    return distribute_tensor(t, mesh, placements or [Replicate()] * 2,
                             src_data_rank=None)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_kernel_wrappers_refuse_a_cuda_dtensor(nccl_mesh, name, monkeypatch):
    def read(self):
        raise AssertionError("the wrapper read a DTensor's data_ptr()")

    monkeypatch.setattr(DTensor, "data_ptr", read)
    with pytest.raises(TypeError, match="DTensor"):
        WRAPPERS[name](lambda t: _on_mesh(nccl_mesh, t.cuda()))


@pytest.mark.parametrize("name", ["flash_attention", "moe_dispatch",
                                  "moe_combine", "ssd_scan"])
def test_custom_ops_refuse_a_cuda_dtensor(nccl_mesh, name, monkeypatch):
    """The ops-level wrapper refuses a CUDA DTensor with TypeError; the
    custom op itself, called directly, raises (DTensor has no sharding
    rule for it) before any kernel launches or reads a pointer."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from test_torch_cuda_kernels import _op_cases

    def read(self):
        raise AssertionError("a DTensor's data_ptr() was read")

    tensors, rest, kernel_fn = _op_cases(torch.device("cuda"))[name]
    d = [_on_mesh(nccl_mesh, t) if isinstance(t, torch.Tensor) else t
         for t in tensors]
    wrapper = {"flash_attention": lambda: fa_ops.attention(*d[:3]),
               "moe_dispatch": lambda: moe_ops.dispatch(d[0], d[1],
                                                        n_slots=d[2]),
               "moe_combine": lambda: moe_ops.combine(*d),
               "ssd_scan": lambda: ssd_ops.ssd(*d)}[name]
    monkeypatch.setattr(DTensor, "data_ptr", read)
    before = kernel_fn.launches
    with pytest.raises(TypeError, match="DTensor"):
        wrapper()
    with pytest.raises(Exception) as err:
        getattr(torch.ops.repro_torch, name)(*d, *rest)
    assert not isinstance(err.value, AssertionError), err.value
    assert kernel_fn.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_site_in_local_map_equals_the_plain_call(nccl_mesh, dtype):
    """blocked_attention on DTensors at (1, 1) under the rules' constraints:
    the kernel runs on the local shards (one launch), the plain backward
    too; output and grads equal the plain call's bit for bit."""
    rules = MeshRules(nccl_mesh)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, dy = (torch.randn(2, h, 2048, 128, generator=gen, device="cuda",
                               dtype=dtype) for h in (12, 2, 2, 12))

    def run(q, k, v):
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        y = layers.blocked_attention(q, k, v, causal=True)
        return y, torch.autograd.grad(y, (q, k, v),
                                      sharding.replicated(dy, y))

    y, grads = run(q, k, v)
    before = fa_kernel.flash_attention.launches
    with sharding.constrainer(rules.constrain_fn()):
        yd, grads_d = run(*(_on_mesh(nccl_mesh, t) for t in (q, k, v)))
    assert fa_kernel.flash_attention.launches == before + 1
    assert torch.equal(yd.full_tensor(), y)
    for g, gd in zip(grads, grads_d):
        assert torch.equal(sharding.full(gd), g)


def test_paged_site_in_local_map_equals_the_plain_call(nccl_mesh):
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, h, hkv, d, page, pages = 4, 12, 2, 128, 16, 64
    q = torch.randn(b, h, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn(1 + b * pages, page, hkv, d, generator=gen,
                          device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    table = (1 + torch.arange(b * pages, device="cuda",
                              dtype=torch.int32)).reshape(b, pages)
    lengths = torch.tensor([1, 333, 700, 1024], device="cuda",
                           dtype=torch.int32)
    want = paged_lm._paged_read(q, kp, vp, table, lengths)
    before = pa_kernel.paged_attention.launches
    got = paged_lm._paged_read(
        _on_mesh(nccl_mesh, q, [Replicate(), Shard(1)]),
        *(_on_mesh(nccl_mesh, t) for t in (kp, vp, table, lengths)))
    assert pa_kernel.paged_attention.launches == before + 1
    assert torch.equal(got.full_tensor(), want)


def _bits_equal(a, b) -> bool:
    a, b = sharding.full(a), sharding.full(b)
    return a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                              b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_moe_sites_in_local_map_equal_the_plain_call(nccl_mesh, dtype):
    """``apply_moe`` (dbrx smoke's routing, 4 groups of 64 tokens) on
    DTensors placed by the rules at (1, 1): one dispatch and one combine
    launch in their regions; y, the aux loss and every gradient equal the
    plain call's bit for bit."""
    cfg = dataclasses.replace(registry.smoke("dbrx-132b"), dtype=dtype)
    rules = MeshRules(nccl_mesh)
    block = moe.MoE(cfg, device="cuda")
    with torch.no_grad():
        block.reset_parameters(torch.Generator(device="cuda").manual_seed(5))
    specs = rules.param_specs(block)
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, dy = (torch.randn(4, 64, cfg.d_model, generator=gen, device="cuda",
                         dtype=getattr(torch, dtype)) for _ in range(2))

    def run(weights, x, dy):
        weights = {n: w.detach().clone().requires_grad_(True)
                   for n, w in weights.items()}
        x = x.detach().clone().requires_grad_(True)
        y, aux = moe.apply_moe(types.SimpleNamespace(**weights, shared=None),
                               x, cfg)
        grads = torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                    [x, *weights.values()])
        return y, aux, grads

    plain = dict(block.named_parameters())
    y, aux, grads = run(plain, x, dy)
    before = (moe_kernel.dispatch.launches, moe_kernel.combine.launches)
    placed = {n: _on_mesh(nccl_mesh, w, rules.placements(specs[n], w.shape))
              for n, w in plain.items()}
    with sharding.constrainer(rules.constrain_fn()):
        yd, auxd, grads_d = run(placed, _on_mesh(nccl_mesh, x),
                                _on_mesh(nccl_mesh, dy))
    assert (moe_kernel.dispatch.launches, moe_kernel.combine.launches) == \
        (before[0] + 1, before[1] + 1)
    assert isinstance(yd, DTensor)
    assert _bits_equal(yd, y) and _bits_equal(auxd, aux)
    for g, gd in zip(grads, grads_d):
        assert _bits_equal(gd, g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_site_in_local_map_equals_the_plain_call(nccl_mesh, dtype):
    """``ssd_chunked`` on DTensors at (1, 1) under the rules' constraints:
    one ``ssd_scan`` launch in its region (the mma route in bfloat16, the
    simt route in float32); y and the gradients of all six operands (the
    plain chunked backward) equal the plain call's bit for bit."""
    rules = MeshRules(nccl_mesh)
    b, s, h, p, n = 2, 512, 8, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, dt=dtype, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=dt) * scale

    ops = [randn(b, s, h, p), randn(b, s, h, dt=torch.float32).abs() * 0.1,
           randn(h, dt=torch.float32), randn(b, s, n, scale=0.3),
           randn(b, s, n, scale=0.3), randn(h, dt=torch.float32)]
    dy = randn(b, s, h, p, dt=torch.float32)

    def run(*ops):
        ops = [t.detach().clone().requires_grad_(True) for t in ops]
        y = ssm.ssd_chunked(*ops, chunk=256)
        return y, torch.autograd.grad(y, ops, sharding.replicated(dy, y))

    y, grads = run(*ops)
    before = dict(ssd_kernel.ssd_scan.route_launches)
    with sharding.constrainer(rules.constrain_fn()):
        yd, grads_d = run(*(_on_mesh(nccl_mesh, t) for t in ops))
    route = ssd_kernel.route(dtype, p, n)
    after = dict(ssd_kernel.ssd_scan.route_launches)
    assert after[route] == before[route] + 1 and sum(after.values()) == \
        sum(before.values()) + 1
    assert isinstance(yd, DTensor) and _bits_equal(yd, y)
    for g, gd in zip(grads, grads_d):
        assert _bits_equal(gd, g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,hkv", [(4, 2), (16, 8), (48, 8)])
def test_paged_shard_reads_equal_the_unsharded_heads(nccl_mesh, dtype, h,
                                                     hkv):
    """The paged read's per-shard body for each of 4 "model" ranks' query
    heads: at 4 / 2 two ranks share a KV head, at 16 / 8 each holds two,
    at 48 / 8 (dbrx-132b) each holds 12 heads, two KV heads' groups.
    Each gives the unsharded kernel's heads bit for bit, one launch a
    rank."""
    b, d, page, pps = 9, 128, 16, 24
    q, kp, vp, table = _pages(b, h, hkv, d, page, pps, dtype, "cuda")
    lengths = torch.tensor([0, 1, 15, 16, 17, 100, 200, 383, 384],
                           dtype=torch.int32, device="cuda")
    want = pa_kernel.paged_attention(q, kp, vp, table, lengths)
    before = pa_kernel.paged_attention.launches
    for r in range(4):
        lo, hi = r * h // 4, (r + 1) * h // 4
        got = paged_lm.shard_read(h, hkv, lo, hi)(
            q[:, lo:hi].contiguous(), kp, vp, table, lengths)
        assert _bits_equal(got, want[:, lo:hi].contiguous()), (r, lo, hi)
    assert pa_kernel.paged_attention.launches == before + 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_past_the_first_kv_head_matches_its_plain_versions(
        nccl_mesh, dtype):
    """KV heads 3 and 4 of a pool of 8 for 6 query heads: within bf16 3e-2
    / f32 1e-4 of the plain version and elementwise within float32
    summation order of the split plain version at the whole pool's split
    count; a run past the pool is refused before any launch."""
    b, hkv, d, page, pps = 9, 8, 128, 16, 24
    q, kp, vp, table = _pages(b, 6, hkv, d, page, pps, dtype, "cuda")
    ln = torch.tensor([0, 1, 63, 64, 65, 128, 200, 383, 384],
                      dtype=torch.int32, device="cuda")
    kw = dict(kv_head0=3, kv_heads=2)
    out = pa_kernel.paged_attention(q, kp, vp, table, ln, **kw)
    want = pa_ref.paged_attention_ref(q, kp, vp, table, ln, **kw).float()
    assert (out.float() - want).abs().max().item() <= PAGED_TOL[dtype]
    split = pa_ref.paged_attention_split(
        q, kp, vp, table, ln, pa_kernel.n_splits(b, hkv, pps, page),
        **kw).float()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    assert bool(((out.float() - split).abs()
                 <= ulp * split.abs() + 1e-5).all())
    assert out[0].abs().max().item() == 0.0
    before = pa_kernel.paged_attention.launches
    with pytest.raises(ValueError, match="KV heads"):
        pa_kernel.paged_attention(q, kp, vp, table, ln, kv_head0=7,
                                  kv_heads=2)
    assert pa_kernel.paged_attention.launches == before
