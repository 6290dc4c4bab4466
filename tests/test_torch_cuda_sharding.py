"""The sharding layer's kernel call sites on the card, over a one-rank
NCCL mesh (1, 1).  These need the card and skip without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharding.py

Every ctypes kernel wrapper refuses a CUDA DTensor with ``TypeError``
before it reads ``data_ptr()`` (tests/test_torch_dtensor_sites.py holds
the same with CPU DTensors); blocked attention (the flash kernel's
forward, one launch, and the plain backward) and the paged decode read,
each in its ``local_map`` region at (1, 1), give their plain calls'
values bit for bit, and gradients too.
"""
import datetime

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import sharding
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers, paged_lm
from repro_torch.sharding.rules import MeshRules
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
