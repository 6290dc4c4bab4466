"""The kernel call sites under DTensor, on a one-rank gloo mesh (1, 1).

* Every ctypes kernel wrapper refuses a DTensor with ``TypeError`` before
  it reads ``data_ptr()``, which on a DTensor is 0 and raises nothing.
  Here the operands lie on the CPU, so the refusal must come before the
  wrapper's device check (tests/test_torch_cuda_sharding.py repeats this
  with CUDA DTensors on the card).
* The two sites on the sharding path, blocked attention (the flash
  kernel's forward and the plain backward) and the paged decode read,
  run on the ranks' local shards in a ``local_map`` region; at (1, 1) they
  must give their plain calls' values bit for bit, and gradients too.
* ``constrain`` under a constrainer redistributes a DTensor onto the
  kind's placements and passes a plain tensor through.
"""
import datetime

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import sharding
from repro_torch.core.cgra import cache_grid
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.gather_runahead import gather_runahead as gr_kernel
from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
from repro_torch.kernels.paged_attention import paged_attention as pa_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers, paged_lm
from repro_torch.sharding.rules import MeshRules, P


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _randn(*shape, seed=0, dtype=torch.float32):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed),
                       dtype=dtype)


def _dt(mesh, t, placements=None):
    return distribute_tensor(t, mesh, placements or [Replicate()] * 2,
                             src_data_rank=None)


def _grid():
    return cache_grid.ConfigGrid.build(256, [1, 2], [64])


WRAPPERS = {
    "flash_attention": lambda d: fa_kernel.flash_attention(
        d(_randn(1, 2, 64, 64)), d(_randn(1, 2, 64, 64)),
        d(_randn(1, 2, 64, 64))),
    "paged_attention": lambda d: pa_kernel.paged_attention(
        d(_randn(2, 4, 64)), d(_randn(5, 16, 2, 64)), d(_randn(5, 16, 2, 64)),
        d(torch.ones(2, 2, dtype=torch.int32)),
        d(torch.full((2,), 3, dtype=torch.int32))),
    "runahead_gather": lambda d: gr_kernel.runahead_gather(
        d(_randn(32, 16)), d(torch.arange(16, dtype=torch.int32))),
    "pipelined_gather": lambda d: gr_kernel.pipelined_gather(
        d(_randn(32, 16)), d(torch.arange(16, dtype=torch.int32))),
    "gather_bag": lambda d: gr_kernel.gather_bag(
        d(_randn(32, 16)), d(torch.zeros(4, 3, dtype=torch.int32)),
        d(_randn(4, 3))),
    "moe_dispatch": lambda d: moe_kernel.dispatch(
        d(_randn(8, 16)), d(torch.arange(8, dtype=torch.int32)), 8),
    "moe_combine": lambda d: moe_kernel.combine(
        d(_randn(8, 16)), d(torch.arange(8, dtype=torch.int32)[:, None]),
        d(_randn(8, 1))),
    "ssd_scan": lambda d: ssd_kernel.ssd_scan(
        d(_randn(1, 64, 2, 8)), d(_randn(1, 64, 2).abs()), d(_randn(2)),
        d(_randn(1, 64, 16)), d(_randn(1, 64, 16)), d(_randn(2))),
    "cache_grid_scan": lambda d: cache_grid.cache_grid_scan(
        d(torch.arange(100, dtype=torch.int32)), _grid()),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_a_dtensor(mesh, name, monkeypatch):
    def read(self):
        raise AssertionError("the wrapper read a DTensor's data_ptr()")

    monkeypatch.setattr(DTensor, "data_ptr", read)
    with pytest.raises(TypeError, match="DTensor"):
        WRAPPERS[name](lambda t: _dt(mesh, t))


def test_dtensor_data_ptr_is_null(mesh):
    # the hazard the refusal exists for
    assert _dt(mesh, _randn(4, 4)).data_ptr() == 0


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hkv", [4, 2])
def test_blocked_attention_in_local_map_equals_the_plain_call(mesh, window,
                                                              hkv):
    rules = MeshRules(mesh)
    q = _randn(2, 4, 128, 16, seed=1)
    k, v = _randn(2, hkv, 128, 16, seed=2), _randn(2, hkv, 128, 16, seed=3)
    dy = _randn(2, 4, 128, 16, seed=4)

    def run(q, k, v):
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        y = layers.blocked_attention(q, k, v, causal=True, window=window,
                                     q_chunk=64, k_chunk=64)
        grads = torch.autograd.grad(y, (q, k, v), sharding.replicated(dy, y))
        return y, grads

    y, grads = run(q, k, v)
    with sharding.constrainer(rules.constrain_fn()):
        yd, grads_d = run(*(_dt(mesh, t) for t in (q, k, v)))
    assert isinstance(yd, DTensor)
    assert yd.placements == tuple(rules.placements(P("data", "model")))
    assert torch.equal(yd.full_tensor(), y)
    for g, gd in zip(grads, grads_d):
        assert torch.equal(sharding.full(gd), g)


def test_blocked_attention_refuses_a_sequence_shard(mesh):
    q = _dt(mesh, _randn(1, 2, 64, 16), [Replicate(), Shard(2)])
    with pytest.raises(ValueError, match="batch and head"):
        layers.blocked_attention(q, q, q, causal=True, q_chunk=64,
                                 k_chunk=64)


def test_paged_read_in_local_map_equals_the_plain_call(mesh):
    q = _randn(3, 4, 64, seed=5)
    kp, vp = _randn(9, 16, 2, 64, seed=6), _randn(9, 16, 2, 64, seed=7)
    table = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    lengths = torch.tensor([5, 17, 32], dtype=torch.int32)
    want = paged_lm._paged_read(q, kp, vp, table, lengths)
    got = paged_lm._paged_read(
        _dt(mesh, q, [Replicate(), Shard(1)]),
        *(_dt(mesh, t) for t in (kp, vp, table, lengths)))
    assert isinstance(got, DTensor)
    assert torch.equal(got.full_tensor(), want)


def test_constrain_redistributes_dtensors_and_passes_plain_tensors(mesh):
    rules = MeshRules(mesh)
    x = _randn(4, 8, 16)
    with sharding.constrainer(rules.constrain_fn()):
        assert sharding.constrain(x, "activations") is x
        xd = sharding.constrain(_dt(mesh, x), "activations")
        same = _dt(mesh, x)
        assert sharding.constrain(same, "no_such_kind") is same
    assert sharding.constrain(xd, "activations") is xd     # no constrainer
    assert xd.placements == (Shard(0), Shard(1))
    assert torch.equal(xd.full_tensor(), x)


def test_replicated_gathered_and_full(mesh):
    x = _randn(4, 4)
    xd = _dt(mesh, x, [Shard(0), Shard(1)])
    assert sharding.replicated(x, x) is x
    r = sharding.replicated(x, xd)
    assert isinstance(r, DTensor) and r.placements == (Replicate(),) * 2
    assert sharding.replicated(r, xd) is r
    g = sharding.gathered(xd)
    assert g.placements == (Replicate(),) * 2 and torch.equal(g.to_local(), x)
    assert sharding.gathered(x) is x and sharding.full(x) is x
    assert torch.equal(sharding.full(xd), x)


def test_a_recompute_on_another_thread_keeps_the_forwards_constraints():
    """A CUDA backward runs on autograd's device thread, where the
    thread-local constrainer is not installed: the per-layer checkpoint's
    recompute must take the forward's (here the backward runs on a thread
    of its own, as on the card)."""
    import threading

    from repro_torch.models import lm

    seen = []

    def fn(x, kind):
        seen.append((threading.get_ident(), kind))
        return x

    x = _randn(4, 8).requires_grad_(True)
    with sharding.constrainer(fn):
        # the constraint comes before the op whose saved output the
        # backward needs: the recompute stops once it has that output
        y = lm._remat(lambda t: sharding.constrain(t, "layer").exp(), x)
    grads = []
    worker = threading.Thread(target=lambda: grads.extend(
        torch.autograd.grad(y.sum(), [x])))
    worker.start()
    worker.join()
    assert torch.equal(grads[0], x.detach().exp())
    assert [k for _, k in seen] == ["layer", "layer"]
    assert seen[0][0] != seen[1][0]        # the recompute ran on the worker
