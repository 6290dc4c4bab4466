"""The production-mesh dry run (``launch/{mesh,hlo,dryrun}.py``) and the
four model-step kernels as custom ops with shape-only fakes.

* **Fakes.**  Each op's fake gives the plain version's output shape,
  dtype and strides on the shapes of the kernel tests, on meta tensors
  and under ``FakeTensorMode``, and calls neither the plain version nor
  the kernel; each op on the CPU still equals the reference's Pallas
  kernel in interpret mode (flash, dispatch, combine bit for bit or
  within the kernel tests' tolerances: f32 1e-5, bf16 3e-2 for flash,
  5e-2 for the scan).
* **The hlo twin** on hand-built traces, and the recorder on small ops:
  per-rank FLOPs below DTensor, views moving no bytes, DTensor's
  sharding propagation unrecorded, live bytes.
* **Placements.**  For all ten archs at full size, on (16, 16) at ranks
  0 and 255 and on (2, 16, 16) at ranks 0 and 511, every state leaf's and
  input's local shard shape equals the reference's
  ``NamedSharding(AbstractMesh, spec).shard_shape`` (specs from the
  reference's ``MeshRules``; placements only, no trace).
* **Collectives and per-rank FLOPs against a real run.**  dbrx, mamba2
  and whisper smoke training steps traced on meta over a fake 4-rank
  world at (2, 2) give exactly rank 0's FLOPs, collective counts and
  bytes by kind, and kernel calls of the same step run on 4 gloo ranks.
* **FLOPs against the analytic count.**  qwen2-1.5b at full width (cut
  to 2 layers) on (16, 16): per-rank FLOPs x 256 within 1% of the
  analytic count from the config: ``benchmarks/roofline.py``'s
  6 N_active D (train) or 2 N D (prefill, where only the last position
  reaches the head) plus the attention products and the recompute.

The fake worlds run in one subprocess (tests/torch_dryrun_checks.py) and
the gloo ranks in another (tests/torch_host_mesh_checks.py ``--group
dryrun``), started together and shared by the tests of this file.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from benchmarks import roofline
from repro.configs import registry as jax_registry
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.moe_dispatch import ops as jax_moe_ops
from repro.kernels.ssd_scan import ops as jax_ssd_ops
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models.types import SHAPES as JAX_SHAPES
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
from repro_torch.kernels.moe_dispatch import ops as moe_ops
from repro_torch.kernels.moe_dispatch import ref as moe_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel
from repro_torch.launch import hlo
from repro_torch.models import api
from repro_torch.models.types import SHAPES
from test_torch_sharding import _jax_params, _norm, _ref_param_spec, _rules

HERE = pathlib.Path(__file__).parent
FAKE_CHECKS = HERE / "torch_dryrun_checks.py"
GLOO_CHECKS = HERE / "torch_host_mesh_checks.py"
RUN_TIMEOUT_S = 600
FLOPS_BAND = 0.01
MODEL_AXIS = 16


# ---------------------------------------------------------------------------
# the two subprocesses, started together once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Both subprocesses, started before this file's first test so that
    they run beside its in-process tests."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    fake_out, gloo_out = tmp / "fake.json", tmp / "gloo.json"
    procs = {
        "fake": (subprocess.Popen(
            [sys.executable, str(FAKE_CHECKS), str(fake_out)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
            fake_out),
        "gloo": (subprocess.Popen(
            [sys.executable, str(GLOO_CHECKS), "--group", "dryrun", "--out",
             str(gloo_out)], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True), gloo_out)}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(started):
    procs = started
    out = {}
    for name, (proc, path) in procs.items():
        try:
            _, err = proc.communicate(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p, _ in procs.values():
                p.kill()
            pytest.fail(f"{name}: no result in {RUN_TIMEOUT_S} s")
        if proc.returncode != 0 or not path.exists():
            pytest.fail(f"{name}: rc {proc.returncode}\n{err[-3000:]}")
        out[name] = json.loads(path.read_text())
    return out


# ---------------------------------------------------------------------------
# fakes against the plain versions
# ---------------------------------------------------------------------------

def _randn(*shape, dtype=torch.float32, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)
                       ).to(dtype)


def _flash_case(b, h, sq, sk, d, causal, window, q_offset, dtype):
    return ((_randn(b, h, sq, d, dtype=dtype), _randn(b, h, sk, d,
                                                      dtype=dtype, seed=1),
             _randn(b, h, sk, d, dtype=dtype, seed=2)),
            (causal, window, q_offset))


def _slots(t, k, n_slots, seed=0):
    rng = np.random.default_rng(seed)
    flat = np.full(t * k, -1, np.int32)
    kept = rng.choice(t * k, size=min(n_slots, t * k * 3 // 4),
                      replace=False)
    flat[kept] = rng.permutation(n_slots)[:kept.size]
    return torch.from_numpy(flat.reshape(t, k))


def _ssd_case(b, s, h, p, n, dtype, out_dtype):
    return ((_randn(b, s, h, p, dtype=dtype), _randn(b, s, h).abs() * 0.1,
             _randn(h, seed=3) * 0.1, _randn(b, s, n, dtype=dtype, seed=4),
             _randn(b, s, n, dtype=dtype, seed=5), _randn(h, seed=6)),
            (64, out_dtype))


FLASH = [(2, 4, 256, 256, 128, True, None, 0),
         (2, 4, 256, 256, 128, True, 96, 0),
         (2, 4, 256, 256, 128, False, None, 0),
         (1, 2, 32, 128, 64, True, 40, 64),
         (1, 3, 48, 48, 80, True, 0, 0)]
MOE = [(64, 1, 48, 128), (24, 2, 40, 64), (32, 4, 64, 128), (8, 8, 64, 16)]
SSD = [(2, 128, 4, 16, 8), (1, 200, 3, 64, 64), (2, 64, 2, 8, 16)]
DTYPES = [torch.float32, torch.bfloat16]


def _cases():
    out = []
    for dtype in DTYPES:
        for c in FLASH:
            out.append(pytest.param("flash_attention",
                                    _flash_case(*c, dtype),
                                    id=f"flash-{c}-{dtype}"))
        for t, k, n_slots, d in MOE:
            x = _randn(t, d, dtype=dtype)
            out.append(pytest.param(
                "moe_dispatch", ((x, _slots(t, k, n_slots)), (n_slots,)),
                id=f"dispatch-{t}x{k}-{dtype}"))
            ye = _randn(n_slots, d, dtype=dtype)
            slot = torch.randint(-1, n_slots, (t, k), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(t))
            out.append(pytest.param(
                "moe_combine", ((ye, slot, _randn(t, k)), ()),
                id=f"combine-{t}x{k}-{dtype}"))
        for c in SSD:
            for out_dtype in (None, torch.float32):
                out.append(pytest.param(
                    "ssd_scan", _ssd_case(*c, dtype, out_dtype or dtype),
                    id=f"ssd-{c}-{dtype}-{out_dtype}"))
    return out


def _op(name):
    return getattr(torch.ops.repro_torch, name)


def _refuse(*_, **__):
    raise AssertionError("a fake called the plain version or the kernel")


def _no_compute(monkeypatch):
    for mod, names in ((fa_ref, ["attention_ref"]),
                       (moe_ref, ["dispatch_ref", "combine_ref"]),
                       (ssd_ref, ["ssd_chunked_ref"]),
                       (fa_kernel, ["flash_attention"]),
                       (moe_kernel, ["dispatch", "combine"]),
                       (ssd_kernel, ["ssd_scan"])):
        for n in names:
            monkeypatch.setattr(mod, n, _refuse)


KERNELS = (fa_kernel.flash_attention, moe_kernel.dispatch,
           moe_kernel.combine, ssd_kernel.ssd_scan)


def _launches():
    return [k.launches for k in KERNELS]


def _layout(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in outs]


@pytest.mark.parametrize("name,case", _cases())
def test_fake_gives_the_plain_versions_layout(name, case, monkeypatch):
    tensors, rest = case
    plain = _op(name)(*tensors, *rest)
    before = _launches()
    _no_compute(monkeypatch)
    meta = _op(name)(*(t.to("meta") for t in tensors), *rest)
    with FakeTensorMode() as mode:
        fake = _op(name)(*(mode.from_tensor(t) for t in tensors), *rest)
    assert _layout(meta) == _layout(fake) == _layout(plain)
    assert all(t.is_meta for t in (meta if isinstance(meta, tuple)
                                   else (meta,)))
    assert _launches() == before


def test_ops_are_registered_custom_ops_with_flop_formulas():
    from torch.utils import flop_counter
    for name in ("flash_attention", "moe_dispatch", "moe_combine",
                 "ssd_scan"):
        schema = _op(name).default._schema
        assert schema.name == f"repro_torch::{name}"
        assert not any(a.alias_info and a.alias_info.is_write
                       for a in schema.arguments), name  # writes no input
    assert _op("flash_attention") in flop_counter.flop_registry
    assert _op("ssd_scan") in flop_counter.flop_registry
    assert _op("moe_dispatch") not in flop_counter.flop_registry


@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (64, 64, True, None, 0), (64, 64, True, 24, 0), (64, 64, False, None, 0),
    (64, 64, False, 8, 0), (32, 128, True, None, 96), (32, 128, True, 40, 64),
    (48, 48, True, 0, 0)])
def test_flash_flop_formula_counts_the_kept_pairs(sq, sk, causal, window,
                                                  q_offset):
    pos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep &= pos >= kpos
    if window is not None:
        keep &= pos - kpos < window
    assert fa_ops.kept_pairs(sq, sk, causal, window, q_offset) == \
        int(keep.sum())
    rec = hlo.Recorder()
    b, h, d = 2, 3, 16
    with rec:
        fa_ops.attention(torch.zeros(b, h, sq, d, device="meta"),
                         torch.zeros(b, h, sk, d, device="meta"),
                         torch.zeros(b, h, sk, d, device="meta"),
                         causal=causal, window=window, q_offset=q_offset)
    (op,) = [o for o in rec.trace if o.kind == "kernel"]
    assert op.flops == 4 * b * h * d * int(keep.sum())


def test_ssd_flop_formula_is_the_kernels_products():
    rec = hlo.Recorder()
    b, s, h, p, n = 2, 256, 3, 64, 128
    with rec:
        ssd_ops.ssd(torch.zeros(b, s, h, p, device="meta"),
                    torch.zeros(b, s, h, device="meta"),
                    torch.zeros(h, device="meta"),
                    torch.zeros(b, s, n, device="meta"),
                    torch.zeros(b, s, n, device="meta"),
                    torch.zeros(h, device="meta"))
    (op,) = [o for o in rec.trace if o.kind == "kernel"]
    q = ssd_ref.SUB_CHUNK
    assert op.flops == b * h * (s // q) * (2 * q * q * n + 2 * q * q * p
                                           + 4 * q * n * p)


def _np32(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_on_the_cpu_equal_the_pallas_kernels(dtype):
    """Each custom op called directly on CPU tensors against the
    reference's Pallas kernel in interpret mode."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(2)

    def both(*shape):
        a = jnp.asarray(rng.normal(size=shape), jdt)
        return a, torch.from_numpy(np.array(a, np.float32)).to(tdt)

    (jq, q), (jk, k), (jv, v) = (both(2, 4, 256, 128) for _ in range(3))
    want = jax_fa_ops.attention(jq, jk, jv, causal=True, window=96,
                                impl="pallas", interpret=True)
    y, _ = _op("flash_attention")(q, k, v, True, 96, 0)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np32(y), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)

    jx, x = both(64, 128)
    slot = np.full(64, -1, np.int32)
    slot[rng.choice(64, size=48, replace=False)] = rng.permutation(48)
    want = jax_moe_ops.dispatch(jx, jnp.asarray(slot), n_slots=48)
    got = _op("moe_dispatch")(x, torch.from_numpy(slot), 48)
    assert np.array_equal(_np32(got), np.asarray(want, np.float32))

    jye, ye = both(64, 128)
    slot2 = rng.integers(0, 64, (32, 4)).astype(np.int32)
    slot2[rng.random((32, 4)) < 0.2] = -1
    w = rng.random((32, 4)).astype(np.float32)
    want = jax_moe_ops.combine(jye, jnp.asarray(slot2), jnp.asarray(w))
    got = _op("moe_combine")(ye, torch.from_numpy(slot2),
                             torch.from_numpy(w))
    np.testing.assert_allclose(_np32(got), np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 2**-8,
                               atol=1e-5)

    xh = jnp.asarray(rng.normal(size=(2, 128, 4, 16)), jdt)
    dt = jnp.asarray(rng.uniform(0.01, 0.4, (2, 128, 4)), jnp.float32)
    a_log = jnp.asarray(rng.uniform(-1, 0.3, (4,)), jnp.float32)
    bm, cm = (jnp.asarray(rng.normal(size=(2, 128, 8)), jdt)
              for _ in range(2))
    dsk = jnp.asarray(rng.normal(size=(4,)), jnp.float32)
    want = jax_ssd_ops.ssd(xh, dt, a_log, bm, cm, dsk, chunk=64,
                           impl="pallas", interpret=True)
    t = [torch.from_numpy(np.array(a, np.float32)) for a in
         (xh, dt, a_log, bm, cm, dsk)]
    for i in (0, 3, 4):
        t[i] = t[i].to(tdt)
    got = _op("ssd_scan")(*t, 64, tdt)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np32(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the hlo twin
# ---------------------------------------------------------------------------

def _trace():
    Op = hlo.Op
    return [Op("aten.mm", "product", 1000, 40, 20),
            Op("_c10d_functional.all_gather_into_tensor", "collective", 0,
               8, 64, "all-gather"),
            Op("_c10d_functional.all_gather_into_tensor", "collective", 0,
               8, 32, "all-gather"),
            Op("_c10d_functional.reduce_scatter_tensor", "collective", 0,
               64, 16, "reduce-scatter"),
            Op("_c10d_functional.all_reduce", "collective", 0, 4, 4,
               "all-reduce"),
            Op("repro_torch.flash_attention", "kernel", 500, 30, 10),
            Op("aten.copy_", "copy", 0, 6, 3),
            Op("aten.add", "other", 0, 8, 4),
            Op("aten.view", "view")]


def test_collective_bytes_and_counts_by_kind():
    trace = _trace()
    assert hlo.collective_bytes(trace) == {
        "all-gather": 96, "reduce-scatter": 16, "all-reduce": 4}
    assert hlo.collective_counts(trace) == {
        "all-gather": 2, "reduce-scatter": 1, "all-reduce": 1}


def test_op_census_counts_calls_by_name():
    census = hlo.op_census(_trace())
    assert census["_c10d_functional.all_gather_into_tensor"] == 2
    assert census["aten.view"] == 1 and sum(census.values()) == 9


def test_analyze_bounds():
    r = hlo.analyze(_trace())
    assert r["flops"] == 1500
    # products, kernels, collectives and copies: operands and results
    assert r["bytes_min"] == 60 + 72 + 40 + 80 + 8 + 40 + 9
    assert r["bytes_max"] == r["bytes_min"] + 12       # + the add
    assert hlo.analyze([]) == {"flops": 0.0, "bytes_min": 0.0,
                               "bytes_max": 0.0, "collectives": {},
                               "collective_counts": {}}


def test_recorder_classifies_and_tracks_live_bytes():
    a = torch.zeros(64, 32, device="meta")
    b = torch.zeros(32, 16, device="meta")
    rec = hlo.Recorder()
    held = rec.hold({"a": a, "b": [b]})
    assert held == (64 * 32 + 32 * 16) * 4 and rec.peak == held
    with rec:
        c = a @ b                    # 64 x 16 result
        d = c.t()                    # a view: no bytes
        e = (d * 2).sum()
        del c, d
    kinds = {o.name: o for o in rec.trace}
    assert kinds["aten.mm"].kind == "product"
    assert kinds["aten.mm"].flops == 2 * 64 * 32 * 16
    assert kinds["aten.mm"].operand_bytes == held
    assert kinds["aten.t"].kind == "view" and kinds["aten.t"].result_bytes == 0
    # peak: the arguments, the product, the doubled copy and the sum
    assert rec.peak == held + 2 * 64 * 16 * 4 + 4
    assert rec.bytes_of(e) == 4 and rec.bytes_of({"a": a}) == 0
    del e
    assert rec.live == held


def test_recorder_counts_below_dtensor_and_skips_sharding_propagation(
        tmp_path):
    """On a one-rank gloo mesh: a DTensor product is recorded once, as the
    local op (DTensor's own run of it on fake tensors is not)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(1, 1)
        a, b = (distribute_tensor(torch.ones(8, 4), mesh, [Replicate()] * 2)
                for _ in range(2))
        rec = hlo.Recorder()
        with rec:
            a @ b.t()
        products = [o for o in rec.trace if o.kind == "product"]
        assert len(products) == 1 and products[0].flops == 2 * 8 * 4 * 8
    finally:
        dist.destroy_process_group()


def test_meta_inputs_stay_meta():
    batch = {"tokens": torch.empty(2, 8, dtype=torch.int32, device="meta"),
             "labels": np.zeros((2, 8), np.int32)}
    out = api.batch_to(batch, "cpu")
    assert out["tokens"].is_meta and out["tokens"] is batch["tokens"]
    assert out["labels"].device.type == "cpu"


def test_importing_the_mesh_module_touches_no_group():
    code = ("import torch.distributed as dist; "
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun; "
            "print(dist.is_initialized())")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------------------
# placements, traces and FLOPs (the subprocesses)
# ---------------------------------------------------------------------------

def test_production_meshes(runs):
    assert runs["fake"]["meshes"] == {
        "16x16": [[16, 16], ["data", "model"]],
        "pod2x16x16": [[2, 16, 16], ["pod", "data", "model"]]}


def _ref_shapes(arch: str, mesh: str) -> dict:
    """{leaf: shard shape} from the reference's specs on an AbstractMesh,
    over the port's leaves and global shapes."""
    _, ref = _rules(mesh)
    shape, names = ((16, 16), ("data", "model")) if mesh == "16x16" else \
        ((2, 16, 16), ("pod", "data", "model"))
    amesh = AbstractMesh(shape, names)
    cfg, jcfg = registry.get(arch), jax_registry.get(arch)

    def shard(global_shape, spec):
        return list(NamedSharding(amesh, JP(*spec)).shard_shape(
            tuple(global_shape)))

    ref_specs = ref.state_specs(jax_steps.abstract_state(
        jcfg, jax_steps.make_optimizer(jcfg)))
    out = {}
    for name, p in api.abstract_params(cfg).named_parameters():
        for part in ("params", "m", "v"):
            out[f"{part}/{name}"] = shard(p.shape, _ref_param_spec(
                ref_specs[part], name, cfg))
    out["step"] = []
    for cell, shp in SHAPES.items():
        batch = api.input_specs(cfg, shp)
        specs = ref.batch_specs(jax_api.input_specs(jcfg, JAX_SHAPES[cell]))
        for k, t in batch.items():
            out[f"{cell}/{k}"] = shard(t.shape, _norm(specs[k]))
    return out


@pytest.mark.parametrize("mesh", ["16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", registry.list_archs())
def test_local_shards_equal_the_references_shard_shapes(runs, arch, mesh):
    want = _ref_shapes(arch, mesh)
    by_rank = runs["fake"]["placements"][mesh]
    assert len(by_rank) == 2
    for rank, leaves in by_rank.items():
        got = leaves[arch]
        assert set(got) == set(want), (rank, set(got) ^ set(want))
        bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        assert not bad, (rank, list(bad.items())[:5])


@pytest.mark.parametrize("name", ["dbrx", "mamba2", "whisper"])
def test_traced_step_equals_a_real_ranks_count(runs, name):
    real = runs["gloo"]["dryrun_traces"]
    assert real.get("ok"), real.get("error")
    got, want = runs["fake"]["traces"][name], real[name]
    assert got["flops"] == want["flops"] > 0
    assert got["collective_counts"] == want["collective_counts"]
    assert got["collectives"] == want["collectives"]
    assert got["kernel_calls"] == want["kernel_calls"]
    assert sum(got["collective_counts"].values()) > 0


def test_shard_to_shard_moves_run_as_on_cuda_ranks(runs):
    """A shard-to-shard move on the fake world's cpu mesh is one all-to-all
    under ``dryrun.cuda_redistributions`` (as on NCCL ranks) and an
    all-gather without it (DTensor's gloo fallback)."""
    r = runs["fake"]["all_to_all"]
    assert r["cuda"] == {"routed": True, "local": [8, 4],
                         "calls": {"all-to-all": 1}}
    assert r["cpu"]["local"] == [8, 4]
    assert r["cpu"]["calls"] == {"all-gather": 1}


def test_attention_layouts_equal_the_plain_call(runs):
    """Padded heads and the batch over "model" (4 gloo ranks at (1, 4), 6
    heads): output within 1e-5 of the largest plain value, gradients
    within 1e-5 in relative norm."""
    r = runs["gloo"]["attention_layouts"]
    assert r.get("ok"), r.get("error")
    assert r["padded_heads"]["pad"] == 2
    assert r["batch_over_model"]["pad"] == 0
    for name in ("padded_heads", "batch_over_model"):
        assert r[name]["err"] <= 1e-5 * r[name]["scale"], (name, r[name])
        assert r[name]["grad_rel"] <= 1e-5, (name, r[name])


def _analytic_qwen2(cell: str, n_layers: int) -> float:
    """Global FLOPs of a qwen2-1.5b step from its config, cut to
    ``n_layers``: roofline.model_flops' 6 N_active D (train) or 2 N D
    (prefill, less the head that only the last position reaches); the
    attention products (the kernel's kept pairs forward; the blocked
    backward's five products on every chunk pair it does not skip); the
    recompute of each layer's forward in the backward (but the MLP's
    last product, whose output no backward reads, so the checkpoint
    stops before it) and of the loss's head; and attention on heads
    padded to 16 where ``model`` divides neither the 12 heads nor the
    batch (the prefill's 32 rows over 16 x 16)."""
    cfg = dataclasses.replace(jax_registry.get("qwen2-1.5b"),
                              n_layers=n_layers)
    shape = SHAPES[cell]
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    n = roofline.active_params(cfg)
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    h, dh = cfg.n_heads, cfg.head_dim
    layer = (d * h * dh + 2 * d * cfg.n_kv_heads * dh + h * dh * d
             + 3 * d * f)
    fwd = 4 * b * h * dh * fa_ops.kept_pairs(s, s, True, None, 0)
    # heads padded to a multiple of "model" where the batch cannot split
    repeat = 1 if h % MODEL_AXIS == 0 or b % 256 == 0 else \
        -(-h // MODEL_AXIS) * MODEL_AXIS / h
    if shape.kind == "prefill":
        return (2 * n * tokens - 2 * tokens * v * d + 2 * b * v * d
                + n_layers * fwd * repeat)
    qc, kc = 512, 1024
    pairs = sum(1 for qi in range(s // qc) for kj in range(s // kc)
                if kj * kc <= qi * qc + qc - 1)
    bwd = pairs * 5 * 2 * b * h * qc * kc * dh
    recompute = n_layers * 2 * tokens * (layer - d * f) + 2 * tokens * v * d
    return (6 * n * tokens + recompute
            + n_layers * (2 * fwd + bwd) * repeat)


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k"])
def test_qwen2_flops_in_the_analytic_band(runs, cell):
    from torch_dryrun_checks import FLOPS_LAYERS
    r = runs["fake"]["flops"][cell]
    assert r["chips"] == 256
    assert r["kernel_calls"]["repro_torch.flash_attention"] == \
        FLOPS_LAYERS * (2 if cell == "train_4k" else 1)
    want = _analytic_qwen2(cell, FLOPS_LAYERS)
    got = r["flops"] * r["chips"]
    assert abs(got / want - 1) <= FLOPS_BAND, (got, want, got / want)
