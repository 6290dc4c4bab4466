"""The production-mesh dry run: trace every (arch x shape x mesh) cell's
step on meta tensors over a fake 256/512-rank world.

The twin of ``repro.launch.dryrun``, which lowers and compiles each cell
for 512 host devices.  Here the process is rank 0 of a one-process fake
world (:func:`repro_torch.launch.mesh.init_fake_world`), the state and
inputs are meta tensors placed on the production mesh as DTensors, and
the step runs once under :class:`repro_torch.launch.hlo.Recorder` and
``CommDebugMode``: every op runs on rank 0's meta shards, every
collective completes at once and moves nothing (a shard-to-shard move is
an all-to-all, as on CUDA ranks: :func:`cuda_redistributions`), and
every model kernel
(flash attention, MoE dispatch and combine, the SSD scan) is reached
through its custom op's fake, which computes only its output's shape.
Run as:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records (per-rank memory, FLOPs, bytes, collectives by kind and an op
census) go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``,
never to the reference's ``artifacts/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.configs import registry
from repro_torch.launch import hlo
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.steps import BuiltStep, build_step
from repro_torch.models.types import SHAPES, cell_supported
from repro_torch.runtime.elastic import reshard
from repro_torch.sharding.rules import MeshRules

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")
CENSUS_TOP = 40


def place(built: BuiltStep, args=None) -> tuple:
    """``args`` (the step's abstract arguments when None) on the rules'
    mesh by the step's specs, as the step itself would place them."""
    args = built.args_abs if args is None else args
    return reshard(tuple(args), built.rules, built.in_specs)


def trace_step(built: BuiltStep, args: tuple) -> dict:
    """Run ``built.fn(*args)`` once under the counters; ``args`` placed
    (:func:`place`).  Returns the record's per-rank numbers: memory,
    ``flops``, ``bytes_min`` / ``bytes_max``, ``collectives`` (bytes by
    kind), ``collective_counts``, ``collectives_raw`` (``CommDebugMode``'s
    counts by op), the top of the op census and ``trace_seconds``."""
    rec = hlo.Recorder()
    arg_bytes = rec.hold(args)
    comm = CommDebugMode()
    t0 = time.perf_counter()
    with comm, rec:
        out = built.fn(*args)
    seconds = time.perf_counter() - t0
    out_bytes = rec.bytes_of(out)
    analysis = hlo.analyze(rec.trace)
    census = hlo.op_census(rec.trace)
    raw = {str(k): v for k, v in comm.get_comm_counts().items()}
    if sum(raw.values()) != sum(analysis["collective_counts"].values()):
        raise RuntimeError(f"the recorder's collectives "
                           f"{analysis['collective_counts']} disagree with "
                           f"CommDebugMode's {raw}")
    del out
    return dict(
        trace_seconds=round(seconds, 3),
        memory_analysis={"argument_bytes": arg_bytes,
                         "output_bytes": out_bytes,
                         "temp_bytes": rec.peak - arg_bytes},
        peak_device_bytes=rec.peak,
        flops=analysis["flops"],
        bytes_min=analysis["bytes_min"],
        bytes_max=analysis["bytes_max"],
        collectives=analysis["collectives"],
        collective_counts=analysis["collective_counts"],
        collectives_raw=raw,
        kernel_calls={k: v for k, v in census.items()
                      if k.startswith("repro_torch.")},
        op_census=dict(sorted(census.items(),
                              key=lambda kv: -kv[1])[:CENSUS_TOP]),
    )


@contextlib.contextmanager
def cuda_redistributions():
    """Run DTensor's shard-to-shard redistributions as a mesh of CUDA
    ranks runs them.  On a ``cpu`` mesh (gloo's, and the fake world's)
    DTensor runs one as an all-gather and a chunk, since gloo has no
    all-to-all; the fake world stands for NCCL ranks, where it is one
    all-to-all (``_dtensor::shard_dim_alltoall``, whose fake gives the
    shard's shape).  Yields False, and changes nothing, on a torch whose
    DTensor does not route the move through that function."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    if not (hasattr(placement_types, "shard_dim_alltoall")
            and hasattr(funcol, "_resolve_group")
            and hasattr(funcol, "_group_or_group_name")
            and hasattr(torch.ops._dtensor, "shard_dim_alltoall")):
        yield False
        return

    def all_to_all(x, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._group_or_group_name(
            funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(x, gather_dim,
                                                      shard_dim, group)

    before = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield True
    finally:
        placement_types.shard_dim_alltoall = before


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules_overrides: dict | None = None, tag: str = "",
             cfg_overrides: dict | None = None) -> dict:
    """Trace one cell on the production mesh (initialising the fake
    world if this process has none); a cell that ``cell_supported``
    refuses is recorded as skipped."""
    cfg = registry.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    ok, reason = cell_supported(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "kind": shape.kind, "tag": tag}
    if not ok:
        record.update(status="skipped", reason=reason)
        return record
    init_fake_world()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = MeshRules(mesh, multi_pod=multi_pod, **(rules_overrides or {}))
    built = build_step(cfg, shape, rules)
    with cuda_redistributions() as all_to_all:
        record.update(status="ok", chips=mesh.size(),
                      rules={"sequence_parallel": rules.sequence_parallel,
                             "fsdp": rules.fsdp},
                      all_to_all=all_to_all,
                      **trace_step(built, place(built)))
    return record


def save(record: dict) -> pathlib.Path:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"__{record['tag']}" if record.get("tag") else ""
    path = ART_DIR / (f"{record['arch']}__{record['shape']}__"
                      f"{record['mesh']}{tag}.json")
    path.write_text(json.dumps(record, indent=2, default=str))
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=registry.list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--tag", default="", help="record suffix (variants)")
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="the rules' default, kept for the reference's CLI")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "blocked", "triangular"])
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode cells)")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--accum", type=int, default=None)
    args = ap.parse_args()

    archs = registry.list_archs() if args.all or not args.arch \
        else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    overrides = {"sequence_parallel": True} if args.sequence_parallel \
        else {}
    cfg_overrides = {}
    if args.attn_impl:
        cfg_overrides["attn_impl"] = args.attn_impl
    if args.kv_quant:
        cfg_overrides["kv_quant"] = True
    if args.capacity_factor is not None:
        cfg_overrides["capacity_factor"] = args.capacity_factor
    if args.accum is not None:
        cfg_overrides["accum_steps"] = args.accum

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, mp, overrides, args.tag,
                                   cfg_overrides)
                except Exception as e:  # noqa: BLE001 - report and go on
                    failures += 1
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "pod2x16x16" if mp else "pod16x16",
                           "status": "error", "tag": args.tag,
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                path = save(rec)
                if rec["status"] == "ok":
                    gb = rec["peak_device_bytes"] / 2**30
                    print(f"OK   {label}: {gb:.2f} GiB/dev, "
                          f"{rec['flops'] / 1e12:.1f} TF, "
                          f"{rec['trace_seconds']}s -> {path.name}",
                          flush=True)
                elif rec["status"] == "skipped":
                    print(f"SKIP {label}: {rec['reason']}", flush=True)
                else:
                    print(f"FAIL {label}: {rec['error']}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
