"""The dry run's checks that need a fake world of their own.  Run by
tests/test_torch_dryrun.py in one subprocess:

    python tests/torch_dryrun_checks.py OUT.json

The process makes a fake default group (``launch.mesh.init_fake_world``)
of 256, 512 and 4 ranks in turn, one at a time, and writes one JSON
object:

* ``meshes``: ``make_production_mesh`` shapes and axis names;
* ``placements``: for all ten archs at full size, on (16, 16) at ranks 0
  and 255 and on (2, 16, 16) at ranks 0 and 511, the local shard shape
  of every state leaf (parameters, AdamW moments, step) and of every
  input of every SHAPES cell, from the port's placements: shapes only,
  no trace;
* ``traces``: dbrx, mamba2 and whisper smoke training steps (the
  ``families`` group's cuts) traced on meta at (2, 2) over 4 fake ranks,
  through ``dryrun.trace_step``: per-rank FLOPs and collectives, for the
  test to hold against rank 0 of a real gloo run of the same step;
* ``all_to_all``: a shard-to-shard move with and without
  ``dryrun.cuda_redistributions``;
* ``flops``: qwen2-1.5b at full width, cut to ``FLOPS_LAYERS`` layers,
  ``train_4k`` and ``prefill_32k`` traced on the production mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun, hlo, steps  # noqa: E402
from repro_torch.launch.mesh import (init_fake_world,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.models import api  # noqa: E402
from repro_torch.models.types import SHAPES  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset  # noqa: E402

import torch_host_mesh_checks as checks  # noqa: E402

PRODUCTION = {"16x16": (256, False, (0, 255)),
              "pod2x16x16": (512, True, (0, 511))}
TRACED = ("dbrx", "mamba2", "whisper")
FLOPS_LAYERS = 2


def _local(shape, mesh, placements) -> list[int]:
    return list(compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)[0])


def local_shapes(rules: MeshRules) -> dict:
    """{arch: {leaf: local shape}} for this rank."""
    out = {}
    for arch in registry.list_archs():
        cfg = registry.get(arch)
        state = steps.abstract_state(cfg, steps.make_optimizer(cfg))
        specs = rules.state_specs(state)
        leaves = {}
        for name, p in state["params"].named_parameters():
            pl = rules.placements(specs["params"][name], p.shape)
            for part in ("params", "m", "v"):
                leaves[f"{part}/{name}"] = _local(p.shape, rules.mesh, pl)
        leaves["step"] = _local(state["step"].shape, rules.mesh,
                                rules.placements(specs["step"]))
        for cell, shape in SHAPES.items():
            batch = api.input_specs(cfg, shape)
            for k, spec in rules.batch_specs(batch).items():
                leaves[f"{cell}/{k}"] = _local(
                    batch[k].shape, rules.mesh,
                    rules.placements(spec, batch[k].shape))
        out[arch] = leaves
    return out


def traced(rules: MeshRules, name: str) -> dict:
    arch, changes = checks.FAMILIES[name]
    cfg = checks.smoke(arch, **changes)
    built = steps.build_train_step(cfg, checks.SHAPE, rules)
    rec = dryrun.trace_step(built, dryrun.place(built))
    return {k: rec[k] for k in ("flops", "collectives", "collective_counts",
                                "kernel_calls")}


def redistributions(mesh) -> dict:
    """A [8, 8] meta DTensor moved from Shard(0) to Shard(1) over "data",
    recorded with and without ``dryrun.cuda_redistributions``: collective
    calls by kind and the local shape."""
    out = {}
    for name in ("cuda", "cpu"):
        x = distribute_tensor(torch.empty(8, 8, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        rec = hlo.Recorder()
        ctx = dryrun.cuda_redistributions() if name == "cuda" else \
            contextlib.nullcontext(False)
        with ctx as routed, rec:
            y = x.redistribute(mesh, [Shard(1), Replicate()])
        out[name] = {"routed": routed, "local": list(y._local_tensor.shape),
                     "calls": hlo.collective_counts(rec.trace)}
    return out


def main(out_path: str) -> None:
    out: dict = {"meshes": {}, "placements": {}, "traces": {}, "flops": {}}
    t0 = time.monotonic()
    for mesh_name, (world, multi_pod, ranks) in PRODUCTION.items():
        for rank in ranks:
            init_fake_world(world, rank)
            try:
                mesh = make_production_mesh(multi_pod=multi_pod)
                out["meshes"][mesh_name] = [list(mesh.shape),
                                            list(mesh.mesh_dim_names)]
                rules = MeshRules(mesh, multi_pod=multi_pod)
                out["placements"].setdefault(mesh_name, {})[str(rank)] = \
                    local_shapes(rules)
            finally:
                dist.destroy_process_group()
    out["placements_seconds"] = time.monotonic() - t0

    init_fake_world(4)
    try:
        rules = MeshRules(make_host_mesh(2, 2), sequence_parallel=False)
        for name in TRACED:
            out["traces"][name] = traced(rules, name)
        out["all_to_all"] = redistributions(rules.mesh)
    finally:
        dist.destroy_process_group()

    init_fake_world(256)
    try:
        cfg = dataclasses.replace(registry.get("qwen2-1.5b"),
                                  n_layers=FLOPS_LAYERS)
        rules = MeshRules(make_production_mesh())
        for cell in ("train_4k", "prefill_32k"):
            built = steps.build_step(cfg, SHAPES[cell], rules)
            rec = dryrun.trace_step(built, dryrun.place(built))
            out["flops"][cell] = {"flops": rec["flops"],
                                  "chips": rules.mesh.size(),
                                  "kernel_calls": rec["kernel_calls"]}
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.monotonic() - t0
    pathlib.Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
