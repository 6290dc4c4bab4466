"""Each rank's shard under the port's placements against the reference's
device indices.  Run by tests/test_torch_sharding.py with 8 host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_sharding_index_map.py OUT.json

For the meshes (2, 4) and (2, 2, 2) (pod x data x model), the specs of
every parameter and optimizer leaf of two smoke archs (dense and MoE),
their batches and every constraint kind: the reference's
``NamedSharding(Mesh(devices.reshape(shape)), spec).devices_indices_map``
gives each device a slice; the port's rank at the same position of its
``DeviceMesh`` (over a fake 8-rank process group: index maths only, no
data moves) must own the same box (``sharding.rules.local_box``).
Writes ``{"checked": n, "mismatches": [...]}``.
"""
import json
import pathlib
import sys
import types

import jax
import numpy as np
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.types import ShapeConfig  # noqa: E402
from repro_torch.sharding.rules import MeshRules, local_box  # noqa: E402

WORLD = 8
MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
KINDS = [("activations", (8, 64, 64)), ("activations", (4, 16, 64)),
         ("logits", (8, 16, 512)), ("decode_logits", (8, 512)),
         ("expert_tokens", (4, 8, 12, 64)), ("attn_heads", (8, 4, 64, 16)),
         ("attn_kv_rep", (8, 2, 64, 16)), ("ssd_xs5", (4, 8, 16, 8, 8)),
         ("ssd_xs4", (4, 8, 16, 8)), ("ssd_state", (8, 8, 8, 16)),
         ("ssd_y", (8, 16, 8, 8))]


def cases(rules: MeshRules) -> list[tuple[tuple, tuple]]:
    """(global shape, spec) pairs to lay out."""
    out = []
    for arch in ("qwen2-1.5b", "dbrx-132b"):
        cfg = registry.smoke(arch)
        state = steps.abstract_state(cfg, steps.make_optimizer(cfg))
        specs = rules.state_specs(state)
        for name, p in state["params"].named_parameters():
            out.append((tuple(p.shape), specs["params"][name]))
        shape = ShapeConfig("t", "train", 64, 8)
        batch = api.input_specs(cfg, shape)
        for k, spec in rules.batch_specs(batch).items():
            out.append((tuple(batch[k].shape), spec))
    for kind, shape in KINDS:
        out.append((shape, rules.constraint_spec(shape, kind)))
    return out


def _stand_in(shape, names):
    return types.SimpleNamespace(shape=shape, mesh_dim_names=names)


def main(out: str) -> None:
    devices = np.array(jax.devices())
    assert devices.size == WORLD, devices
    want = {}                          # (mesh, case) -> per-rank boxes
    all_cases = {}
    for shape, names in MESHES:
        rules = MeshRules(_stand_in(shape, names), multi_pod=len(shape) == 3)
        all_cases[shape] = cases(rules)
        mesh = Mesh(devices.reshape(shape), names)
        for i, (gshape, spec) in enumerate(all_cases[shape]):
            index = NamedSharding(mesh, JP(*spec)).devices_indices_map(gshape)
            pos = {d.id: r for r, d in enumerate(mesh.devices.reshape(-1))}
            want[shape, i] = {
                pos[d.id]: [list(s.indices(n))[:2] for s, n in
                            zip(idx, gshape)] for d, idx in index.items()}
    mismatches, checked = [], 0
    for rank in range(WORLD):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=WORLD)
        try:
            for shape, names in MESHES:
                mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                                  mesh_dim_names=names)
                rules = MeshRules(mesh, multi_pod=len(shape) == 3)
                for i, (gshape, spec) in enumerate(all_cases[shape]):
                    got = [list(b) for b in
                           local_box(gshape, mesh, rules.placements(spec))]
                    checked += 1
                    if got != want[shape, i][rank]:
                        mismatches.append(dict(
                            mesh=shape, shape=gshape, spec=repr(spec),
                            rank=rank, port=got, ref=want[shape, i][rank]))
        finally:
            dist.destroy_process_group()
    pathlib.Path(out).write_text(json.dumps(
        {"checked": checked, "mismatches": mismatches[:20]}))


if __name__ == "__main__":
    main(sys.argv[1])
