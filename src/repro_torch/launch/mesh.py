"""Mesh construction over the default process group.

The twin of ``make_host_mesh`` in ``repro.launch.mesh``: a ``DeviceMesh``
with named dims ``("data", "model")`` (``("pod", "data", "model")`` with
a pod axis) over the ranks of the default process group, on the group's
device type (``cpu`` under gloo, ``cuda`` under NCCL).  The caller
initialises the group (``torch.distributed.init_process_group``) first.
The production 16 x 16 mesh and its fake 256/512-rank world belong to the
dry run, which is not ported yet.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_host_mesh(data: int = 2, model: int = 4, *,
                   pod: int | None = None) -> DeviceMesh:
    """A ``data x model`` (or ``pod x data x model``) mesh over the first
    ranks of the default group; asserts the group holds that many."""
    n = dist.get_world_size()
    need = data * model * (pod or 1)
    assert n >= need, f"need {need} ranks, have {n}"
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if pod:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    ranks = torch.arange(need).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)
