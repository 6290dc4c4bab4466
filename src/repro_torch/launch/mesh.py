"""Mesh construction over the default process group.

The twin of ``repro.launch.mesh``: a ``DeviceMesh`` with named dims
``("data", "model")`` (``("pod", "data", "model")`` with a pod axis) over
the first ranks of the default process group, on the group's device type
(``cpu`` under gloo and the fake backend, ``cuda`` under NCCL).  The
caller initialises the group first: ``torch.distributed
.init_process_group`` for a real one, :func:`init_fake_world` for the
dry run's.  Functions, not module-level meshes: importing this module
touches no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PRODUCTION_WORLD = 512       # 2 pods of 16 x 16


def _mesh(shape: tuple, names: tuple) -> DeviceMesh:
    n = dist.get_world_size()
    need = 1
    for d in shape:
        need *= d
    assert n >= need, f"need {need} ranks, have {n}"
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_host_mesh(data: int = 2, model: int = 4, *,
                   pod: int | None = None) -> DeviceMesh:
    """A ``data x model`` (or ``pod x data x model``) mesh over the first
    ranks of the default group; asserts the group holds that many."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks with a leading
    ``pod`` axis (the gradient all-reduce crosses pods), over the first
    ranks of the default group, as the reference's production mesh."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def init_fake_world(world: int = PRODUCTION_WORLD, rank: int = 0) -> None:
    """Make the default group a one-process fake world of ``world`` ranks,
    this process being ``rank``: collectives complete at once and move
    nothing, so a step on meta tensors traces as that rank would run it.
    Once a process: a second call with the same world is a no-op, and
    one with another world, or over a real group, raises.  Built on
    ``torch.testing._internal.distributed.fake_pg.FakeStore`` (an internal
    PyTorch API) and the ``fake`` backend it registers."""
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == world
                and dist.get_rank() == rank):
            return
        raise RuntimeError(f"a {dist.get_backend()} group of "
                           f"{dist.get_world_size()} ranks is initialised; "
                           f"the fake world needs the process to itself")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
