"""Pluggable activation-sharding constraints.

The twin of ``repro.sharding.ctx``.  Model code is mesh-agnostic: it calls
``constrain(x, kind)`` at a few key points (block boundaries, logits,
expert buffers, attention heads).  A step built with mesh rules installs a
function mapping ``kind`` to a DTensor ``redistribute`` onto the kind's
placements (:meth:`repro_torch.sharding.rules.MeshRules.constrain_fn`);
outside a constrainer ``constrain`` returns ``x``, so single-device runs
and the CPU tests are unchanged.

``replicated(t, like)`` puts a tensor the model makes itself (positions,
the RoPE table, masks) on ``like``'s mesh, replicated, when ``like`` is a
DTensor: an op that mixes a plain tensor with a DTensor raises.
``gathered`` and ``full`` take a DTensor whole, on the mesh or off it;
``local`` is a replicated DTensor's own copy on this rank, for writes
that every rank makes alike.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate

_state = threading.local()


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    fn = getattr(_state, "fn", None)
    return fn(x, kind) if fn is not None else x


@contextlib.contextmanager
def constrainer(fn: Callable[[torch.Tensor, str], torch.Tensor]):
    prev = getattr(_state, "fn", None)
    _state.fn = fn
    try:
        yield
    finally:
        _state.fn = prev


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) replicated on ``like``'s mesh when
    ``like`` is a DTensor; ``t`` itself otherwise."""
    if isinstance(t, DTensor) or not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on its own mesh; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor; a plain tensor as it
    is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's copy of a replicated DTensor (its storage: an in-place
    write reaches the DTensor); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    if any(not p.is_replicate() for p in t.placements):
        raise ValueError(f"local: {t.placements} is not replicated")
    return t.to_local()
