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
``gathered`` and ``full`` take a DTensor whole, on the mesh or off it
(``whole_sequence`` only its sequence, before a column-parallel product);
``local`` is a replicated DTensor's own copy on this rank, for writes
that every rank makes alike; ``put_`` writes one index of a (possibly
sharded) DTensor in place, each rank into the shard it holds.
``layout`` tells a kernel site which placements the installed rules pin
for a kind, so that it can open its ``local_map`` region on them.

The constrainer is thread-local, and autograd runs a CUDA backward on
its own device thread: an activation checkpoint's recompute, which runs
there, takes the forward's constrainer through ``recompute_contexts``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

_state = threading.local()


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    fn = getattr(_state, "fn", None)
    return fn(x, kind) if fn is not None else x


def layout(shape, kind: str):
    """The placements ``constrain`` pins on a DTensor of ``shape`` for
    ``kind`` under the installed constrainer; None without one, or where
    the kind does not apply."""
    fn = getattr(_state, "fn", None)
    placements = getattr(fn, "placements", None)
    return None if placements is None else placements(tuple(shape), kind)


@contextlib.contextmanager
def constrainer(fn: Callable[[torch.Tensor, str], torch.Tensor]):
    prev = getattr(_state, "fn", None)
    _state.fn = fn
    try:
        yield
    finally:
        _state.fn = prev


def recompute_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: (a no-op for the
    forward, the constrainer installed now for the recompute)."""
    fn = getattr(_state, "fn", None)
    return (contextlib.nullcontext(),
            constrainer(fn) if fn is not None else contextlib.nullcontext())


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) replicated on ``like``'s mesh when
    ``like`` is a DTensor; ``t`` itself otherwise."""
    if isinstance(t, DTensor) or not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def divisible(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t`` with ``dim`` still sharded where its ``parts`` (the heads a
    view splits it into, or merges it from) divide over the mesh axes
    that shard it, and gathered over those axes elsewhere: DTensor views
    ``[..., n * d] <-> [..., n, d]`` only when every shard holds whole
    parts.  A plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    axes = [i for i, p in enumerate(t.placements) if p == Shard(dim)]
    if parts % math.prod(mesh.size(i) for i in axes) == 0:
        return t
    return t.redistribute(mesh, [Replicate() if i in axes else p
                                 for i, p in enumerate(t.placements)])


def gathered(t: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """A DTensor replicated on its own mesh (only over the axes that shard
    ``dim``, given one); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if dim is None or p == Shard(dim % t.ndim) else p
        for p in t.placements])


def whole_sequence(x: torch.Tensor) -> torch.Tensor:
    """x [B, S, ...] with S gathered where a mesh axis shards it, the
    all-gather that sequence parallelism makes before a column-parallel
    product; anything else as it is.  ``x @ w`` views [B, S, D] as
    [B * S, D], and DTensor (torch 2.11) views a flatten only where no dim
    after its first is sharded.  Its backward is the reduce-scatter of the
    product's partial sums onto the sequence shards."""
    if not isinstance(x, DTensor) or x.ndim < 3 \
            or Shard(1) not in x.placements:
        return x
    return gathered(x, 1)


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


def put_(dst: torch.Tensor, dim: int, index: int, src: torch.Tensor) -> None:
    """``dst.select(dim, index).copy_(src)`` in place.  On a DTensor every
    rank takes ``src`` onto ``dst``'s placements (a dim sharded along
    ``dim`` replicated) and writes the part of its own shard, if its shard
    holds ``index``; DTensor's own ``select`` of a sharded dim would
    gather it into a new tensor and the write would be lost."""
    if not isinstance(dst, DTensor):
        dst.select(dim, index).copy_(src)
        return
    mesh = dst.device_mesh
    src_pl = [Replicate() if not isinstance(p, Shard) or p.dim == dim
              else Shard(p.dim - (p.dim > dim)) for p in dst.placements]
    src = replicated(src, dst)
    src = src.redistribute(mesh, src_pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        tuple(dst.shape), mesh, dst.placements)
    at = index - offset[dim]
    if 0 <= at < shape[dim]:
        dst.to_local().select(dim, at).copy_(src)
