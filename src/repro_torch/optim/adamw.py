"""AdamW with global-norm clipping, a configurable moment dtype and an
optional gradient transform (see :mod:`.compression`).

The twin of the JAX package's ``optim/adamw.py``.  The state is
``{"params": module, "m": {name: tensor}, "v": {name: tensor}, "step":
int32 scalar tensor}``, keyed by the module's parameter names.  Updates
happen in place under ``torch.no_grad()`` (the reference returns new
arrays): each leaf's arithmetic is the reference's, in float32, then cast
back to the leaf's and the moments' dtypes.  Eager PyTorch keeps each
float32 intermediate of that arithmetic whole, where the reference's jit
fuses them: about six copies of the leaf in float32 (~25 GB for a 1.05 B
element embedding, more than internvl2's training had left on one card).
So a leaf larger than :data:`UPDATE_CHUNK` elements is updated a slice of
its elements at a time (a DTensor leaf a slice of its local shard at a
time); each element's arithmetic is unchanged, so the result is the same
bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor

Grads = dict[str, torch.Tensor]
UPDATE_CHUNK = 2**26     # elements a slice of the update takes at most


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, float32."""
    s = step.float()
    warm = torch.clamp(s / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: nn.Module, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside ``params``, whose
    parameters from here on require grad (they are the trained leaves)."""
    dt = getattr(torch, cfg.moment_dtype)
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    device = next(iter(named.values())).device
    return {
        "params": params,
        "m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
              for n, p in named.items()},
        "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
              for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Grads) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree.values()]
    return torch.stack(leaves).sum().sqrt()


@torch.no_grad()
def apply_updates(state: dict, grads: Grads, cfg: AdamWConfig,
                  transform: Callable[[Grads], Grads] | None = None) -> dict:
    """One AdamW step, in place.  ``transform`` (e.g. gradient compression
    + error feedback) is applied to the raw gradients first."""
    if transform is not None:
        grads = transform(grads)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.float()
    bc1 = 1.0 - torch.pow(b1, sf)
    bc2 = 1.0 - torch.pow(b2, sf)
    mdt = getattr(torch, cfg.moment_dtype)
    # global scalars (replicated DTensors on a mesh) as plain tensors: the
    # DTensor leaves below are updated in their local shards
    scale, lr, bc1, bc2 = (x.full_tensor() if isinstance(x, DTensor) else x
                           for x in (scale, lr, bc1, bc2))
    for name, p in state["params"].named_parameters():
        for pp, g, m, v in _slices(p, grads[name], state["m"][name],
                                   state["v"][name]):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g.square()
            delta = (m32 / bc1) / ((v32 / bc2).sqrt() + cfg.eps) \
                + cfg.weight_decay * pp.float()
            pp.copy_((pp.float() - lr * delta).to(pp.dtype))
            m.copy_(m32.to(mdt))
            v.copy_(v32.to(mdt))
    state["step"] = step
    return state


def _slices(p, g, m, v):
    """(p, g, m, v) as flat slices of at most :data:`UPDATE_CHUNK`
    elements (views of p, m and v, which the update writes through).  A
    DTensor leaf is sliced in its local shards: the update is elementwise,
    so each rank's shard of p, m and v takes the same arithmetic as the
    whole DTensor would give it, once g has p's placements (a grad that
    arrives with others, e.g. ``Partial``, is redistributed to them
    first)."""
    chunk = UPDATE_CHUNK
    if isinstance(p, DTensor):
        if g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        for t in (m, v):
            if t.placements != p.placements:
                raise ValueError(f"AdamW moment placements {t.placements} "
                                 f"differ from the leaf's {p.placements}")
        p, g, m, v = (t.to_local() for t in (p, g, m, v))
    flat = [p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)]
    return [tuple(t[i:i + chunk] for t in flat)
            for i in range(0, p.numel(), chunk)]
