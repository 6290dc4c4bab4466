"""Plain PyTorch MoE dispatch and combine: the kernels' reference versions.

The twins of the JAX package's ``kernels/moe_dispatch/ref.py``.  The CPU
path of :mod:`.ops` and the comparison ``chip_smoke.py`` holds the CUDA
kernels to on the card.
"""
from __future__ import annotations

import torch


def _pairs(slot: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(token of each (token, choice) pair, its slot), flattened; slot is
    [T] or [T, K]."""
    fanin = 1 if slot.dim() == 1 else slot.shape[1]
    tokens = torch.arange(slot.shape[0], device=slot.device)
    return tokens.repeat_interleave(fanin), slot.reshape(-1).long()


def dispatch_ref(x: torch.Tensor, slot: torch.Tensor,
                 n_slots: int) -> torch.Tensor:
    """Scatter tokens to expert-capacity slots.

    x: [T, D]; slot: [T] or [T, K], each a flat destination in
    [0, n_slots) or -1 (dropped); kept slots are distinct.  Returns
    [n_slots, D]: row slot[t, k] holds x[t], unfilled rows are zero."""
    out = torch.zeros((n_slots, x.shape[1]), dtype=x.dtype, device=x.device)
    token, dest = _pairs(slot)
    kept = dest >= 0
    out[dest[kept]] = x[token[kept]]
    return out


def combine_ref(ye: torch.Tensor, slot: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Gather expert outputs back to tokens.

    ye: [n_slots, D]; slot: [T, K] (-1 = dropped); weights: [T, K].
    Returns [T, D] = sum_k w[t,k] * ye[slot[t,k]] over the kept choices:
    rows and weights in float32, each product rounded, then added in k
    order (the CUDA kernel's order), the sum cast to ye's type.  A dropped
    choice adds nothing, whatever row 0 holds."""
    w = weights.float()
    acc = torch.zeros((slot.shape[0], ye.shape[1]), dtype=torch.float32,
                      device=ye.device)
    for k in range(slot.shape[1]):
        kept = slot[:, k] >= 0
        rows = ye[slot[:, k].clamp(min=0).long()].float()
        acc = torch.where(kept[:, None], acc + w[:, k, None] * rows, acc)
    return acc.to(ye.dtype)
