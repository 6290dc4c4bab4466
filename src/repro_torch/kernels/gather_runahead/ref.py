"""Plain PyTorch row gathers: the kernels' reference versions.

The twin of the JAX package's ``kernels/gather_runahead/ref.py``.  The CPU
path of :mod:`.ops` and the comparison ``chip_smoke.py`` holds the CUDA
kernels to on the card.
"""
from __future__ import annotations

import torch


def gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]: the irregular row gather of Listing 1."""
    return table[idx.long()]


def gather_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Padded-CSR aggregation: out[s] = sum_k w[s,k] * table[idx[s,k]].

    idx and weights are [S, K].  Rows and weights are taken to float32, the
    products summed over K in float32 and the sum cast to the table's type,
    as the Pallas kernel computes it (``gather_runahead.py:151-153`` of the
    JAX package).  The JAX package's own oracle sums in the table's type,
    which agrees for float32 tables and rounds more for bfloat16 ones.
    """
    rows = table[idx.long()].float()                       # [S, K, D]
    acc = (rows * weights.float()[..., None]).sum(dim=1)
    return acc.to(table.dtype)


def gather_bag_ordered_ref(table: torch.Tensor, idx: torch.Tensor,
                           weights: torch.Tensor) -> torch.Tensor:
    """The bag in the CUDA kernel's order of operations: for k = 0 .. K - 1
    the float32 product w[s,k] * table[idx[s,k]] is rounded, then added to
    a float32 sum that starts at 0; the sum is cast to the table's type.
    On the same device this is bit for bit what the kernel gives."""
    w = weights.float()
    acc = torch.zeros(idx.shape[0], table.shape[1], dtype=torch.float32,
                      device=table.device)
    for k in range(idx.shape[1]):
        acc = acc + w[:, k, None] * table[idx[:, k].long()].float()
    return acc.to(table.dtype)
