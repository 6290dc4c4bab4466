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
