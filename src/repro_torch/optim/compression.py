"""Gradient compression with error feedback (int8 quantized reductions).

The twin of the JAX package's ``optim/compression.py``: each step's
quantization residual is added back before the next quantization
(Karimireddy et al., arXiv:1901.09847).  ``ErrorFeedback.compress`` plugs
into ``adamw.apply_updates(transform=...)`` through a closure that carries
the residual.

One int8 scale per leaf of the reference's parameter tree: the reference
stacks the tensors of every layer at one pattern position into one leaf,
so here ``blocks.<i>.<name>`` shares its scale with every
``blocks.<j>.<name>`` for ``i = j (mod period)``.
"""
from __future__ import annotations

import torch

Grads = dict[str, torch.Tensor]


def int8_scale(xs) -> torch.Tensor:
    """The scale that maps the largest magnitude over ``xs`` to 127."""
    return torch.stack([x.abs().max() for x in xs]).max() / 127.0 + 1e-12


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if scale is None:
        scale = int8_scale([x])
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class ErrorFeedback:
    """Stateful error-feedback compressor (its state is a grads-shaped
    dict of float32 residuals)."""

    def __init__(self, period: int = 1):
        self.period = period

    def _leaf(self, name: str) -> str:
        """The reference tree leaf that holds parameter ``name``."""
        parts = name.split(".")
        if parts[0] != "blocks":
            return name
        return ".".join(["groups", str(int(parts[1]) % self.period),
                         *parts[2:]])

    def init(self, grads: Grads) -> Grads:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    def compress(self, grads: Grads, residual: Grads) -> tuple[Grads, Grads]:
        """Returns (decompressed grads to apply, new residual)."""
        corrected = {k: g.float() + residual[k] for k, g in grads.items()}
        leaves: dict[str, list[str]] = {}
        for k in grads:
            leaves.setdefault(self._leaf(k), []).append(k)
        deq = {}
        for names in leaves.values():
            scale = int8_scale([corrected[k] for k in names])
            for k in names:
                deq[k] = dequantize_int8(*quantize_int8(corrected[k], scale))
        res = {k: g.float() + residual[k] - deq[k] for k, g in grads.items()}
        return {k: deq[k] for k in grads}, res
