"""The causal LM's parameters, serving subset: dense attention decoders.

The reference stacks each layer-pattern position's parameters
``[n_groups, ...]`` and scans over groups; here the stack is an
``nn.ModuleList`` of one :class:`Block` per layer, where layer
``group * period + pattern_index`` holds the reference's slice
``groups[pattern_index][group]`` (see :mod:`repro_torch.checkpoint.convert`).
The serving forward passes live in :mod:`.paged_lm`.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers
from .types import LayerSpec, ModelConfig


class Block(nn.Module):
    """One decoder layer: mixer norm + attention, FFN norm + MLP."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device=None):
        super().__init__()
        if spec.mixer != "attn" or spec.ffn == "moe":
            raise NotImplementedError(
                f"{cfg.name}: the port has attention mixers with dense MLPs "
                f"only; got {spec}")
        self.mixer_norm = layers.Norm(cfg, device=device)
        self.attn = layers.Attention(cfg, device=device)
        if spec.ffn != "none":
            self.ffn_norm = layers.Norm(cfg, device=device)
            self.mlp = layers.MLP(cfg, device=device)
        else:
            self.ffn_norm = self.mlp = None


class LM(nn.Module):
    """Embedding, the layer stack, the final norm and the (optional) head."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family == "encdec":
            raise NotImplementedError(f"{cfg.name}: encoder-decoder models "
                                      f"are not ported yet")
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        pattern = cfg.pattern()
        self.embed = layers._param((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = layers.Norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers._param((cfg.d_model, cfg.vocab_size), dt,
                                      device))
        self.blocks = nn.ModuleList(
            Block(cfg, pattern[i % cfg.period], device=device)
            for i in range(cfg.n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights N(0, 0.02) in ``cfg.dtype``, norm scales ones, biases
        zeros: the reference's layout and law, not its numbers."""
        layers.dense_init_(self.embed, generator)
        if self.lm_head is not None:
            layers.dense_init_(self.lm_head, generator)
        for m in self.modules():
            if isinstance(m, (layers.Norm, layers.Attention, layers.MLP)):
                m.reset_parameters(generator)


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device=None) -> LM:
    """A randomly initialised LM, drawn on ``device`` (the generator's
    device) so a full-width model never passes through host memory."""
    model = LM(cfg, device=device)
    with torch.no_grad():
        model.reset_parameters(generator)
    return model


def _lm_head(params: LM, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head
