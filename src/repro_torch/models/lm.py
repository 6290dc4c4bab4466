"""The causal LM, dense attention decoders: parameters, the training /
prefill forward and the chunked cross-entropy loss.

The reference stacks each layer-pattern position's parameters
``[n_groups, ...]`` and scans over groups; here the stack is an
``nn.ModuleList`` of one :class:`Block` per layer, where layer
``group * period + pattern_index`` holds the reference's slice
``groups[pattern_index][group]`` (see :mod:`repro_torch.checkpoint.convert`).
The serving forward passes live in :mod:`.paged_lm`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_block(block: Block, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, attn_impl: str) -> torch.Tensor:
    h = layers.apply_norm(block.mixer_norm, x, cfg)
    x = x + layers.apply_attention(block.attn, h, positions, cfg,
                                   impl=attn_impl)
    if block.mlp is not None:
        h = layers.apply_norm(block.ffn_norm, x, cfg)
        x = x + layers.apply_mlp(block.mlp, h)
    return x


def _remat(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward instead
    of kept (the reference's ``jax.checkpoint``) when autograd records."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward(params: LM, batch: dict, cfg: ModelConfig,
            attn_impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states [B,S,D], MoE aux loss: 0 for the dense
    family).  Each layer runs under activation checkpointing, so only its
    input is kept for the backward, which runs the layer's forward again
    (the reference's per-layer remat)."""
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = batch["embeds"].to(params.embed.dtype)
    else:
        x = F.embedding(batch["tokens"], params.embed)
    positions = torch.arange(x.shape[1], device=x.device)
    for block in params.blocks:
        x = _remat(_apply_block, block, x, positions, cfg, attn_impl)
    x = layers.apply_norm(params.final_norm, x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _ce_chunk(xc: torch.Tensor, w_head: torch.Tensor,
              lc: torch.Tensor) -> torch.Tensor:
    logits = (xc @ w_head).float()
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 256
                          ) -> torch.Tensor:
    """Mean token CE over sequence chunks: each chunk's [B, c, V] logits
    live only while its term is computed, in the forward and again in the
    backward, and are never kept."""
    b, s, _ = x.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + _remat(_ce_chunk, x[:, i:i + c], w_head,
                               labels[:, i:i + c])
    return total / (b * s)


def lm_loss(params: LM, batch: dict, cfg: ModelConfig,
            attn_impl: str = "auto", aux_weight: float = 0.01
            ) -> torch.Tensor:
    x, aux = forward(params, batch, cfg, attn_impl)
    ce = chunked_cross_entropy(x, _lm_head(params, cfg), batch["labels"])
    return ce + aux_weight * aux


def prefill_logits(params: LM, batch: dict, cfg: ModelConfig,
                   attn_impl: str = "auto") -> torch.Tensor:
    """Prefill: full-sequence forward, logits of the last position only."""
    x, _ = forward(params, batch, cfg, attn_impl)
    return (x[:, -1, :] @ _lm_head(params, cfg)).float()
